#!/bin/bash
# The rolling grid plan (chip_smoke.py's main planner path) from two
# checkouts in turns on one card, A B B A, ROUNDS times, and one line per
# run:
#   AB <A|B> {sweep_ms, plan_wall_s, sweep_device_s, device_busy_s,
#             profiled_wall_s, ladder_book_host_s, sweep_launches}
#
#   tools/plan_ab.sh A_DIR B_DIR [ROUNDS]   # on a card
#
# Each run builds that checkout's sweep kernel and times it at the main
# shape 8192 x 128 x 1344 (CUDA events behind a spin, median of 25), makes
# the 1024-pool, 3-year synthetic fleet, plans it once to initialize CUDA,
# then takes the grid plan's wall time from a second plan (phase `plan`)
# and its device time by kernel from a third under torch.profiler (phase
# `profile`; sweep_device_s sums the kernels whose name holds
# "sweep_kernel").  Each directory is a checkout with chip_smoke.py at its
# root (for example unpacked from `git archive`); each run is its own
# process.  Host-clock times vary between machines, so compare A and B
# only within one invocation.
set -euo pipefail
a=$1
b=$2
rounds=${3:-2}

run() {
  (cd "$1" && python3 - "$2" <<'PY'
import json
import sys

import torch

import chip_smoke as c
from repro_torch.data import traces
from repro_torch.kernels.commitment_sweep import commitment_sweep as ck

dev = torch.device("cuda")
torch.set_float32_matmul_precision("highest")
ck.load()
f, w, cs = c.main_shape_inputs(dev)
ck.commitment_sweep_cuda(f, w, cs)
torch.cuda.synchronize()
sweep_ms = c.median_ms(lambda: ck.commitment_sweep_cuda(f, w, cs), 25)
del f, w, cs
pools = traces.synthetic_pool_set(num_pools=c.NUM_POOLS,
                                  num_hours=c.NUM_HOURS, seed=0)
lines = {}
c.emit = lambda phase, **fields: lines.__setitem__(phase, fields)
c.phase_plan(pools)                      # warm-up: CUDA libraries
rep, launches, plan_s = c.phase_plan(pools)
c.phase_profile(pools, rep, plan_s)
prof = lines["profile"]
print("AB", sys.argv[1], json.dumps(dict(
    sweep_ms=sweep_ms, plan_wall_s=plan_s,
    sweep_device_s=prof["sweep_device_s"],
    device_busy_s=prof["device_busy_s"],
    profiled_wall_s=prof["profiled_wall_s"],
    ladder_book_host_s=prof["ladder_book_host_s"],
    sweep_launches=launches)), flush=True)
PY
  ) | grep '^AB'
}

nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
for _ in $(seq "$rounds"); do
  run "$a" A
  run "$b" B
  run "$b" B
  run "$a" A
done
