#!/bin/bash
# Serve the full stablelm-1.6b (the serve_dense phase of chip_smoke.py)
# from two checkouts in turns on one card, A B B A, ROUNDS times, and print
# one line per run:
#   AB <A|B> {tokens/s, TTFT, summed prefill and decode seconds}
#            {profiled piece: [host seconds, device-busy seconds]}
#
#   tools/serve_ab.sh A_DIR B_DIR [ROUNDS]    # on a machine with a card
#
# Each directory is a checkout with chip_smoke.py at its root (for example
# unpacked from `git archive`).  Each run is its own process and builds
# that checkout's kernels before it serves.  Host-clock serving numbers
# vary between machines, so compare A and B only within one invocation.
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

dev = torch.device("cuda")
torch.set_float32_matmul_precision("highest")
c.phase_build()
_, out = c.phase_serve("serve_dense", "stablelm-1.6b", dev, "flash_attention")
keys = ("prefill_tokens_per_s", "decode_tokens_per_s", "ttft_p50_s",
        "ttft_max_s", "prefill_s", "decode_s")
prof = out["profile"]
print("AB", sys.argv[1], json.dumps({k: out[k] for k in keys}),
      json.dumps({k: [prof[k]["unprofiled_s"], prof[k]["device_busy_s"]]
                  for k in prof}), flush=True)
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
