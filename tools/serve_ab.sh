#!/bin/bash
# Serve one full published model (a serve phase of chip_smoke.py) from two
# checkouts in turns on one card, A B B A, ROUNDS times, and print one line
# per run:
#   AB <A|B> {tokens/s, TTFT, summed prefill and decode seconds}
#            {profiled piece: [host seconds, device-busy seconds,
#                              the served kernel's device seconds]}
#            {kernel call: device ms}
#
#   tools/serve_ab.sh A_DIR B_DIR [ROUNDS] [dense|rwkv]   # on a card
#
# dense (the default) serves stablelm-1.6b, rwkv serves rwkv6-3b.  Before
# serving, each run times, with its own kernels, the RWKV6 call at
# (1, 40, 2048, 64) and (1, 40, 128, 64) and the simt flash kernel at the
# float32 prefill (1, 2048, 32, 64) causal (CUDA events behind a spin,
# median of 25).  Each directory is a checkout with chip_smoke.py at its
# root (for example unpacked from `git archive`).  Each run is its own
# process and builds that checkout's kernels before it serves.  Host-clock
# serving numbers vary between machines, so compare A and B only within
# one invocation.
set -euo pipefail
a=$1
b=$2
rounds=${3:-2}
model=${4:-dense}

run() {
  (cd "$1" && python3 - "$2" "$model" <<'PY'
import json
import sys

import torch

import chip_smoke as c
from repro_torch.kernels.flash_attention import flash_attention as fk
from repro_torch.kernels.linrec import linrec as lk

dev = torch.device("cuda")
torch.set_float32_matmul_precision("highest")
c.phase_build()


def device_ms(fn):
    fn()
    torch.cuda.synchronize()
    return c.median_ms(fn, 25)


ms = {}
for t in (2048, 128):
    r, k, v, logw, u, s0 = c.linrec_inputs(dev, 1, 40, t, 64, 10,
                                           layout="bthd")
    ms[f"rwkv6_T{t}"] = device_ms(
        lambda: lk.rwkv6_cuda(r, k, v, logw, u, s0, time_dim=1))
b, h, s, d = c.FLASH_PREFILL
q, k, v = c.flash_inputs(dev, torch.float32, b, h, h, s, s, d, 20,
                         layout="bshd")
lens = torch.full((b,), s, dtype=torch.int32, device=dev)
ms["simt_f32_prefill"] = device_ms(lambda: fk.flash_attention_cuda(
    q, k, v, lens, causal=True, scale=d ** -0.5, seq_dim=1))
del r, k, v, logw, u, s0, q
phase, arch, counted = {
    "dense": ("serve_dense", "stablelm-1.6b", "flash_attention"),
    "rwkv": ("serve_rwkv", "rwkv6-3b", "rwkv6")}[sys.argv[2]]
_, out = c.phase_serve(phase, arch, dev, counted)
keys = ("prefill_tokens_per_s", "decode_tokens_per_s", "ttft_p50_s",
        "ttft_max_s", "prefill_s", "decode_s")
prof = out["profile"]
print("AB", sys.argv[1], json.dumps({k: out[k] for k in keys}),
      json.dumps({k: [prof[k]["unprofiled_s"], prof[k]["device_busy_s"],
                      prof[k]["kernel_device_s"]] for k in prof}),
      json.dumps(ms), flush=True)
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
