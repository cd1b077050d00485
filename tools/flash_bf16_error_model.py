"""How far the bf16 flash checks of chip_smoke.py sit from good and from
faulty output, on the CPU, by emulating the tensor-core prefill's
rounding (``csrc/flash_prefill_tc.cu``): scores in float32, the online
softmax over tiles of 128 keys (D = 64) or 64 (D = 128), P rounded to
bf16 before the P V product, the row sum from the float32 P, the output
rounded to bf16.

    PYTHONPATH=src python tools/flash_bf16_error_model.py [--seeds N] [--main]

For each bf16 prefill case of chip_smoke's ``flash`` phase it prints the
largest share of ``FLASH_BF16``'s elementwise limit used and the largest
row ratio (a row's error norm over its reference norm, held to
``FLASH_BF16["row"]``) over N seeds; ``--main`` adds the (1, 32, 2048, 64)
prefill at chip_smoke's own seed, and the row ratio of a stale-tile fault
there (the rows past 1900 read tile 7's V in place of tile 10's).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402

CPU = torch.device("cpu")
CASES = {  # chip_smoke's bf16 cases that route to prefill_tc
    "mha_ragged": (2, 4, 4, 77, 77, 64, True, None),
    "gqa_ragged": (2, 8, 2, 200, 200, 64, True, None),
    "mqa_d128": (1, 8, 1, 64, 64, 128, True, None),
    "noncausal": (2, 4, 2, 100, 150, 64, False, None),
    "padded_cache": (2, 8, 2, 3, 384, 64, True, 257),
    "d128_ragged": (1, 4, 4, 300, 300, 128, True, None),
    "vec_kv_len_prefill": (3, 4, 2, 130, 300, 64, True,
                           torch.tensor([130, 200, 300])),
    "ring_wrap_kv_len": (2, 8, 2, 520, 700, 64, True,
                         torch.tensor([611, 700])),
}


def emulate(q, k, v, causal, kv_len, stale=False):
    """q (B, Hq, Sq, D), k/v (B, Hkv, Skv, D) bf16 -> the kernel's output."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    bc = 128 if d == 64 else 64
    kr = k.float().repeat_interleave(hq // hkv, 1)
    vr = v.float().repeat_interleave(hq // hkv, 1)
    lens = torch.as_tensor(skv if kv_len is None else kv_len)
    lens = lens.reshape(-1).expand(b).long()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr) * d ** -0.5
    col = torch.arange(skv)
    mask = col[None, None, :] >= lens[:, None, None]
    if causal:
        row = torch.arange(sq)[None, :] + (lens[:, None] - sq)
        mask = mask | (col[None, None, :] > row[:, :, None])
    s = s.masked_fill(mask[:, None], float("-inf"))
    m = torch.full((b, hq, sq, 1), float("-inf"))
    l, o = torch.zeros(b, hq, sq, 1), torch.zeros(b, hq, sq, d)
    for j in range(0, skv, bc):
        st = s[..., j:j + bc]
        mn = torch.maximum(m, st.amax(-1, keepdim=True))
        ms = torch.where(mn == float("-inf"), 0.0, mn)
        alpha, p = torch.exp(m - ms), torch.exp(st - ms)
        l = l * alpha + p.sum(-1, keepdim=True)
        pv = p.bfloat16().float() @ vr[..., j:j + bc, :]
        if stale and j // bc == 10:
            pv[..., 1900:, :] = (p[..., 1900:, :].bfloat16().float()
                                 @ vr[..., 7 * bc:8 * bc, :])
        o, m = o * alpha + pv, mn
    return (o / l).bfloat16()


def ratios(got, want):
    tol = cs.FLASH_BF16
    got, want = got.float(), want.float()
    elem = ((got - want).abs() / (tol["atol"] + tol["rtol"] * want.abs()))
    row = (got - want).norm(dim=-1) / want.norm(dim=-1)
    return float(elem.max()), float(row.max())


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--main", action="store_true")
    args = ap.parse_args()
    print(f"limits: {cs.FLASH_BF16}")
    for name, (b, hq, hkv, sq, skv, d, causal, kvl) in CASES.items():
        worst = [0.0, 0.0]
        for seed in range(args.seeds):
            q, k, v = cs.flash_inputs(CPU, torch.bfloat16, b, hq, hkv, sq,
                                      skv, d, 100 + seed)
            r = ratios(emulate(q, k, v, causal, kvl),
                       attention_ref(q, k, v, causal=causal, kv_len=kvl))
            worst = [max(w, x) for w, x in zip(worst, r)]
        print(f"{name}: elementwise limit used {worst[0]:.3f}, "
              f"row ratio {worst[1]:.4f}")
    if args.main:
        b, h, s, d = cs.FLASH_PREFILL
        q, k, v = cs.flash_inputs(CPU, torch.bfloat16, b, h, h, s, s, d, 20,
                                  layout="bshd")
        q, k, v = (x.transpose(1, 2) for x in (q, k, v))
        for stale in (False, True):
            worst = [0.0, 0.0]
            for h0 in range(0, h, 4):  # four heads at a time
                qs, ks, vs = (x[:, h0:h0 + 4] for x in (q, k, v))
                r = ratios(emulate(qs, ks, vs, True, None, stale),
                           attention_ref(qs, ks, vs, causal=True))
                worst = [max(w, x) for w, x in zip(worst, r)]
            print(f"main shape{' with a stale tile' if stale else ''}: "
                  f"elementwise limit used {worst[0]:.3f}, "
                  f"row ratio {worst[1]:.4f}")


if __name__ == "__main__":
    main()
