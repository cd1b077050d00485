"""A quick check of the flash kernels at MLA's head dims and of the MoE/MLA
models on one card, in well under a minute: the first call to make after
editing a flash source, before a whole ``chip_smoke.py`` run.

    python3 tools/mla_quick_check.py

1. Builds the three flash sources and holds each routed kernel against the
   plain version (``ref.attention_ref``) at (Dqk, Dv) = (192, 128) and
   (96, 64), the square pairs and a decode, in bf16 (elementwise 1e-2 plus
   1e-2 of the largest output) and float32 (2e-5 plus 1e-4), printing the
   kernel each case launched.
2. Times, by CUDA events behind a spin, ``prefill_tc`` at (1, 2048, 16,
   192/128) and (1, 2048, 40, 96/64) causal in bf16, beside
   ``scaled_dot_product_attention`` on the same tensors and ``simt`` on
   their float32 copies.
3. Serves the reduced float32 granite-moe-1b-a400m, deepseek-v2-lite-16b
   and minicpm3-4b (the MLA two at minicpm3's head dims) on the CPU and on
   the card: prefill, decode and train logits, largest difference.
4. Builds the full deepseek-v2-lite-16b in bf16 from a seeded generator:
   init seconds, two 2048-token prefills and three 8-slot decode ticks at
   fill 2048 (host clock around ``torch.cuda.synchronize``), peak memory.

Ends with the card's name and power limit; exits 1 if a kernel case is
off, or without a card.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as fk  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.models.model import build  # noqa: E402

# dtype, B, Hq, Hkv, Sq, Skv, Dqk, Dv, kv_len
CASES = [
    (torch.bfloat16, 1, 16, 16, 2048, 2048, 192, 128, None),
    (torch.bfloat16, 1, 40, 40, 2048, 2048, 96, 64, None),
    (torch.bfloat16, 2, 4, 2, 300, 520, 192, 128, [400, 520]),
    (torch.bfloat16, 2, 4, 4, 77, 77, 96, 64, None),
    (torch.bfloat16, 2, 4, 4, 1, 77, 96, 64, None),
    (torch.bfloat16, 1, 4, 4, 1, 1, 192, 128, None),
    (torch.bfloat16, 1, 8, 8, 700, 700, 64, 64, None),
    (torch.bfloat16, 1, 8, 2, 300, 300, 128, 128, None),
    (torch.float32, 1, 4, 4, 200, 200, 192, 128, None),
    (torch.float32, 2, 4, 2, 130, 300, 96, 64, [300, 250]),
    (torch.float32, 1, 4, 4, 1, 70, 96, 64, None),
    (torch.float32, 1, 8, 2, 200, 200, 128, 128, None),
    (torch.float32, 1, 8, 2, 127, 127, 32, 32, None),
    (torch.bfloat16, 1, 8, 2, 127, 127, 32, 32, None),
    (torch.float32, 3, 8, 2, 1, 1000, 64, 64, [1, 513, 1000]),
]
TOL = {torch.bfloat16: (1e-2, 1e-2), torch.float32: (2e-5, 1e-4)}
# minicpm3's published MLA head dims (chip_smoke's MLA_CARD_DIMS)
MLA_CARD_DIMS = dict(qk_nope_dim=64, qk_rope_dim=32, v_head_dim=64,
                     head_dim=96)


def inputs(dev, dtype, b, hq, hkv, sq, skv, dqk, dv, seed):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=gen).to(dev, dtype) for s in
            ((b, sq, hq, dqk), (b, skv, hkv, dqk), (b, skv, hkv, dv))]


def median_ms(fn, reps=20):
    """ms per call of fn over reps calls, by CUDA events behind a spin."""
    fn()
    torch.cuda.synchronize()
    a, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(3_500_000)
    a.record()
    for _ in range(reps):
        fn()
    e.record()
    e.synchronize()
    return a.elapsed_time(e) / reps


def check_kernels(dev) -> bool:
    ok = True
    for i, (dt, b, hq, hkv, sq, skv, dqk, dv, kvl) in enumerate(CASES):
        q, k, v = inputs(dev, dt, b, hq, hkv, sq, skv, dqk, dv, i)
        lens = (None if kvl is None
                else torch.tensor(kvl, dtype=torch.int32, device=dev))
        before = dict(fk.LAUNCHES_BY_KERNEL)
        got = ops.flash_attention(q, k, v, causal=True, kv_len=lens,
                                  layout="bshd")
        torch.cuda.synchronize()
        used = [n for n in before if fk.LAUNCHES_BY_KERNEL[n] != before[n]]
        want = attention_ref(*(x.transpose(1, 2) for x in (q, k, v)),
                             causal=True, kv_len=lens).transpose(1, 2)
        err = float((got.float() - want.float()).abs().max())
        atol, rel = TOL[dt]
        good = (got.shape == want.shape
                and err <= atol + rel * float(want.float().abs().max()))
        ok &= good
        print(json.dumps(dict(case=i, dtype=str(dt)[6:], shape=[
            b, hq, hkv, sq, skv, dqk, dv], used=used, err=err, good=good)),
            flush=True)
    return ok


def time_mla_shapes(dev) -> None:
    for h, dqk, dv in ((16, 192, 128), (40, 96, 64)):
        q, k, v = inputs(dev, torch.bfloat16, 1, h, h, 2048, 2048, dqk, dv,
                         99)
        lens = torch.full((1,), 2048, dtype=torch.int32, device=dev)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        qf, kf, vf = (x.float() for x in (q, k, v))
        print(json.dumps(dict(
            pair=[dqk, dv], heads=h,
            prefill_tc_ms=median_ms(lambda: fk.flash_attention_cuda(
                q, k, v, lens, causal=True, scale=dqk ** -0.5, seq_dim=1)),
            sdpa_ms=median_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True)),
            simt_f32_ms=median_ms(lambda: fk.flash_attention_cuda(
                qf, kf, vf, lens, causal=True, scale=dqk ** -0.5,
                seq_dim=1)))), flush=True)


def reduced_card_vs_cpu(dev) -> None:
    for arch in ("granite-moe-1b-a400m", "deepseek-v2-lite-16b",
                 "minicpm3-4b"):
        cfg = dataclasses.replace(configs.reduced(arch), dtype="float32")
        if cfg.attention == "mla":
            cfg = dataclasses.replace(cfg, **MLA_CARD_DIMS)
        cpu = build(cfg, device="cpu").init(torch.Generator().manual_seed(0))
        card = build(cfg, device=dev)
        card.load_state_dict(cpu.state_dict())
        tok = torch.randint(0, cfg.vocab_size, (2, 37),
                            generator=torch.Generator().manual_seed(1))
        res = []
        for m in (cpu, card):
            c = m.init_cache(2, 64)
            pre, c = m.apply(tok[:, :36], mode="prefill", cache=c, pos=0)
            dec, _ = m.apply(tok[:, 36:], mode="decode", cache=c,
                             pos=torch.tensor([36, 36]))
            tr, _ = m.apply(tok, mode="train")
            res.append([x.cpu() for x in (pre, dec, tr)])
        print(json.dumps(dict(arch=arch, max_abs_err=dict(zip(
            ("prefill", "decode", "train"),
            (float((a - b).abs().max()) for a, b in zip(*res)))))),
            flush=True)


def full_deepseek(dev) -> None:
    cfg = configs.get("deepseek-v2-lite-16b")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = build(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    out = dict(init_s=time.perf_counter() - t0,
               weights_gb=torch.cuda.memory_allocated() / 1e9)
    cache = m.init_cache(8, 4096)
    tok = torch.randint(0, cfg.vocab_size, (1, 2048), device=dev)
    out["prefill_2048_s"], out["tick_s"] = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        lg, _ = m.apply(tok, mode="prefill", cache=m.slot_view(cache, 0),
                        pos=0)
        torch.cuda.synchronize()
        out["prefill_2048_s"].append(time.perf_counter() - t0)
    pos = torch.full((8,), 2048, device=dev)
    step = torch.zeros((8, 1), dtype=torch.long, device=dev)
    for _ in range(3):
        t0 = time.perf_counter()
        lg, _ = m.apply(step, mode="decode", cache=cache, pos=pos)
        torch.cuda.synchronize()
        out["tick_s"].append(time.perf_counter() - t0)
    out["finite"] = bool(torch.isfinite(lg).all())
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(json.dumps(out), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("mla_quick_check: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.set_float32_matmul_precision("highest")
    t0 = time.perf_counter()
    fk.build()
    print(json.dumps(dict(build_s=time.perf_counter() - t0)), flush=True)
    ok = check_kernels(dev)
    time_mla_shapes(dev)
    reduced_card_vs_cpu(dev)
    full_deepseek(dev)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    print("ALL_OK" if ok else "SOME_FAILED", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
