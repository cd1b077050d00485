"""Variants of decode_split's int8 instance and of the Mamba scan's backward,
timed in turns on one card.

A spec (JSON, ``tools/kernel_ab/*.json``) lists variants, each a copy of a
kernel source with text substitutions:

    {"kernel": "decode" | "mamba", "name": "...",
     "base": "path in the checkout" | "git:REV:path",
     "subs": [[old, new, count], ...], "channels_per_block": 32}

``prepare`` (where the git history is) writes each variant's source under
``build/kernel_ab/`` and a manifest; ``run`` (on the card) builds them all
at once, swaps each into its wrapper in turn and, at the shapes the main
paths use, checks it and times it:

- decode: internlm2-20b's decode over the int8 cache (``chip_smoke``'s
  ``int8_main_inputs``) and the int8 cases of phase ``flash``, each held
  bit for bit with the bf16/f32 instance on the dequantized cache
  (``int8_decode_check``); device ms a call by CUDA events (the variants
  in order, then in reverse), device us a call by kernel (the profiler);
- mamba: the backward at jamba's train shape (``JAMBA_TRAIN``), every
  gradient's largest error over its largest magnitude against
  ``mamba_scan_bwd_ref`` and a rerun bit for bit; ms as above.

    python3 tools/kernel_ab.py prepare tools/kernel_ab/decode.json \\
        tools/kernel_ab/mamba.json
    python3 tools/kernel_ab.py run    # on a card; the result is the last
                                      # line, and build/kernel_ab/result.json

A variant that removes work (a probe) gives wrong outputs by design: its
errors are reported, not held.
"""

from __future__ import annotations

import json
import subprocess
import sys
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "kernel_ab"
MANIFEST = OUT / "manifest.json"


def _text(base: str) -> str:
    if base.startswith("git:"):
        _, rev, path = base.split(":", 2)
        return subprocess.run(["git", "show", f"{rev}:{path}"], cwd=ROOT,
                              check=True, capture_output=True,
                              text=True).stdout
    return (ROOT / base).read_text()


def prepare(specs: list[str]) -> None:
    OUT.mkdir(parents=True, exist_ok=True)
    variants = []
    for spec in specs:
        for v in json.loads(Path(spec).read_text()):
            text = _text(v["base"])
            for old, new, count in v.get("subs", []):
                if text.count(old) != count:
                    raise SystemExit(f"{v['name']}: {old!r} found "
                                     f"{text.count(old)} times, not {count}")
                text = text.replace(old, new)
            path = OUT / f"{v['kernel']}_{v['name']}.cu"
            path.write_text(text)
            variants.append(dict(v, source=str(path.relative_to(ROOT))))
    MANIFEST.write_text(json.dumps(variants, indent=1))
    print(f"{len(variants)} variants in {MANIFEST.relative_to(ROOT)}")


def _turns(names, call, reps):
    """Device ms a call of each variant: in order, then in reverse."""
    import chip_smoke as ck
    times = {n: [] for n in names}
    for name in [*names, *reversed(names)]:
        fn = call(name)
        fn()
        times[name].append(ck.median_ms(fn, reps))
    return times


def _by_kernel(fn, calls):
    import chip_smoke as ck
    _, kernels = ck.profiled(lambda: [fn() for _ in range(calls)])
    return [[round(us / calls, 2), key[:70]] for us, _, key in kernels[:4]]


def _registers(source, kbuild, needle):
    """ptxas's register and spill lines of the entry points whose mangled
    name holds ``needle``, from the build log beside the library."""
    log = Path(str(kbuild.library_path(source)) + ".log").read_text()
    lines = log.splitlines()
    return [" ".join(x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 4]
                     if "Used" in x or "spill" in x)
            for i, ln in enumerate(lines)
            if "Compiling entry" in ln and needle in ln]


def run() -> int:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    import chip_smoke as ck
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels.flash_attention import flash_attention as fk
    from repro_torch.kernels.mamba_scan import mamba_scan as mk
    from repro_torch.kernels.mamba_scan.ref import mamba_scan_bwd_ref

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    variants = json.loads(MANIFEST.read_text())
    kbuild.build(*(ROOT / v["source"] for v in variants))
    dev = torch.device("cuda")
    result = {"device": ck.smi(), "decode": {}, "mamba": {}}
    dec = {v["name"]: v for v in variants if v["kernel"] == "decode"}
    mam = {v["name"]: v for v in variants if v["kernel"] == "mamba"}
    main_dec, main_mam = fk.SOURCES["decode_split"], mk.SOURCE

    def use_decode(name):
        fk.SOURCES["decode_split"] = ROOT / dec[name]["source"]

    def use_mamba(name):
        mk.SOURCE = ROOT / mam[name]["source"]
        mk.CHANNELS_PER_BLOCK = mam[name].get("channels_per_block", 128)

    if dec:
        d = ck.FLASH_INT8_DECODE[3]
        q, _, _, kq, ks, vq, vs, kv_len = ck.int8_main_inputs(dev)
        lens = torch.tensor(ck.FLASH_INT8_LENS, dtype=torch.int32,
                            device=dev)

        def decode_call(name):
            use_decode(name)
            return lambda: fk.flash_attention_cuda(
                q, kq, vq, kv_len, causal=True, scale=d ** -0.5,
                seq_dim=1, k_scale=ks, v_scale=vs)
        for name in dec:
            use_decode(name)
            try:
                ck.int8_decode_check(name, q, kq, ks, vq, vs, kv_len,
                                     ck.FLASH_BF16)
                for i, (group, dd) in enumerate(ck.FLASH_INT8_CASES):
                    for dtype, tol in ((torch.bfloat16, ck.FLASH_BF16),
                                       (torch.float32, ck.FLASH_F32)):
                        qq, kk, vv = ck.flash_inputs(
                            dev, dtype, len(ck.FLASH_INT8_LENS), 2 * group,
                            2, 1, ck.FLASH_INT8_CACHE, dd, 90 + i,
                            layout="bshd")
                        ck.int8_decode_check(f"{name} g{group} d{dd}", qq,
                                             *ck.int8_cache(kk, vv), lens,
                                             tol)
                bits = "equal"
            except AssertionError as e:
                bits = str(e)
            result["decode"][name] = {"bits": bits, "ptxas": _registers(
                ROOT / dec[name]["source"], kbuild,
                "int8_kernelI13__nv_bfloat16Li128ELi8ELi6E")}
        for name, ms in _turns(list(dec), decode_call, 50).items():
            result["decode"][name]["ms"] = ms
            result["decode"][name]["us_by_kernel"] = _by_kernel(
                decode_call(name), 20)
        fk.SOURCES["decode_split"] = main_dec

    if mam:
        args = ck.mamba_inputs(dev, *ck.JAMBA_TRAIN, 62)
        gen = torch.Generator(device=dev).manual_seed(63)
        dy = torch.randn(ck.JAMBA_TRAIN[:3], generator=gen, device=dev)
        _, _, states = mk.mamba_scan_cuda(*args)
        want = mamba_scan_bwd_ref(*args, dy)

        def mamba_call(name):
            use_mamba(name)
            return lambda: mk.mamba_scan_bwd_cuda(*args[:5], dy, states)
        for name in mam:
            got, again = (mamba_call(name)() for _ in range(2))
            torch.cuda.synchronize()
            result["mamba"][name] = {
                "err_over_largest": {
                    label: float((g - w).abs().max() / w.abs().max())
                    for label, g, w in zip(("ddelta", "dx", "da", "dbm",
                                            "dcm", "dh0"), got, want)},
                "rerun_bit_for_bit": all(torch.equal(u, w)
                                         for u, w in zip(got, again)),
                "ptxas": _registers(ROOT / mam[name]["source"], kbuild,
                                    "bwd_gradsILi16")}
            del got, again
        for name, ms in _turns(list(mam), mamba_call, 15).items():
            result["mamba"][name]["ms"] = ms
            result["mamba"][name]["us_by_kernel"] = _by_kernel(
                mamba_call(name), 5)
        mk.SOURCE, mk.CHANNELS_PER_BLOCK = main_mam, 128
    result["device_after"] = ck.smi()
    (OUT / "result.json").write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)
    return 0


def main(argv: list[str]) -> int:
    if argv[:1] == ["prepare"] and len(argv) > 1:
        prepare(argv[1:])
        return 0
    if argv == ["run"]:
        try:
            return run()
        except Exception:  # noqa: BLE001
            traceback.print_exc()
            return 1
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
