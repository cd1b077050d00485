"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Drives the port's three paths on the card — the rolling commitment
planner, and the serving engine on the published stablelm-1.6b and
rwkv6-3b — and checks each of their kernels (commitment sweep, flash
attention, RWKV6 recurrence) against its plain PyTorch version.  Flash
attention is three CUDA kernels, routed by dtype, head dim and query rows
(``flash_attention.route``): a tensor-core bf16 prefill (``prefill_tc``),
a split-KV decode (``decode_split``) and the SIMT kernel (``simt``: f32
prefill, bf16 with head dim 32).  Phases, in this order, each printing one
JSON line and raising on failure:

  device    card name and power limit, torch and CUDA versions
  build     nvcc build of the five kernel sources, one nvcc each, all at
            once (time, ptxas report)
  kernel    sweep kernel vs plain version on the card: ragged shapes, the
            (T,)/(G,) cases, no weights, prefix masks, the bucketed
            kernel's edges (candidates unsorted, duplicated, all equal,
            descending, equal to some f; zero-weight rows; G = 1; T = 1;
            one row of three years; G = 4096), each also bit for bit
            against the kernel's algebra in plain PyTorch
            (ref.commitment_sweep_bucketed_ref); non-finite rows give NaN;
            the main-path shape 8192 x 128 x 1344, its error against
            float64 no larger than the plain version's; batched launch ==
            one launch per row block, and a rerun == the first run, bit
            for bit
  ties      the solvers' sorts on tied inputs, card vs CPU bit for bit
  fleet     the 1024-pool, 3-year synthetic fleet (seed 0)
  cpu       its first 16 pools replayed on the CPU (plain version) and on
            the card (kernel): totals, targets, tranche book vs carried
            stack, host syncs of the card replay; the first planner call on
            the card, so the timed plans below find CUDA initialized
  plan      api.plan on the whole fleet with the grid solver: costs (the
            bill within rel 1e-4 of PLAN_BILL), wall time, peak memory,
            sweep launches (the main path)
  quantile  the same fleet with the quantile solver (grid within 2%)
  one_shot  api.plan(PlanRequest(pools=fleet)), the default one-shot plan,
            on the whole fleet (a main path): wall time, peak memory, sweep
            launches (exactly 2: the pools' spend and the aggregate's),
            host syncs (the same count as a 16-pool plan's), the bill
            within rel 1e-4 of ONE_SHOT_BILL, zero widths off each pool's
            cloud; on the first 16 pools the card against the CPU; the
            spend's sweep launch against a launch per row block, bit for
            bit; the batched forecaster fit alone by CUDA events beside
            its bound; optimal_commitment_sweep at 8192 x 1344 against its
            plain version; plan_commitment(solver="golden") on one pool,
            card against the CPU
  profile   the grid plan under torch.profiler: device busy time, time by
            kernel (full table in build/chip_smoke/profile_grid_plan.txt), and
            the host-side tranche book timed alone
  flash     flash-attention kernels vs plain version: ragged shapes in
            f32 and bf16 and both layouts (each case checked to launch the
            kernel its route names; among them simt's tile seams: Sq and
            Skv of 65, 127, 200, kv_len below Skv, GQA group 4, D 32, 64
            and 128), prefill (1, 32, 2048, 64) causal in
            bf16 and f32, and a batched decode (8 slots, 32 heads, one
            query) against a 4096-long cache with 8 different kv_len, in
            bf16 and f32, held also against the split-KV algebra's plain
            version; each bf16 query row's error norm against its
            reference norm as well as element by element
  linrec    RWKV6 kernels (chunk, state scan, inter: one call) vs plain
            version: ragged T, strong decay, a carried state, the model's
            whole decay range, a chunk whose decay is exactly 0, B = 2 at
            T = 2048, and (1, 40, 2048, 64), where the states entering the
            chunks (the scan's scratch) are also held against the
            chunk-parallel plain version
  model_cpu both reduced float32 configs served on the CPU (plain
            versions) and on the card (kernels): tokens equal, logits
            close; flash decode on decode_split, f32 prefill on simt
  serve_dense  the full published stablelm-1.6b in bf16, random weights
            from a seeded generator on the card: an engine of 8 slots and
            cache 4096 serves 16 requests (prompts of 128-2048 tokens, 32
            new tokens each); throughput, time to first token, flash
            launches by kernel (exactly 24 x 16 prefill_tc, 24 x ticks
            decode_split, no simt), peak memory (a main path)
  serve_rwkv   the same for the full rwkv6-3b; RWKV6 launches (a main path)
  timing    each kernel's and its plain version's times at its main-path
            shape (flash: prefill_tc at the bf16 prefill, decode_split at
            the bf16 decode, simt at the f32 prefill, and at head dim 128
            beside the library; RWKV6 also at a short prompt's T = 128),
            library times,
            bounds, each flash wrapper's and library call's host time per
            call, then the kernel line {"kernels": [...]}

The last two lines are the card's name and power limit, then
{"ok": true, "device": {...}}.  Without a CUDA device it exits 1 before any
phase.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# Main-path shape of the sweep: 1024 pools x 8 horizon prefixes rows,
# 8 weeks of hours, num_grid candidates.
NUM_POOLS, NUM_HOURS, HORIZON_WEEKS, NUM_GRID = 1024, 24 * 365 * 3, 8, 128
MAIN_P, MAIN_T, MAIN_G = NUM_POOLS * HORIZON_WEEKS, HORIZON_WEEKS * 168, NUM_GRID
EXPECTED_LAUNCHES = 234     # 117 replayed weeks x (rolling + one-shot)
RTOL, ATOL, COST_RTOL = 2e-4, 1e-2, 1e-5
# The grid plan's bill on that fleet as this script has printed it since
# the planner's first port; a sweep change must keep it within BILL_RTOL.
PLAN_BILL = {"total_cost": 4317372416.0, "one_shot_cost": 5832199168.0,
             "hindsight_cost": 5018841088.0}
BILL_RTOL = 1e-4
# The one-shot plan: its sweep launches (the pools' spend, P rows, and the
# aggregate's, one row), and its bill on that fleet as this script first
# printed it: the pools' total, its committed part and the aggregate
# plan's total.
EXPECTED_ONE_SHOT_LAUNCHES = 2
ONE_SHOT_BILL = {"total_cost": 452913383.2636407,
                 "committed_cost": 402241631.9006088,
                 "aggregate_cost": 439929577.2340426}
ONE_SHOT_COSTS = ("total_cost", "committed_cost", "on_demand_cost",
                  "aggregate_cost", "pooling_premium", "savings_vs_on_demand")
CARD_CPU_RTOL = 1e-4     # one-shot costs card vs CPU, of the bill
STACK_TOL = dict(rtol=0.03, atol=0.05)  # widths and levels, card vs CPU
SWEEP_COST_BOUND = 1e-3     # grid+refine: C(c) <= C(c_exact) (1 + bound)
PLAIN_CHUNK = 512           # rows per plain-version chunk at the main shape
# Peak rates for the bound (NVIDIA data sheets, dense, at the full power
# limit): FP32 on the CUDA cores, bf16 on the tensor cores, HBM bandwidth.
PEAKS = {
    "sxm": {"fp32_flops": 67e12, "bf16_flops": 989e12, "bytes": 3.35e12},
    "pcie": {"fp32_flops": 51e12, "bf16_flops": 756e12, "bytes": 2.0e12},
}
# Serving: the engine and its requests (prompt lengths from numpy seed 0)
SERVE_SLOTS, SERVE_CACHE, SERVE_REQUESTS = 8, 4096, 16
PROMPT_MIN, PROMPT_MAX, NEW_TOKENS = 128, 2048, 32
PROFILE_TICKS = 8           # decode ticks under the profiler, every slot busy
# Kernel main shapes: flash prefill (B, H, S, D) and decode (slots, H, D)
# against SERVE_CACHE; linrec (B, H, T, d)
FLASH_PREFILL = (1, 32, 2048, 64)
FLASH_DECODE = (SERVE_SLOTS, 32, 64)
LINREC_MAIN = (1, 40, 2048, 64)
LINREC_SHORT = (1, 40, 128, 64)     # a short prompt's call, timed beside it
FLASH_F32 = dict(atol=2e-5, rtol=1e-4)
# bf16: element by element (P is rounded to bf16 for the tensor cores, so
# in a row over a few keys whose output cancels the error is ~2^-9 of |v|,
# not of |out|), and each query row's error norm at most `row` times the
# row's reference norm, which holds a whole row to ~1/50 of its size
FLASH_BF16 = dict(atol=1e-2, rtol=1e-2, row=2e-2)
# the flash kernels' names as the profiler shows them (all hold "flash_")
FLASH_PROFILE_NAMES = ("flash_prefill_tc_kernel", "flash_decode_split_kernel",
                       "flash_decode_combine_kernel", "flash_simt_kernel")
# the three kernels of one RWKV6 call (all hold "rwkv6_")
RWKV6_PROFILE_NAMES = ("rwkv6_chunk_kernel", "rwkv6_state_scan_kernel",
                       "rwkv6_inter_kernel")
LINREC_TOL = dict(atol=2e-3, rtol=2e-3)
# card vs CPU logits of the reduced float32 models (the tolerances of the
# CPU parity tests against the JAX package)
MODEL_TOL = {"stablelm-1.6b": 1e-4, "rwkv6-3b": 2e-3}
FLOPS_PER_TRIPLE = 6        # sub, 2 max, 2 fma (2 flops each) per hour
OPS_PER_HOUR = 6            # bucketed sweep: 2 subs, 4 muls of the terms
OPS_PER_OUTPUT = 4          # its scan: sub, 2 muls, add per candidate
# Spin before each timed run: ~2 ms at the H100's ~1.7 GHz clock
HOST_COVER_CYCLES = 3_500_000


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def plain_chunked(f, w, cs, chunk=PLAIN_CHUNK):
    """The plain version over row chunks (its (R, G, T) temporary at the
    main shape would be 5.6 GB in one piece)."""
    from repro_torch.kernels.commitment_sweep.ref import (
        commitment_sweep_over_under_ref,
    )
    parts = [
        commitment_sweep_over_under_ref(
            f[i:i + chunk], w[i:i + chunk], cs[i:i + chunk]
        )
        for i in range(0, f.shape[0], chunk)
    ]
    return (torch.cat([p[0] for p in parts]),
            torch.cat([p[1] for p in parts]))


def compare(name, got, want):
    """Raw over/under within rtol/atol, the cost curve 2.1 over + under
    within COST_RTOL elementwise; returns the max abs error."""
    (go, gu), (wo, wu) = got, want
    for label, a, b in (("over", go, wo), ("under", gu, wu)):
        torch.testing.assert_close(
            a, b, rtol=RTOL, atol=ATOL, msg=lambda m: f"{name} {label}: {m}"
        )
    cost_k, cost_r = 2.1 * go + gu, 2.1 * wo + wu
    rel = ((cost_k - cost_r).abs() / cost_r.abs().clamp_min(1e-30)).max()
    rel = float(rel)
    if rel > COST_RTOL:
        raise AssertionError(f"{name}: cost-curve rel err {rel} > {COST_RTOL}")
    return max(float((go - wo).abs().max()), float((gu - wu).abs().max())), rel


def main_shape_inputs(dev, seed=0):
    """Demand-like rows (synthetic forecasts repeated over 8 prefixes),
    per-row grids max(f) x linspace(0, 1, G), 0/1 prefix-mask weights —
    the shapes and weights the grid solver hands the kernel."""
    from repro_torch.numerics import linspace
    gen = torch.Generator().manual_seed(seed)
    base = 40.0 + 200.0 * torch.rand(NUM_POOLS, 1, generator=gen)
    t = torch.arange(MAIN_T, dtype=torch.float32)
    shape = 1.0 + 0.15 * torch.cos(2 * torch.pi * (t - 15) / 24)
    noise = 1.0 + 0.02 * torch.randn(NUM_POOLS, MAIN_T, generator=gen)
    yhat = (base * shape * noise).to(dev)
    f = yhat.repeat_interleave(HORIZON_WEEKS, 0).contiguous()
    wk = torch.arange(1, HORIZON_WEEKS + 1) * 168
    masks = (t[None, :] < wk[:, None]).to(torch.float32)
    w = masks.repeat(NUM_POOLS, 1).to(dev)
    cs = (f.amax(-1, keepdim=True)
          * linspace(0.0, 1.0, MAIN_G, device=dev)[None]).contiguous()
    return f, w, cs


def phase_device():
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on; the forecast needs full f32")
    torch.set_float32_matmul_precision("highest")
    emit("device", nvidia_smi=smi(), torch=torch.__version__,
         cuda=torch.version.cuda, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())


def kernel_modules():
    from repro_torch.kernels.commitment_sweep import commitment_sweep as ck
    from repro_torch.kernels.flash_attention import flash_attention as fk
    from repro_torch.kernels.linrec import linrec as lk
    return {"commitment_sweep": ck, "flash_attention": fk, "rwkv6": lk}


def reset_launches():
    for mod in kernel_modules().values():
        mod.LAUNCHES = 0
    by_kernel = kernel_modules()["flash_attention"].LAUNCHES_BY_KERNEL
    for name in by_kernel:
        by_kernel[name] = 0


def read_launches():
    out = {name: mod.LAUNCHES for name, mod in kernel_modules().items()}
    out["flash_by_kernel"] = dict(
        kernel_modules()["flash_attention"].LAUNCHES_BY_KERNEL)
    return out


def kernel_sources():
    """Every CUDA source of the port by name (flash's three by route)."""
    mods = kernel_modules()
    return {"commitment_sweep": mods["commitment_sweep"].SOURCE,
            **{f"flash_{k}": src for k, src in
               mods["flash_attention"].SOURCES.items()},
            "rwkv6": mods["rwkv6"].SOURCE}


def phase_build():
    from repro_torch.kernels import build as kbuild
    mods, srcs = kernel_modules(), kernel_sources()
    t0 = time.perf_counter()
    libs = kbuild.build(*srcs.values())
    for m in mods.values():
        m.load()
    secs = time.perf_counter() - t0
    ptxas = {}
    for name, lib in zip(srcs, libs):
        log = Path(str(lib) + ".log").read_text()
        ptxas[name] = [ln.strip() for ln in log.splitlines()
                       if "ptxas info" in ln and ("Used" in ln or "spill" in ln)]
    emit("build", seconds=secs,
         libraries=[str(lib.relative_to(ROOT)) for lib in libs], ptxas=ptxas)


def sweep_edge_cases(dev):
    """(f, cs, w) cases at the bucketed kernel's edges: candidates
    unsorted, duplicated, all equal, descending (negative demand, as
    amax(f) < 0 makes the grid), exactly equal to some hours' f; rows of
    zero weight; G = 1, T = 1; one row of three years of hours (the fixed
    point's range); G = 4096 (32 candidate tiles)."""
    gen = torch.Generator().manual_seed(2)

    def rnd(*shape, lo=0.0, hi=300.0):
        return lo + (hi - lo) * torch.rand(*shape, generator=gen)

    f, w = rnd(6, 500), rnd(6, 500, lo=0.0, hi=1.0)
    grid = torch.linspace(0.0, 1.0, 50)
    neg = -rnd(6, 500)
    ties = f.clone()
    ties[:, ::7] = 150.0
    cases = {
        "unsorted_candidates": (f, rnd(6, 50), w),
        "duplicate_candidates": (
            f, (torch.randint(0, 6, (6, 50), generator=gen) * 60.0), w),
        "all_equal_candidates": (f, torch.full((6, 50), 120.0), w),
        "descending_grid": (
            neg, neg.amax(-1, keepdim=True) * grid[None], w),
        "f_equals_candidate": (
            ties, torch.tensor([0.0, 75.0, 150.0, 225.0, 300.0]).repeat(6, 1),
            w),
        "zero_weight_rows": (f, rnd(6, 50), w * (torch.arange(6) % 2)[:, None]),
        "G_1": (f, rnd(6, 1), w),
        "T_1": (f[:, :1], rnd(6, 50), w[:, :1]),
        "one_row_3_years": (
            rnd(1, NUM_HOURS), rnd(1, 128), rnd(1, NUM_HOURS, hi=1.0)),
        "G_4096": (f[:4], f[:4].amax(-1, keepdim=True)
                   * torch.linspace(0.0, 1.0, 4096)[None], w[:4]),
    }
    return {k: tuple(x.contiguous().to(dev) for x in v)
            for k, v in cases.items()}


def phase_kernel(dev):
    from repro_torch.kernels.commitment_sweep import ops
    from repro_torch.kernels.commitment_sweep.ref import (
        commitment_sweep_bucketed_ref,
    )
    gen = torch.Generator().manual_seed(1)

    def rnd(*shape, lo=0.0, hi=300.0):
        return (lo + (hi - lo) * torch.rand(*shape, generator=gen)).to(dev)

    def same(name, got, want):
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(f"{name}: kernel != bucketed plain version "
                                 "bit for bit")

    p, g, t = 5, 37, 300
    f, cs = rnd(p, t), rnd(p, g)
    ends = torch.tensor([[1], [50], [168], [299], [300]])
    prefix = (torch.arange(t)[None, :] < ends).float().to(dev)
    cases = {
        "ragged_weighted": (f, cs, rnd(p, t, lo=0.0, hi=1.0)),
        "ragged_no_weights": (f, cs, None),
        "ragged_prefix_masks": (f, cs, prefix),
        "ragged_shared_grid": (f, cs[0], None),
        "single_row_T": (f[0], cs[0], prefix[2]),
    }
    results = {}
    for name, (fi, ci, wi) in cases.items():
        got = ops.commitment_sweep_over_under(fi, ci, wi)
        want = ops.commitment_sweep_over_under_oracle(fi, ci, wi)
        if fi.dim() == 1:
            want = (want[0][0], want[1][0])
        torch.cuda.synchronize()
        results[name] = compare(name, got, want)
    # The bucketed kernel's edges: against the brute-force plain version
    # within the tolerance, against its own algebra bit for bit.
    for name, (fi, ci, wi) in sweep_edge_cases(dev).items():
        got = ops.commitment_sweep_over_under(fi, ci, wi)
        torch.cuda.synchronize()
        results[name] = compare(name, got, plain_chunked(fi, wi, ci, 1))
        same(name, got, commitment_sweep_bucketed_ref(fi, wi, ci))
    # a non-finite f or w makes its row NaN, never a quiet number
    fi, ci, wi = rnd(3, 64), rnd(3, 9), rnd(3, 64, hi=1.0)
    fi[0, 5], wi[2, 60] = float("nan"), float("inf")
    got = ops.commitment_sweep_over_under(fi, ci, wi)
    nan_rows = [bool(x[r].isnan().all()) for x in got for r in (0, 2)]
    if not (all(nan_rows) and torch.isfinite(got[0][1]).all()
            and torch.isfinite(got[1][1]).all()):
        raise AssertionError("non-finite inputs: rows are not NaN")

    f, w, cs = main_shape_inputs(dev)
    got = ops.commitment_sweep_over_under(f, cs, w)
    want = plain_chunked(f, w, cs)
    torch.cuda.synchronize()
    err, rel = compare("main_shape", got, want)
    same("main_shape", got, commitment_sweep_bucketed_ref(f, w, cs))
    again = ops.commitment_sweep_over_under(f, cs, w)
    if not (torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])):
        raise AssertionError("the same sweep twice differs bit for bit")
    # float64 yardstick: how far each float32 sum is from the exact one
    exact_o = torch.cat([
        (w[i:i + 256, None, :].double() * torch.clamp(
            f[i:i + 256, None, :].double() - cs[i:i + 256, :, None].double(),
            min=0.0)).sum(-1)
        for i in range(0, 1024, 256)
    ])
    kern_rel = float(((got[0][:1024].double() - exact_o).abs()
                      / exact_o.abs().clamp_min(1.0)).max())
    plain_rel = float(((want[0][:1024].double() - exact_o).abs()
                       / exact_o.abs().clamp_min(1.0)).max())
    if kern_rel > plain_rel:
        raise AssertionError(f"kernel's error against float64 {kern_rel} > "
                             f"the plain version's {plain_rel}")

    # Batched launch == one launch per row block, bit for bit (blocks of
    # 1000 rows do not align with the kernel's 8-row blocks).
    bit_exact = True
    for i in range(0, MAIN_P, 1000):
        o1, u1 = ops.commitment_sweep_over_under(
            f[i:i + 1000], cs[i:i + 1000], w[i:i + 1000]
        )
        bit_exact &= bool(torch.equal(o1, got[0][i:i + 1000]))
        bit_exact &= bool(torch.equal(u1, got[1][i:i + 1000]))
    if not bit_exact:
        raise AssertionError("batched sweep != per-block sweeps bit for bit")
    emit("kernel", cases={k: {"max_abs_err": v[0], "cost_rel_err": v[1]}
                          for k, v in results.items()},
         main_shape=[MAIN_P, MAIN_G, MAIN_T], max_abs_err=err,
         cost_rel_err=rel, over_rel_err_vs_f64_kernel=kern_rel,
         over_rel_err_vs_f64_plain=plain_rel, batched_equals_blocks=bit_exact,
         rerun_equals=True, equals_bucketed_plain=True, nan_rows=True)
    return err


def phase_ties(dev):
    """The solvers' sorts on inputs full of ties, card vs CPU, bit for bit.
    The port asks for stable sorts (``jnp.argsort`` is stable); on the CPU
    torch sorts stably either way, on the card only when asked, so this is
    where an unstable sort would show."""
    from repro_torch.core import planner as tpl
    from repro_torch.core import portfolio as tpf
    gen = torch.Generator().manual_seed(3)
    yhat = (torch.randint(0, 12, (64, 3 * 168), generator=gen) * 2.5 + 50.0)
    w_hours = torch.arange(1, 4) * 168
    qs = torch.tensor([0.0, 0.3, 0.55, 0.55, 1.0, 0.9, 0.0, 0.3]).repeat(64, 1)
    per_h = torch.randint(0, 5, (64, 8, 8), generator=gen) * 10.0 + 20.0
    terms = torch.tensor([4, 52, 2, 156, 8, 1, 52, 4])
    has = torch.rand(64, 8, generator=gen) > 0.4
    lo = torch.randint(0, 3, (64, 8), generator=gen)
    # integer widths: their cumulative sums are exact on any device, so a
    # difference can only come from the order the sort chose
    widths = torch.randint(0, 5, (64, 8), generator=gen).float()
    cases = {
        "prefix_weighted_quantiles": lambda d: tpl._prefix_weighted_quantiles(
            yhat.to(d), w_hours.to(d), qs.to(d)),
        "monotone_stack": lambda d: torch.stack(tpl._monotone_stack(
            per_h.to(d), qs.to(d), terms.to(d), 8)),
        "stack_heights": lambda d: tpf._stack_heights(
            has.to(d), lo.to(d), widths.to(d), 10),
    }
    for name, fn in cases.items():
        if not torch.equal(fn(dev).cpu(), fn(torch.device("cpu"))):
            raise AssertionError(f"{name}: card != CPU on tied inputs")
    emit("ties", cases=sorted(cases), card_equals_cpu=True)


def grid_cells(pools, rep, num_grid):
    """(S, P) grid-cell width max(yhat)/(G-1) of every replayed week's
    forecast, recomputed on the CPU with the port's forecaster."""
    from repro_torch.core import forecast as fc
    demand = torch.as_tensor(
        pools.demand[:, :(pools.num_hours // 168) * 168])
    state = fc.prefix_fit_state(
        demand, fc.ForecastConfig(), horizon_hours=rep.horizon_weeks * 168,
        min_prefix_hours=rep.start_weeks * 168,
    )
    cells = []
    for w in rep.weeks:
        yhat = fc.predict_from_beta(
            state, fc.solve_prefix(state, int(w)), int(w) * 168,
            rep.horizon_weeks * 168,
        )
        cells.append((yhat.amax(-1) / (num_grid - 1)).numpy())
    return np.stack(cells)


def phase_plan(pools):
    from repro_torch.core.api import PlanRequest, RollingConfig, plan
    req = PlanRequest(pools=pools, mode="rolling",
                      rolling=RollingConfig(solver="grid", num_grid=NUM_GRID))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    rep = plan(req)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_launches()["commitment_sweep"]
    costs = dict(total_cost=rep.total_cost, one_shot_cost=rep.one_shot_cost,
                 hindsight_cost=rep.hindsight_cost,
                 savings_vs_one_shot=rep.savings_vs_one_shot)
    if not all(np.isfinite(v) and v > 0 for k, v in costs.items()
               if k != "savings_vs_one_shot"):
        raise AssertionError(f"non-finite or non-positive costs: {costs}")
    if not (np.isfinite(rep.targets).all() and rep.targets.shape
            == (len(rep.weeks), NUM_POOLS, len(rep.options))):
        raise AssertionError("targets are not finite or of the wrong shape")
    if launches != EXPECTED_LAUNCHES:
        raise AssertionError(
            f"{launches} sweep launches, expected {EXPECTED_LAUNCHES}")
    bill_rel = {k: abs(costs[k] - v) / v for k, v in PLAN_BILL.items()}
    if max(bill_rel.values()) > BILL_RTOL:
        raise AssertionError(f"the grid plan's bill moved: {bill_rel}")
    emit("plan", solver="grid", pools=NUM_POOLS, hours=NUM_HOURS,
         weeks_replayed=len(rep.weeks), wall_s=secs,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         sweep_launches=launches, bill_rel=bill_rel, **costs)
    return rep, launches, secs


def phase_quantile(pools, grid_rep):
    from repro_torch.core.api import PlanRequest, plan
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep = plan(PlanRequest(pools=pools, mode="rolling"))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    rel = abs(grid_rep.total_cost - rep.total_cost) / rep.total_cost
    if rel > 0.02:
        raise AssertionError(f"grid total {rel:.4f} away from quantile")
    emit("quantile", wall_s=secs, total_cost=rep.total_cost,
         one_shot_cost=rep.one_shot_cost, hindsight_cost=rep.hindsight_cost,
         grid_vs_quantile_rel=rel)


def count_syncs(fn):
    """(fn(), the host syncs it made), counted by CUDA's sync debug mode."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in caught)


def phase_cpu(pools):
    from repro_torch.core.demand import PoolSet
    from repro_torch.core.replan import replan_fleet_pools
    sub = PoolSet(keys=pools.keys[:16], demand=pools.demand[:16],
                  configs=pools.configs[:16])
    kw = dict(solver="grid", num_grid=NUM_GRID)
    t0 = time.perf_counter()
    cpu = replan_fleet_pools(sub, device="cpu", **kw)
    cpu_s = time.perf_counter() - t0
    # Count the host syncs of the card replay: set-up and the final copy to
    # the host sync a fixed few times; a sync inside the weekly loop would
    # show up once per replayed week.
    # This is also the process's first planner call on the card, so its
    # time includes CUDA library initialization.
    t0 = time.perf_counter()
    card, syncs = count_syncs(lambda: replan_fleet_pools(sub, **kw))
    card_s = time.perf_counter() - t0
    if syncs >= len(card.weeks):
        raise AssertionError(
            f"{syncs} host syncs in a {len(card.weeks)}-week card replay: "
            "the weekly loop reads the device back")
    rel = {k: abs(getattr(card, k) - getattr(cpu, k)) / abs(getattr(cpu, k))
           for k in ("total_cost", "one_shot_cost", "hindsight_cost")}
    if max(rel.values()) > 1e-4:
        raise AssertionError(f"card vs CPU totals: {rel}")
    # One grid cell, max(yhat)/(G-1), plus the drift of the grid itself:
    # its top is max(yhat), which may move by the forecasts' rel 1e-4, and
    # a threshold at cell g moves g times as far.
    cells = grid_cells(sub, cpu, NUM_GRID)[:, :, None]         # (S, P, 1)
    diff = np.abs(card.targets - cpu.targets)
    if (diff > cells * (1.0 + (NUM_GRID - 1) * 1e-4)).any():
        raise AssertionError(
            "card vs CPU targets differ by more than one grid cell "
            f"(worst {float((diff / cells).max())} cells)")
    k = len(card.options)
    for i, w in enumerate(card.weeks):
        np.testing.assert_allclose(
            card.ladders.option_widths(int(w) * 168, k), card.active[i],
            rtol=1e-4, atol=1e-4)
    emit("cpu", pools=16, cpu_wall_s=cpu_s, card_wall_s_first_call=card_s,
         total_rel=rel, card_replay_host_syncs=syncs,
         max_target_diff_cells=float((diff / cells).max()),
         ladder_matches_active=True)


def fit_work(p, t, d, iters):
    """Float32 operations and bytes of fit_batched on (P, T) histories with
    D design columns: the shared gram, then per IRLS pass P weighted grams
    (2 P T D^2), their right-hand sides and residuals (2 P T D each).
    Bytes: the history read once, the coefficients written once."""
    flops = 2 * t * d * d + 2 * p * t * d + iters * (
        2 * p * t * d * d + 4 * p * t * d)
    return flops, 4 * (p * t + p * d)


def one_shot_rel(got, want):
    """Each one-shot cost of ``got`` against ``want``, as a share of the
    bill: the two totals (the pools' and the aggregate plan's) relative to
    themselves, the committed and on-demand parts relative to the pools'
    total, the premium and the savings, fractions of a bill, absolutely.
    (On-demand alone is the area above the stack, ~1% of the bill; a
    forecast that moves by 1e-5 moves it by ~3e-4 of itself.)"""
    total = abs(want.total_cost)
    scale = {"total_cost": total, "aggregate_cost": abs(want.aggregate_cost),
             "committed_cost": total, "on_demand_cost": total,
             "pooling_premium": 1.0, "savings_vs_on_demand": 1.0}
    return {k: abs(getattr(got, k) - getattr(want, k)) / scale[k]
            for k in ONE_SHOT_COSTS}


def phase_one_shot(pools, dev):
    """The default request, PlanRequest(pools=fleet): the one-shot plan."""
    from repro_torch.core import commitment as cm
    from repro_torch.core import forecast as fc
    from repro_torch.core import planner as tpl
    from repro_torch.core.api import PlanRequest, plan
    from repro_torch.core.demand import PoolSet
    from repro_torch.kernels.commitment_sweep import ops

    # the first 16 pools: the card against the CPU, and a small plan's syncs
    sub = PoolSet(keys=pools.keys[:16], demand=pools.demand[:16],
                  configs=pools.configs[:16])
    cpu = plan(PlanRequest(pools=sub), device="cpu")
    # counted on a second call: the first in a process also initializes
    # CUDA state, which synchronizes once
    card16, _ = count_syncs(lambda: plan(PlanRequest(pools=sub)))
    _, syncs16 = count_syncs(lambda: plan(PlanRequest(pools=sub)))
    card_cpu_rel = one_shot_rel(card16, cpu)
    if max(card_cpu_rel.values()) > CARD_CPU_RTOL:
        raise AssertionError(f"one-shot card vs CPU totals: {card_cpu_rel}")
    yhat_rel = float(np.abs(card16.forecasts / cpu.forecasts - 1.0).max())
    np.testing.assert_array_equal(card16.widths > 0, cpu.widths > 0)
    np.testing.assert_allclose(card16.widths, cpu.widths, **STACK_TOL)
    np.testing.assert_allclose(card16.levels, cpu.levels, **STACK_TOL)

    # the whole fleet: the main path
    req = PlanRequest(pools=pools)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    res = plan(req)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_launches()["commitment_sweep"]
    peak = torch.cuda.max_memory_allocated()
    if launches != EXPECTED_ONE_SHOT_LAUNCHES:
        raise AssertionError(f"{launches} sweep launches in the one-shot "
                             f"plan, expected {EXPECTED_ONE_SHOT_LAUNCHES}")
    _, syncs = count_syncs(lambda: plan(req))
    repeats = []
    for _ in range(3):
        t0 = time.perf_counter()
        plan(req)
        torch.cuda.synchronize()
        repeats.append(time.perf_counter() - t0)
    if syncs != syncs16:
        raise AssertionError(f"host syncs grow with the pools: {syncs16} at "
                             f"16 pools, {syncs} at {NUM_POOLS}")
    costs = {k: getattr(res, k) for k in ONE_SHOT_COSTS}
    if not all(np.isfinite(v) for v in costs.values()):
        raise AssertionError(f"non-finite one-shot costs: {costs}")
    if not (res.widths[~res.available] == 0.0).all():
        raise AssertionError("widths bought off a pool's cloud")
    if not math.isclose(res.total_cost,
                        res.committed_cost + res.on_demand_cost,
                        rel_tol=1e-12):
        raise AssertionError("total != committed + on-demand")
    bill_rel = {k: abs(getattr(res, k) - v) / abs(v)
                for k, v in ONE_SHOT_BILL.items()}
    if max(bill_rel.values()) > BILL_RTOL:
        raise AssertionError(f"the one-shot bill moved: {bill_rel}")
    per_pool_total = math.fsum(e.spend.total for e in res.per_pool)

    # the spend's sweep: one launch over the pools == a launch per block
    eval_h = HORIZON_WEEKS * 168
    actual = torch.as_tensor(pools.demand[:, -eval_h:]).to(dev)
    level = torch.as_tensor(res.widths).to(dev).sum(-1, keepdim=True)
    got = ops.commitment_sweep_over_under(actual, level)
    blocks_equal = all(
        torch.equal(ops.commitment_sweep_over_under(
            actual[i:i + 100], level[i:i + 100])[0], got[0][i:i + 100])
        for i in range(0, NUM_POOLS, 100))
    if not blocks_equal:
        raise AssertionError("the spend's sweep != a launch per row block")
    spend_err, spend_rel = compare(
        "one_shot_spend", got,
        plain_chunked(actual, torch.ones_like(actual), level))

    # the batched fit alone, by CUDA events, beside its bound
    hist = torch.as_tensor(pools.demand[:, :-eval_h]).to(dev)
    model = fc.fit_batched(hist)
    torch.cuda.synchronize()
    fit_ms = median_ms(lambda: fc.fit_batched(hist), 5)
    name = torch.cuda.get_device_name(0)
    peaks = PEAKS["pcie" if "PCIe" in name else "sxm"]
    fit_flops, fit_bytes = fit_work(*hist.shape, model.beta.shape[-1],
                                    model.cfg.irls_iters)
    fit_bound = bound(fit_flops, fit_bytes, peaks["fp32_flops"], peaks)
    fit_shape = list(hist.shape) + [model.beta.shape[-1]]
    del hist, model

    # where the plan's time goes: device busy time and kernels by name
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        plan(req)
        torch.cuda.synchronize()
    prof_s = time.perf_counter() - t0
    kernels = device_kernels(prof)
    busy_s = sum(k[0] for k in kernels) / 1e6

    # the grid+refine solver on the card against its plain version
    f, _, _ = main_shape_inputs(dev)
    c_card = ops.optimal_commitment_sweep(f)
    c_plain = torch.cat([ops.optimal_commitment_sweep_oracle(f[i:i + 512])
                         for i in range(0, MAIN_P, 512)])
    exact = cm.commitment_cost(f, cm.optimal_commitment_quantile(f))
    over_exact = {k: float((cm.commitment_cost(f, c) / exact).max() - 1.0)
                  for k, c in (("card", c_card), ("plain", c_plain))}
    if max(over_exact.values()) > SWEEP_COST_BOUND:
        raise AssertionError(f"grid+refine above the exact cost: {over_exact}")
    del f

    # Algorithm 1's golden-section path on one pool, card vs CPU
    hist0 = torch.as_tensor(pools.demand[0, :-eval_h])
    g_card = tpl.plan_commitment(hist0.to(dev), solver="golden")
    g_cpu = tpl.plan_commitment(hist0, solver="golden")
    golden_rel = abs(g_card.commitment - g_cpu.commitment) / g_cpu.commitment
    np.testing.assert_allclose(g_card.per_horizon_levels.cpu().numpy(),
                               g_cpu.per_horizon_levels.numpy(), rtol=1e-3)
    if golden_rel > 1e-3:
        raise AssertionError(f"golden plan card vs CPU: rel {golden_rel}")

    emit("one_shot", pools=NUM_POOLS, hours=NUM_HOURS,
         horizon_weeks=HORIZON_WEEKS, wall_s=secs, wall_s_repeats=repeats,
         max_memory_allocated=peak,
         sweep_launches=launches, host_syncs=syncs, host_syncs_16=syncs16,
         bill_rel=bill_rel, card_vs_cpu_16_rel=card_cpu_rel,
         card_vs_cpu_16_forecast_rel=yhat_rel,
         per_pool_total_rel=abs(per_pool_total - res.total_cost)
         / res.total_cost,
         spend_batched_equals_blocks=blocks_equal,
         spend_max_abs_err=spend_err, spend_cost_rel_err=spend_rel,
         fit_ms=fit_ms, fit_bound_ms=fit_bound[0], fit_bound_by=fit_bound[1],
         fit_flops=fit_flops, fit_shape_p_t_d=fit_shape,
         profiled_wall_s=prof_s, device_busy_s=busy_s,
         device_events=sum(n for _, n, _ in kernels),
         device_busy_share_of_profiled=busy_s / prof_s,
         top_kernels=[[round(us / 1e3, 3), n, key[:80]]
                      for us, n, key in kernels[:8]],
         grid_refine_over_exact=over_exact,
         golden_card_vs_cpu_rel=golden_rel, nvidia_smi=smi(), **costs)
    return launches


def device_kernels(prof):
    """(device us, count, name) of every device-side event (kernels,
    memcpys, memsets), largest first: the aten ops on the host side carry
    their kernels' time too and would count twice; the profiler's own
    buffer events are not the program's work."""
    kernels = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        on_device = str(getattr(ev, "device_type", "")).endswith("CUDA")
        if dev_us > 0 and on_device and "Buffer" not in ev.key:
            kernels.append((dev_us, ev.count, ev.key))
    return sorted(kernels, reverse=True)


def phase_profile(pools, rep, plan_s):
    """Where the plan's time goes: the grid plan again under
    torch.profiler (device time by kernel, device busy share), and the
    host-side tranche book timed alone on the plan's own targets."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import ladder as ld
    from repro_torch.core.api import PlanRequest, RollingConfig, plan
    req = PlanRequest(pools=pools, mode="rolling",
                      rolling=RollingConfig(solver="grid", num_grid=NUM_GRID))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        plan(req)
        torch.cuda.synchronize()
    prof_s = time.perf_counter() - t0
    kernels = device_kernels(prof)
    busy_s = sum(k[0] for k in kernels) / 1e6
    sweep_s = sum(k[0] for k in kernels if "sweep_kernel" in k[2]) / 1e6
    lines = [f"{us / 1e3:12.3f} ms {n:8d}x  {key}" for us, n, key in kernels]
    out = ROOT / "build" / "chip_smoke"
    out.mkdir(parents=True, exist_ok=True)
    (out / "profile_grid_plan.txt").write_text(
        f"{torch.cuda.get_device_name(0)}, {smi()}\n"
        f"profiled plan wall {prof_s:.3f} s, device busy {busy_s:.3f} s\n"
        + "\n".join(lines) + "\n")
    # the tranche book the replay builds after its loop, alone
    weeks, k = rep.weeks, len(rep.options)
    dec = rep.decision_mask
    full = np.zeros((NUM_POOLS, weeks[-1] + 1, k), np.float32)
    full[:, weeks[dec]] = np.swapaxes(rep.targets[dec], 0, 1)
    terms = np.asarray([o.term_weeks * 168 for o in rep.options])
    t0 = time.perf_counter()
    ld.plan_pool_portfolio_purchases(full, terms, rep.keys)
    ladder_s = time.perf_counter() - t0
    emit("profile", solver="grid", plan_wall_s=plan_s,
         profiled_wall_s=prof_s, device_busy_s=busy_s,
         device_events=sum(n for _, n, _ in kernels),
         device_busy_share_of_profiled=busy_s / prof_s,
         sweep_device_s=sweep_s, ladder_book_host_s=ladder_s,
         top_kernels=[[round(us / 1e3, 3), n, key[:80]]
                      for us, n, key in kernels[:8]])


def median_ms(fn, reps, cover=True):
    """Median device milliseconds of fn() over reps runs, by CUDA events.
    With ``cover``, a spin kernel queued before the start event keeps the
    card busy while the host enqueues fn's launches, so the interval is the
    card's time for fn and not the host's dispatch (which would dominate a
    Python wrapper around a kernel of a few tens of microseconds); without
    it, on an idle card, the interval is one call's dispatch and run."""
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
            enable_timing=True)
        if cover:
            torch.cuda._sleep(HOST_COVER_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def flash_inputs(dev, dtype, b, hq, hkv, sq, skv, d, seed, layout="bhsd"):
    gen = torch.Generator().manual_seed(seed)
    shape_q = (b, hq, sq, d) if layout == "bhsd" else (b, sq, hq, d)
    shape_kv = (b, hkv, skv, d) if layout == "bhsd" else (b, skv, hkv, d)
    return [torch.randn(s_, generator=gen).to(dev, dtype)
            for s_ in (shape_q, shape_kv, shape_kv)]


def decode_inputs(dev, dtype=torch.bfloat16):
    """The batched decode's call: 8 slots, one query each, against the
    (B, S, H, D) cache, each slot with its own fill level."""
    b, h, d = FLASH_DECODE
    q, k, v = flash_inputs(dev, dtype, b, h, h, 1, SERVE_CACHE, d, 11,
                           layout="bshd")
    kv_len = torch.tensor([1, 129, 700, 1501, 2048, 2900, 3999, 4096],
                          dtype=torch.int32, device=dev)
    return q, k, v, kv_len


def flash_compare(name, got, want, tol):
    """Hold got to want (..., D) by ``tol``: element by element, and, where
    it names ``row``, each row's error norm against the row's norm.
    Returns the largest absolute error and the largest row ratio."""
    torch.cuda.synchronize()
    got, want = got.float(), want.float()
    elem = {k: tol[k] for k in ("atol", "rtol")}
    torch.testing.assert_close(got, want, **elem,
                               msg=lambda m: f"flash {name}: {m}")
    err, norm = (got - want).norm(dim=-1), want.norm(dim=-1)
    row = float((err / norm.clamp_min(torch.finfo(torch.float32).tiny)).max())
    if "row" in tol and not bool((err <= tol["row"] * norm).all()):
        raise AssertionError(f"flash {name}: a row's error is {row:.3g} of "
                             f"its norm, above {tol['row']}")
    return float((got - want).abs().max()), row


def flash_routed(fk, fn):
    """Run fn(); return its result and the one flash kernel it launched."""
    before = dict(fk.LAUNCHES_BY_KERNEL)
    out = fn()
    used = [k for k, n in fk.LAUNCHES_BY_KERNEL.items() if n != before[k]]
    if len(used) != 1 or fk.LAUNCHES_BY_KERNEL[used[0]] != before[used[0]] + 1:
        raise AssertionError(f"flash: one call launched {used}")
    return out, used[0]


def phase_flash(dev):
    """Every flash kernel against the plain version: the ragged cases in
    f32 and bf16 and both layouts, each checked to have launched the
    kernel its route names (f32 prefill and bf16 D = 32 on simt, bf16
    D = 64/128 prefill on prefill_tc, one query on decode_split), then the
    prefill and decode main shapes, the decode also against the split-KV
    algebra's plain version.  Returns the largest error over all cases."""
    from repro_torch.kernels.flash_attention import flash_attention as fk
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import (
        attention_ref,
        attention_split_ref,
    )
    errs, rows, routes = {}, {}, {}
    vec_kv = torch.tensor([130, 200, 300], dtype=torch.int32)
    cases = {  # (b, hq, hkv, sq, skv, d, causal, kv_len)
        "mha_ragged": (2, 4, 4, 77, 77, 64, True, None),
        "gqa_ragged": (2, 8, 2, 200, 200, 64, True, None),
        "mqa_d128": (1, 8, 1, 64, 64, 128, True, None),
        "decode_one_query": (2, 4, 2, 1, 300, 64, True, None),
        "cross_d32": (1, 2, 2, 96, 160, 32, True, None),
        "noncausal": (2, 4, 2, 100, 150, 64, False, None),
        "padded_cache": (2, 8, 2, 3, 384, 64, True, 257),
        "d128_ragged": (1, 4, 4, 300, 300, 128, True, None),
        "vec_kv_len_prefill": (3, 4, 2, 130, 300, 64, True, vec_kv),
        "gqa8_decode_d128": (3, 16, 2, 1, 1000, 128, True,
                             torch.tensor([1, 513, 1000], dtype=torch.int32)),
        # 6 tiles of 128 keys at D = 64: wraps prefill_tc's 3-stage ring
        "ring_wrap_kv_len": (2, 8, 2, 520, 700, 64, True,
                             torch.tensor([611, 700], dtype=torch.int32)),
        # simt's tile seams (64 rows, 64 keys), GQA group 4: Sq and Skv
        # one past, one short of and 8 past a tile, kv_len below Skv
        "seam_65_d64": (1, 4, 1, 65, 65, 64, True, None),
        "seam_127_d32": (2, 8, 2, 127, 127, 32, True, None),
        "seam_200_d128": (1, 8, 2, 200, 200, 128, True, None),
        "seam_kv_len_190": (1, 4, 1, 127, 200, 64, True, 190),
        "seam_kv_len_d128": (1, 8, 2, 65, 127, 128, True,
                             torch.tensor([100], dtype=torch.int32)),
        "seam_kv_len_d32": (2, 4, 1, 200, 256, 32, True,
                            torch.tensor([230, 256], dtype=torch.int32)),
        "seam_noncausal": (1, 4, 1, 65, 200, 64, False, 127),
    }
    for i, (name, (b, hq, hkv, sq, skv, d, causal, kvl)) in enumerate(
            cases.items()):
        kvl = kvl.to(dev) if isinstance(kvl, torch.Tensor) else kvl
        for dtype, tol in ((torch.float32, FLASH_F32),
                           (torch.bfloat16, FLASH_BF16)):
            for layout in ("bhsd", "bshd"):
                q, k, v = flash_inputs(dev, dtype, b, hq, hkv, sq, skv, d, i,
                                       layout)
                got, used = flash_routed(fk, lambda: ops.flash_attention(
                    q, k, v, causal=causal, kv_len=kvl, layout=layout))
                if used != fk.route(dtype, d, sq):
                    raise AssertionError(f"flash {name}: launched {used}, "
                                         f"route {fk.route(dtype, d, sq)}")
                if layout == "bshd":
                    q, k, v, got = (x.transpose(1, 2) for x in (q, k, v, got))
                want = attention_ref(q, k, v, causal=causal, kv_len=kvl)
                key = f"{name}_{str(dtype)[6:]}_{layout}"
                errs[key], rows[key] = flash_compare(key, got, want, tol)
                routes[key] = used
    b, h, s, d = FLASH_PREFILL
    for dtype, tol in ((torch.bfloat16, FLASH_BF16), (torch.float32,
                                                       FLASH_F32)):
        q, k, v = flash_inputs(dev, dtype, b, h, h, s, s, d, 20,
                               layout="bshd")
        got, used = flash_routed(fk, lambda: ops.flash_attention(
            q, k, v, causal=True, layout="bshd"))
        want = attention_ref(
            *(x.transpose(1, 2) for x in (q, k, v)), causal=True)
        key = f"prefill_{str(dtype)[6:]}"
        errs[key], rows[key] = flash_compare(
            "prefill", got.transpose(1, 2), want, tol)
        routes[key] = used
    for dtype, tol in ((torch.bfloat16, FLASH_BF16), (torch.float32,
                                                       FLASH_F32)):
        q, k, v, kv_len = decode_inputs(dev, dtype)
        got, used = flash_routed(fk, lambda: ops.flash_attention(
            q, k, v, causal=True, kv_len=kv_len, layout="bshd"))
        want = attention_ref(
            *(x.transpose(1, 2) for x in (q, k, v)), causal=True,
            kv_len=kv_len)
        key = f"decode_{str(dtype)[6:]}"
        errs[key], rows[key] = flash_compare(
            "decode", got.transpose(1, 2), want, tol)
        routes[key] = used
        split = attention_split_ref(
            *(x.transpose(1, 2) for x in (q, k, v)), kv_len, fk.DECODE_SPLIT)
        key = f"decode_vs_split_ref_{str(dtype)[6:]}"
        errs[key], rows[key] = flash_compare(
            "decode vs split ref", got.transpose(1, 2), split, tol)
    emit("flash", max_abs_err=errs, row_err_over_norm=rows, routes=routes,
         tol_f32=FLASH_F32,
         tol_bf16=FLASH_BF16, prefill_shape=list(FLASH_PREFILL),
         decode=dict(slots=FLASH_DECODE[0], heads=FLASH_DECODE[1],
                     head_dim=FLASH_DECODE[2], cache=SERVE_CACHE,
                     kv_len=decode_inputs(dev)[3].tolist()))
    return max(errs.values())


def linrec_inputs(dev, b, h, t, d, seed, *, lo=-6.0, hi=3.0, layout="bhtd"):
    """r, k, v normal; logw = -exp(U(lo, hi)), by default the model's decay
    range up to strong decays (w = exp(logw) down to e^-20; the model's
    whole range is lo = -20, hi = 10); u normal; a nonzero state."""
    gen = torch.Generator().manual_seed(seed)
    shape = (b, h, t, d) if layout == "bhtd" else (b, t, h, d)
    r, k, v = (torch.randn(shape, generator=gen) for _ in range(3))
    logw = -torch.exp(lo + (hi - lo) * torch.rand(shape, generator=gen))
    u = torch.randn(h, d, generator=gen)
    s0 = 0.1 * torch.randn(b, h, d, d, generator=gen)
    return [x.to(dev) for x in (r, k, v, logw, u, s0)]


def phase_linrec(dev):
    """The RWKV6 kernels (one call: chunk, state scan, inter) against the
    chunked plain version: ragged T, both layouts, a carried state, the
    model's whole decay range, a chunk whose decay is exactly 0, B = 2 at
    T = 2048, and the main shape; there also the states the scan leaves in
    the scratch against the chunk-parallel plain version's."""
    from repro_torch.kernels.linrec import linrec as lk
    from repro_torch.kernels.linrec import ops
    from repro_torch.kernels.linrec.ref import (
        rwkv6_chunk_parallel_ref,
        rwkv6_chunked_ref,
    )
    errs = {}
    cases = {  # (b, h, t, d, layout, logw range)
        "single_chunk": (1, 2, 32, 16, "bhtd", (-6.0, 3.0)),
        "ragged_70": (2, 3, 70, 16, "bhtd", (-6.0, 3.0)),
        "t_33_d32": (2, 2, 33, 32, "bthd", (-6.0, 3.0)),
        "ragged_1000_d64": (1, 4, 1000, 64, "bthd", (-6.0, 3.0)),
        "one_step": (3, 2, 1, 64, "bhtd", (-6.0, 3.0)),
        "model_range_1000": (2, 4, 1000, 64, "bthd", (-20.0, 10.0)),
        "b2_bthd_2048": (2, 40, 2048, 64, "bthd", (-6.0, 3.0)),
        "zero_decay_chunk": (2, 3, 130, 64, "bhtd", (-20.0, 10.0)),
    }
    for i, (name, (b, h, t, d, layout, (lo, hi))) in enumerate(cases.items()):
        r, k, v, logw, u, s0 = linrec_inputs(dev, b, h, t, d, i, lo=lo,
                                             hi=hi, layout=layout)
        if name == "zero_decay_chunk":  # exp(sum logw) of chunk 1 is 0
            logw[:, :, 32:64] = -float(np.exp(10.0))
        y, s = ops.rwkv6_linear_attention_logw(r, k, v, logw, u, s0,
                                               layout=layout)
        if layout == "bthd":
            r, k, v, logw, y = (x.transpose(1, 2) for x in (r, k, v, logw, y))
        wy, ws = rwkv6_chunked_ref(r, k, v, logw, u, s0)
        torch.cuda.synchronize()
        if not (torch.isfinite(y).all() and torch.isfinite(s).all()):
            raise AssertionError(f"linrec {name}: non-finite output")
        for label, a, b_ in (("y", y, wy), ("state", s, ws)):
            torch.testing.assert_close(
                a, b_, **LINREC_TOL, msg=lambda m: f"linrec {name} {label}: {m}")
        errs[name] = float(torch.maximum((y - wy).abs().max(),
                                         (s - ws).abs().max()))
    # w = 1e-6 everywhere: the decay that breaks the factored form
    r, k, v, _, u, s0 = linrec_inputs(dev, 1, 2, 64, 16, 9)
    logw = torch.full_like(r, float(np.log(1e-6)))
    y, s = ops.rwkv6_linear_attention_logw(r, k, v, logw, u, s0)
    if not (torch.isfinite(y).all() and torch.isfinite(s).all()):
        raise AssertionError("linrec: non-finite output at w = 1e-6")
    wy, ws = rwkv6_chunked_ref(r, k, v, logw, u, s0)
    torch.testing.assert_close(y, wy, **LINREC_TOL)
    errs["w_1e-6"] = float((y - wy).abs().max())
    b, h, t, d = LINREC_MAIN
    r, k, v, logw, u, s0 = linrec_inputs(dev, b, h, t, d, 10,
                                         layout="bthd")
    y, s = ops.rwkv6_linear_attention_logw(r, k, v, logw, u, s0,
                                           layout="bthd")
    bhtd = [x.transpose(1, 2) for x in (r, k, v, logw)]
    wy, ws = rwkv6_chunked_ref(*bhtd, u, s0)
    torch.cuda.synchronize()
    torch.testing.assert_close(y.transpose(1, 2), wy, **LINREC_TOL)
    torch.testing.assert_close(s, ws, **LINREC_TOL)
    errs["main"] = float(torch.maximum((y.transpose(1, 2) - wy).abs().max(),
                                       (s - ws).abs().max()))
    if not torch.isfinite(y).all():
        raise AssertionError("linrec: non-finite output at the main shape")
    # the states entering each chunk, as the scan leaves them in scratch
    _, _, entering = lk.rwkv6_cuda(r, k, v, logw, u, s0, time_dim=1,
                                   entering=True)
    _, _, want = rwkv6_chunk_parallel_ref(*bhtd, u, s0)
    torch.cuda.synchronize()
    torch.testing.assert_close(entering, want, **LINREC_TOL,
                               msg=lambda m: f"linrec entering states: {m}")
    errs["main_entering_states"] = float((entering - want).abs().max())
    emit("linrec", max_abs_err=errs, tol=LINREC_TOL,
         main_shape=list(LINREC_MAIN),
         logw_range=[-float(np.exp(3.0)), -float(np.exp(-6.0))],
         model_logw_range=[-float(np.exp(10.0)), -float(np.exp(-20.0))],
         entering_states_shape=list(entering.shape))
    return max(errs.values())


def serve_prompt_lengths():
    """The serve phases' prompt lengths (numpy seed 0) and the generator
    that goes on to draw their tokens."""
    rng = np.random.default_rng(0)
    return rng.integers(PROMPT_MIN, PROMPT_MAX + 1, SERVE_REQUESTS), rng


def serve(engine, requests):
    """Admit in arrival order while slots are free, tick, until every
    request is done; all requests arrive at t = 0.  Returns host-clock
    timings (each admission and tick ends in a device-to-host copy)."""
    pending = list(requests)
    ttft, prefill_one, prefill_s, tick_s, decoded, ticks = {}, {}, 0.0, 0.0, 0, 0
    t_start = time.perf_counter()
    while pending or engine.active_slots:
        while pending:
            t0 = time.perf_counter()
            if not engine.try_admit(pending[0]):
                break
            t1 = time.perf_counter()
            prefill_s += t1 - t0
            prefill_one[pending[0].rid] = t1 - t0
            ttft[pending.pop(0).rid] = t1 - t_start
        t0 = time.perf_counter()
        active = engine.active_slots
        engine.tick()
        tick_s += time.perf_counter() - t0
        decoded += active
        ticks += 1
    return dict(wall_s=time.perf_counter() - t_start, prefill_s=prefill_s,
                decode_s=tick_s, decode_tokens=decoded, ticks=ticks,
                ttft=ttft, prefill_one=prefill_one)


def phase_serve(name, arch, dev, counted):
    """The full published ``arch`` served by the engine: the main path of
    the kernel named ``counted``."""
    from repro_torch import configs
    from repro_torch.models.model import build
    from repro_torch.serve.engine import Request, ServeEngine
    cfg = configs.get(arch)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = build(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    lens, rng = serve_prompt_lengths()
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in lens]
    reqs = [Request(i, p, NEW_TOKENS) for i, p in enumerate(prompts)]
    engine = ServeEngine(model, num_slots=SERVE_SLOTS, cache_len=SERVE_CACHE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    stats = serve(engine, reqs)
    torch.cuda.synchronize()
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    if not all(r.done and len(r.generated) == NEW_TOKENS + 1 for r in reqs):
        raise AssertionError(f"{name}: not every request got "
                             f"{NEW_TOKENS + 1} tokens")
    toks = np.concatenate([r.generated for r in reqs])
    if toks.min() < 0 or toks.max() >= cfg.vocab_size:
        raise AssertionError(f"{name}: token ids outside the vocabulary")
    if launches[counted] == 0:
        raise AssertionError(f"{name}: no {counted} launch on its main path")
    ticks = stats["ticks"]
    if counted == "flash_attention":
        want = cfg.num_layers * (SERVE_REQUESTS + ticks)
    else:  # prefill only: a one-token decode step needs no kernel
        want = cfg.num_layers * SERVE_REQUESTS
    if launches[counted] != want:
        raise AssertionError(
            f"{name}: {launches[counted]} {counted} launches, expected {want}")
    if counted == "flash_attention":  # every prompt is > 1 token, bf16, D 64
        mix = dict(prefill_tc=cfg.num_layers * SERVE_REQUESTS,
                   decode_split=cfg.num_layers * ticks, simt=0)
        if launches["flash_by_kernel"] != mix:
            raise AssertionError(f"{name}: flash launches by kernel "
                                 f"{launches['flash_by_kernel']}, expected "
                                 f"{mix}")
    # The engine against a direct prefill of the first request in a fresh
    # one-slot cache: finite logits and the engine's first token.
    cache = model.init_cache(1, SERVE_CACHE)
    logits, _ = model.apply(torch.as_tensor(prompts[0][None], device=dev),
                            mode="prefill", cache=cache, pos=0)
    if not torch.isfinite(logits).all():
        raise AssertionError(f"{name}: non-finite prefill logits")
    if int(logits[0, -1].argmax()) != reqs[0].generated[0]:
        raise AssertionError(f"{name}: engine's first token != direct "
                             "prefill's")
    prof = profile_serving(name, engine, reqs, stats, counted)
    ttft = sorted(stats["ttft"].values())
    out = dict(
        arch=arch, params=model.num_params(), dtype=cfg.dtype,
        layers=cfg.num_layers, d_model=cfg.d_model, vocab=cfg.vocab_size,
        slots=SERVE_SLOTS, cache_len=SERVE_CACHE, requests=SERVE_REQUESTS,
        prompt_tokens=int(lens.sum()), prompt_len_min_max=[int(lens.min()),
                                                           int(lens.max())],
        new_tokens=NEW_TOKENS, init_s=init_s, wall_s=stats["wall_s"],
        prefill_s=stats["prefill_s"],
        prefill_tokens_per_s=float(lens.sum()) / stats["prefill_s"],
        decode_s=stats["decode_s"], decode_ticks=ticks,
        decode_tokens=stats["decode_tokens"],
        decode_tokens_per_s=stats["decode_tokens"] / stats["decode_s"],
        ttft_p50_s=ttft[len(ttft) // 2], ttft_max_s=ttft[-1],
        ttft_first_s=ttft[0], launches=launches,
        max_memory_allocated=peak, profile=prof)
    emit(name, **out)
    del engine, model, cache
    torch.cuda.empty_cache()
    return launches[counted], out


def profile_serving(name, engine, reqs, stats, counted):
    """Where serving time goes, under torch.profiler on the drained engine:
    the longest request's prefill again, then PROFILE_TICKS ticks with
    every slot busy.  Device busy time is set against the same work's
    unprofiled host-clock time from the timed run (the profiler slows the
    host), so ``device_busy_share`` is the device's share of real time.
    Full tables in build/chip_smoke/profile_<name>.txt."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.engine import Request
    # every kernel of the path: flash's four, RWKV6's three
    kernel = {"flash_attention": "flash_", "rwkv6": "rwkv6_"}[counted]
    longest = max(reqs, key=lambda r: len(r.prompt))
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof_pre:
        engine.try_admit(Request(1000, longest.prompt, PROFILE_TICKS + 1))
        torch.cuda.synchronize()
    for i in range(1, SERVE_SLOTS):
        engine.try_admit(Request(1000 + i, reqs[i % len(reqs)].prompt[:PROMPT_MIN],
                                 PROFILE_TICKS + 1))
    with profile(activities=acts) as prof_dec:
        for _ in range(PROFILE_TICKS):
            engine.tick()
        torch.cuda.synchronize()
    while engine.active_slots:
        engine.tick()
    out, text = {}, [smi()]
    for label, prof, real_s in (
            ("prefill_longest", prof_pre, stats["prefill_one"][longest.rid]),
            ("decode_tick", prof_dec, stats["decode_s"] * PROFILE_TICKS
             / stats["ticks"])):
        kernels = device_kernels(prof)
        busy = sum(k[0] for k in kernels) / 1e6
        own = sum(k[0] for k in kernels if kernel in k[2]) / 1e6
        launches = sum(k[1] for k in kernels)
        n = 1 if label == "prefill_longest" else PROFILE_TICKS
        by_name = {  # device seconds per step of each of the port's kernels
            part: sum(k[0] for k in kernels if part in k[2]) / 1e6 / n
            for part in (FLASH_PROFILE_NAMES if counted == "flash_attention"
                         else RWKV6_PROFILE_NAMES)}
        out[label] = dict(
            unprofiled_s=real_s / n, device_busy_s=busy / n,
            device_busy_share=busy / real_s, kernel_device_s=own / n,
            kernel_device_s_by_name=by_name,
            kernel_share_of_busy=own / busy if busy else None,
            device_events=launches / n,
            prompt_tokens=len(longest.prompt) if n == 1 else None,
            top=[[round(us / 1e3 / n, 4), c // n, key[:60]]
                 for us, c, key in kernels[:5]])
        text.append(f"{label}: unprofiled {real_s / n:.6f} s, device busy "
                    f"{busy / n:.6f} s per {'prefill' if n == 1 else 'tick'}")
        text += [f"{us / 1e3 / n:12.4f} ms {c / n:8.1f}x  {key}"
                 for us, c, key in kernels]
    path = ROOT / "build" / "chip_smoke"
    path.mkdir(parents=True, exist_ok=True)
    (path / f"profile_{name}.txt").write_text("\n".join(text) + "\n")
    return out


def phase_model_cpu(dev):
    """Both reduced float32 configs, one set of weights, served on the CPU
    (plain versions) and on the card (kernels)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models.model import build
    from repro_torch.serve.engine import Request, ServeEngine
    out = {}
    reset_launches()
    for arch in ("stablelm-1.6b", "rwkv6-3b"):
        cfg = dataclasses.replace(configs.reduced(arch), dtype="float32")
        cpu = build(cfg, device="cpu").init(torch.Generator().manual_seed(0))
        card = build(cfg, device=dev)
        card.load_state_dict(cpu.state_dict())
        rng = np.random.default_rng(1)
        specs = [(rng.integers(0, cfg.vocab_size, n).astype(np.int32), m)
                 for n, m in ((5, 6), (40, 4), (77, 8), (12, 5), (100, 3))]
        gens = []
        for model in (cpu, card):
            reqs = [Request(i, p, m) for i, (p, m) in enumerate(specs)]
            serve(ServeEngine(model, num_slots=3, cache_len=128), reqs)
            gens.append([r.generated for r in reqs])
        if gens[0] != gens[1]:
            raise AssertionError(f"model_cpu {arch}: card tokens != CPU")
        tok = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 37)))
        errs = {}
        results = []
        for model in (cpu, card):
            cache = model.init_cache(2, 64)
            pre, cache = model.apply(tok[:, :36], mode="prefill",
                                     cache=cache, pos=0)
            dec, _ = model.apply(tok[:, 36:], mode="decode", cache=cache,
                                 pos=torch.tensor([36, 36]))
            train, _ = model.apply(tok, mode="train")
            results.append((pre.cpu(), dec.cpu(), train.cpu()))
        tol = MODEL_TOL[arch]
        for label, a, b in zip(("prefill", "decode", "train"), *results):
            torch.testing.assert_close(
                b, a, atol=tol, rtol=tol,
                msg=lambda m: f"model_cpu {arch} {label}: {m}")
            errs[label] = float((a - b).abs().max())
        out[arch] = dict(tokens_equal=True, max_abs_err=errs, tol=tol,
                         requests=len(specs))
    # float32: the decode on decode_split, the prefill (and train) on simt
    flash = read_launches()["flash_by_kernel"]
    if not (flash["decode_split"] > 0 and flash["simt"] > 0
            and flash["prefill_tc"] == 0):
        raise AssertionError(f"model_cpu: flash launches by kernel {flash}")
    emit("model_cpu", flash_launches_by_kernel=flash, **out)


def flash_flops_bytes(b, h, sq, kv_lens, d, elem_bytes, causal):
    """Products (QK^T and PV, 2 flops per multiply-add) over the keys each
    query row attends to, and each input read and output written once
    (K/V only up to each row's kv_len)."""
    keys = 0
    for n in kv_lens:
        if causal:  # query i sees n - sq + i + 1 keys
            keys += sum(n - sq + i + 1 for i in range(sq))
        else:
            keys += sq * n
    flops = 4 * h * d * keys
    kv_read = 2 * h * d * sum(kv_lens) * elem_bytes
    nbytes = kv_read + 2 * b * h * sq * d * elem_bytes
    return flops, nbytes


def linrec_flops_bytes(b, h, t, d):
    """The chunked form's arithmetic per (batch, head, chunk of L = 32):
    r.S, the strictly causal (L, L, dk) decay sum (exp, two multiplies and
    an add per term), att @ v, the bonus and the state update; bytes: r, k,
    v, logw read and y written once, float32, plus the state in and out."""
    L = 32
    chunks = -(-t // L)
    per_chunk = (2 * L * d * d + 4 * (L * (L - 1) // 2) * d
                 + 2 * (L * (L - 1) // 2) * d + 3 * L * d + 2 * L * d * d)
    flops = b * h * chunks * per_chunk
    nbytes = 4 * (5 * b * h * t * d + 2 * b * h * d * d)
    return flops, nbytes


def time_turns(kernel, plain, kernel_reps=25, plain_reps=5):
    """plain, kernel, kernel, plain: both measured in turns on one card;
    returns (kernel ms, plain ms, the kernel's two sets, the plain's)."""
    for fn in (kernel, plain):
        fn()
    torch.cuda.synchronize()
    plain_a = median_ms(plain, plain_reps)
    kern_a = median_ms(kernel, kernel_reps)
    kern_b = median_ms(kernel, kernel_reps)
    plain_b = median_ms(plain, plain_reps)
    return (statistics.median([kern_a, kern_b]), (plain_a + plain_b) / 2,
            [kern_a, kern_b], [plain_a, plain_b])


def library_ms(fn, reps=25):
    fn()
    torch.cuda.synchronize()
    return median_ms(fn, reps)


def bound(flops, nbytes, flops_peak, peak):
    t_ops, t_bytes = flops / flops_peak, nbytes / peak["bytes"]
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def host_ms(fn, calls=50):
    """Host milliseconds per call of fn(): calls enqueued back to back on
    the host clock, none waiting for the card (the queue holds them)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e3 * (t1 - t0) / calls


def flash_timed(kernel, plain, library, flops, nbytes, flops_peak, peak):
    """One flash kernel at its routed main shape: device ms (kernel and
    plain in turns, the library call), the bound, and the host's share:
    host ms per call, and ms per call between events on an idle card
    (dispatch and run), for the kernel's wrapper and the library call."""
    ms, plain_ms, kern_sets, plain_sets = time_turns(kernel, plain)
    ms_bound, by = bound(flops, nbytes, flops_peak, peak)
    return dict(ms=ms, plain_ms=plain_ms, kernel_ms=kern_sets,
                plain_ms_sets=plain_sets, library_ms=library_ms(library),
                bound_ms=ms_bound, bound_by=by, bound_flops=flops,
                bound_bytes=nbytes, host_ms=host_ms(kernel),
                library_host_ms=host_ms(library),
                idle_call_ms=median_ms(kernel, 25, cover=False),
                library_idle_call_ms=median_ms(library, 25, cover=False))


def timing_flash(dev, peak):
    """Each flash kernel at the main shape its route serves, with its
    plain version and scaled_dot_product_attention in the same call:
    prefill_tc at the bf16 prefill, decode_split at the bf16 decode, simt
    at the same prefill in float32 (the reduced models' dtype) and at head
    dim 128 (a shape no main path gives it, timed for ranking); the bounds
    from this run's inputs."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention as fk
    from repro_torch.kernels.flash_attention.ref import attention_ref
    b, h, s, _ = FLASH_PREFILL
    lens = torch.full((b,), s, dtype=torch.int32, device=dev)
    out = {}
    for name, dtype, elem, flops_peak, d in (
            ("prefill_tc", torch.bfloat16, 2, peak["bf16_flops"], 64),
            ("simt", torch.float32, 4, peak["fp32_flops"], 64),
            ("simt_d128", torch.float32, 4, peak["fp32_flops"], 128)):
        q, k, v = flash_inputs(dev, dtype, b, h, h, s, s, d, 20,
                               layout="bshd")
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        assert fk.route(dtype, d, s) == name.removesuffix("_d128")
        flops, nbytes = flash_flops_bytes(b, h, s, [s] * b, d, elem, True)
        out[name] = flash_timed(
            lambda: fk.flash_attention_cuda(
                q, k, v, lens, causal=True, scale=d ** -0.5, seq_dim=1),
            lambda: attention_ref(qt, kt, vt, causal=True),
            lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                   is_causal=True),
            flops, nbytes, flops_peak, peak)
        del q, k, v, qt, kt, vt

    dq, dk, dv, kv_len = decode_inputs(dev)
    dqt, dkt, dvt = (x.transpose(1, 2) for x in (dq, dk, dv))
    keep = (torch.arange(SERVE_CACHE, device=dev)[None, :]
            < kv_len[:, None])[:, None, None, :]
    bsl, hd, dd = FLASH_DECODE
    assert fk.route(dq.dtype, dd, 1) == "decode_split"
    dflops, dbytes = flash_flops_bytes(bsl, hd, 1, kv_len.tolist(), dd, 2,
                                       True)
    out["decode_split"] = flash_timed(
        lambda: fk.flash_attention_cuda(
            dq, dk, dv, kv_len, causal=True, scale=dd ** -0.5, seq_dim=1),
        lambda: attention_ref(dqt, dkt, dvt, causal=True, kv_len=kv_len),
        lambda: F.scaled_dot_product_attention(dqt, dkt, dvt,
                                               attn_mask=keep),
        dflops, dbytes, peak["bf16_flops"], peak)
    return out


def timing_linrec(dev, peak):
    """The RWKV6 call (three kernels) and its plain version at the main
    shape, and at a short prompt's length; then the call at each of
    serve_rwkv's prompt lengths, summed over rwkv6-3b's layers: the RWKV6
    device time of one serve run (one call per layer and request) and its
    bound.  Bounds from the work."""
    from repro_torch import configs
    from repro_torch.kernels.linrec import linrec as lk
    from repro_torch.kernels.linrec.ref import rwkv6_chunked_ref
    out = {}
    for label, (b, h, t, d) in (("main", LINREC_MAIN),
                                ("short", LINREC_SHORT)):
        r, k, v, logw, u, s0 = linrec_inputs(dev, b, h, t, d, 10,
                                             layout="bthd")
        rt, kt, vt, lt = (x.transpose(1, 2) for x in (r, k, v, logw))
        ms, plain_ms, kern_sets, plain_sets = time_turns(
            lambda: lk.rwkv6_cuda(r, k, v, logw, u, s0, time_dim=1),
            lambda: rwkv6_chunked_ref(rt, kt, vt, lt, u, s0), plain_reps=3)
        flops, nbytes = linrec_flops_bytes(b, h, t, d)
        ms_bound, by = bound(flops, nbytes, peak["fp32_flops"], peak)
        out[label] = dict(shape=[b, h, t, d], ms=ms, plain_ms=plain_ms,
                          kernel_ms=kern_sets, plain_ms_sets=plain_sets,
                          bound_ms=ms_bound, bound_by=by, bound_flops=flops,
                          bound_bytes=nbytes)
    cfg = configs.get("rwkv6-3b")
    h, d = cfg.rwkv_heads, cfg.rwkv_head_size
    run_ms = run_bound = 0.0
    for t in serve_prompt_lengths()[0].tolist():
        r, k, v, logw, u, s0 = linrec_inputs(dev, 1, h, t, d, 10,
                                             layout="bthd")
        def call():
            lk.rwkv6_cuda(r, k, v, logw, u, s0, time_dim=1)
        call()
        torch.cuda.synchronize()
        run_ms += cfg.num_layers * median_ms(call, 10)
        run_bound += cfg.num_layers * bound(
            *linrec_flops_bytes(1, h, t, d), peak["fp32_flops"], peak)[0]
    out["serve_run"] = dict(calls=cfg.num_layers * SERVE_REQUESTS,
                            ms=run_ms, bound_ms=run_bound)
    return out


def phase_timing(dev, launches, errs):
    from repro_torch.kernels.commitment_sweep import commitment_sweep as ck
    name = torch.cuda.get_device_name(0)
    peak = PEAKS["pcie" if "PCIe" in name else "sxm"]
    f, w, cs = main_shape_inputs(dev)
    ms, plain_ms, kern_sets, plain_sets = time_turns(
        lambda: ck.commitment_sweep_cuda(f, w, cs),
        lambda: plain_chunked(f, w, cs))
    nnz_w = float((w != 0).sum())
    # The bucketed work: per hour with w != 0 a binary search over G + 1
    # buckets and its terms, per output a step of the scan.
    ops = (nnz_w * (math.ceil(math.log2(MAIN_G + 1)) + OPS_PER_HOUR)
           + OPS_PER_OUTPUT * MAIN_P * MAIN_G)
    nbytes = 4 * (f.numel() + w.numel() + cs.numel() + 2 * MAIN_P * MAIN_G)
    sweep_bound = bound(ops, nbytes, peak["fp32_flops"], peak)
    # reference figures: the brute force's operations over the hours the
    # masks keep, and over every (row, candidate, hour) triple
    masked_flops = FLOPS_PER_TRIPLE * MAIN_G * nnz_w
    full_flops = FLOPS_PER_TRIPLE * MAIN_P * MAIN_G * MAIN_T
    del f, w, cs
    fl = timing_flash(dev, peak)
    lin = timing_linrec(dev, peak)
    emit("timing", peak=peak,
         commitment_sweep=dict(
             shape=[MAIN_P, MAIN_G, MAIN_T], kernel_ms=kern_sets,
             plain_ms=plain_sets, bound_ops=ops, bound_bytes=nbytes,
             bound_ms=sweep_bound[0], bound_by=sweep_bound[1],
             share_of_bound=sweep_bound[0] / ms,
             bound_ms_masked_triples=1e3 * masked_flops / peak["fp32_flops"],
             bound_ms_all_triples=1e3 * full_flops / peak["fp32_flops"]),
         flash=dict(shapes=dict(
             prefill_tc=f"{FLASH_PREFILL} causal bfloat16",
             simt=f"{FLASH_PREFILL} causal float32",
             simt_d128=f"{FLASH_PREFILL[:3] + (128,)} causal float32",
             decode_split=f"{FLASH_DECODE} cache {SERVE_CACHE} bfloat16"),
             **fl),
         rwkv6=lin)
    flash_srcs = kernel_modules()["flash_attention"].SOURCES
    flash_mix = launches["flash_by_kernel"]
    pre = fl["prefill_tc"]

    def rel(path):
        return str(path.relative_to(ROOT))
    print(json.dumps({"kernels": [
        {
            "name": "commitment_sweep", "route": "cuda",
            "source": "src/repro_torch/kernels/commitment_sweep/csrc/"
                      "commitment_sweep.cu",
            "replaces":
                "src/repro/kernels/commitment_sweep/commitment_sweep.py:64",
            "launches": launches["commitment_sweep"],
            "launches_per_plan": launches["commitment_sweep"],
            "launches_per_one_shot_plan":
                launches["commitment_sweep_one_shot"],
            "max_abs_err": errs["commitment_sweep"], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": sweep_bound[0],
            "bound_by": sweep_bound[1], "library_ms": None,
        },
        {
            "name": "flash_attention", "route": "cuda",
            "source": rel(flash_srcs["prefill_tc"]),
            "replaces":
                "src/repro/kernels/flash_attention/flash_attention.py:99",
            "launches": launches["flash_attention"],
            "launches_per_serve": launches["flash_attention"],
            "max_abs_err": errs["flash_attention"], "ms": pre["ms"],
            "plain_ms": pre["plain_ms"], "bound_ms": pre["bound_ms"],
            "bound_by": pre["bound_by"], "library_ms": pre["library_ms"],
            "shape": f"prefill {FLASH_PREFILL} causal bf16",
            "cuda_kernels": {
                kern: dict(
                    source=rel(flash_srcs[kern]),
                    launches=flash_mix[kern], shape=shape,
                    **{key: fl[kern][key] for key in (
                        "ms", "plain_ms", "bound_ms", "bound_by",
                        "library_ms", "host_ms", "library_host_ms")})
                for kern, shape in (
                    ("prefill_tc", f"prefill {FLASH_PREFILL} causal bf16"),
                    ("decode_split",
                     f"decode {FLASH_DECODE} cache {SERVE_CACHE} bf16"),
                    ("simt", f"prefill {FLASH_PREFILL} causal f32"))},
            # simt at head dim 128, which no main path gives it: a shape
            # timed for ranking, beside the library call
            "simt_d128": dict(
                shape=f"prefill {FLASH_PREFILL[:3] + (128,)} causal f32",
                **{key: fl["simt_d128"][key] for key in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}),
        },
        {
            "name": "rwkv6", "route": "cuda",
            "source": "src/repro_torch/kernels/linrec/csrc/linrec.cu",
            "replaces": "src/repro/kernels/linrec/linrec.py:92",
            "launches": launches["rwkv6"],
            "launches_per_serve": launches["rwkv6"],
            "max_abs_err": errs["rwkv6"], "ms": lin["main"]["ms"],
            "plain_ms": lin["main"]["plain_ms"],
            "bound_ms": lin["main"]["bound_ms"],
            "bound_by": lin["main"]["bound_by"], "library_ms": None,
            "library_note": "no single PyTorch call computes the RWKV6 "
                            "recurrence",
            "shape": f"{LINREC_MAIN} float32",
            "cuda_kernels": list(RWKV6_PROFILE_NAMES),
            "short": {key: lin["short"][key] for key in (
                "shape", "ms", "plain_ms", "bound_ms", "bound_by")},
            "per_serve_run": lin["serve_run"],
        },
    ]}), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    phase_device()
    phase_build()
    errs = {"commitment_sweep": phase_kernel(dev)}
    phase_ties(dev)
    errs["flash_attention"] = phase_flash(dev)
    errs["rwkv6"] = phase_linrec(dev)
    from repro_torch.data import traces
    t0 = time.perf_counter()
    pools = traces.synthetic_pool_set(
        num_pools=NUM_POOLS, num_hours=NUM_HOURS, seed=0)
    emit("fleet", pools=NUM_POOLS, hours=NUM_HOURS,
         synth_s=time.perf_counter() - t0)
    phase_cpu(pools)
    grid_rep, sweep_launches, plan_s = phase_plan(pools)
    phase_quantile(pools, grid_rep)
    one_shot_launches = phase_one_shot(pools, dev)
    phase_profile(pools, grid_rep, plan_s)
    del pools, grid_rep
    phase_model_cpu(dev)
    launches = {"commitment_sweep": sweep_launches,
                "commitment_sweep_one_shot": one_shot_launches}
    launches["flash_attention"], dense = phase_serve(
        "serve_dense", "stablelm-1.6b", dev, "flash_attention")
    launches["flash_by_kernel"] = dense["launches"]["flash_by_kernel"]
    launches["rwkv6"], _ = phase_serve(
        "serve_rwkv", "rwkv6-3b", dev, "rwkv6")
    phase_timing(dev, launches, errs)
    print(smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
