"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Drives the port's paths on the card — the commitment planner in both
modes, without and with the spot band and its Monte-Carlo replay, with
the migration and convertible bands on a fleet in generation turnover,
batched over demand scenarios, the policy tournament, and the serving
engine on the published stablelm-1.6b and rwkv6-3b — and
checks each of their kernels (commitment sweep, revocation walk,
generation turnover, flash attention, RWKV6 recurrence) against its plain
PyTorch version.  Flash
attention is three CUDA kernels, routed by dtype, head dim and query rows
(``flash_attention.route``): a tensor-core bf16 prefill (``prefill_tc``),
a split-KV decode (``decode_split``) and the SIMT kernel (``simt``: f32
prefill, bf16 with head dim 32).  Phases, in this order, each printing one
JSON line and raising on failure:

  device    card name and power limit, torch and CUDA versions
  build     nvcc build of the seven kernel sources, one nvcc each, all at
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
  turnover  generation-turnover kernel vs its plain version on the card:
            T = 1, ragged T, a fleet with no edges (pure deflation), edges
            at the first and last pool, and the main shape 1024 pools x
            26,280 hours, bit for bit, with volume conserved and a rerun
            bit for bit; the kernel against the per-hour loop
            (migrate_demand_loop) at 1024 x 4,096 hours, bit for bit; the
            kernel's, the plain version's and the loop's times
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
  spot      the spot band on the same fleet (a main path): api.plan
            rolling with the grid solver and spot=True (sweep launches 234,
            as without spot: the floors come from sorts; its total below
            phase plan's; the bill within rel 1e-4 of SPOT_BILL), the
            one-shot plan with spot=True (2 sweep launches, its bill within
            rel 1e-4 of SPOT_ONE_SHOT_BILL), both modes on the first 16
            pools card vs CPU, and replay_spot_plan of the rolling report
            over 32 revocation draws (one walk launch; availability meets
            its 0.95 target, realized cost within 10% of planned); wall
            times and peak memory
  migration the turnover fleet (1024 pools in 512 old/successor pairs, 128
            regions, 3 clouds, seed 0) synthesized on the card (one
            turnover launch, a main path), then api.plan rolling with the
            grid solver and migration=True, convertible=True (468 sweep
            launches: pool rows and cloud rows each replayed week of both
            replays; the bill within rel 1e-4 of MIGRATION_BILL), the
            one-shot plan with both bands (2 sweep launches, its bill
            within rel 1e-4 of MIGRATION_ONE_SHOT_BILL), and the
            migration-blind rolling grid plan (234) on the same fleet;
            wall times, peak memory, the aware-vs-blind margin (printed);
            both modes on the 16 pools of regions 0 and 1 (whole pairs,
            all three clouds) card vs CPU; the one-shot plan on a fleet
            that buys a convertible band (the planted two-edge table, 1024
            pools x 30 weeks): card vs CPU, the band nonzero, the bill
            within rel 1e-4 of PLANTED_ONE_SHOT_BILL
  profile   the grid plan under torch.profiler: device busy time, time by
            kernel (full table in build/chip_smoke/profile_grid_plan.txt), and
            the host-side tranche book timed alone
  scenarios scenario batching (a main path): each perturbation's rows
            built on the card against the numpy rows, bit for bit (growth
            on every pool); the fleet-scale batch of the repo's benchmark
            (N = 32 growth futures, quantile solver, cadence 1, start 26,
            horizon 8, no baselines) with scenario 0 bit for bit equal to
            the unbatched replay; api.plan rolling with the grid solver and
            ScenarioConfig(32, "regime") at phase plan's settings: exactly
            234 sweep launches (the scenarios ride the row axis), scenario
            0 bit for bit equal to phase plan's report (per-week arrays,
            weekly costs, its bills), wall time, peak memory, device busy
            under the profiler; an N = 8 spot plan (scenario 0 equal to
            phase spot's report) and replay_spot_plan(scenario=3) over 32
            draws meeting 0.95 (one walk launch); an N = 4 aware plan on
            the turnover fleet (468 launches, scenario 0 equal to phase
            migration's report); on 16 pools over the fleet's first 39
            weeks (start 26), N = 4 chunked by 3, equal to the unchunked
            run bit for bit and to the CPU within rel 1e-4 of each
            scenario's bill and one grid cell
  tournament  run_tournament at the reference's defaults (every policy, 5
            families x 32 seeds x 3 pools x 48 weeks) on the card, against
            the CPU on the same paths (rel 1e-4 of each path's bill) and
            the loop backend (rel 1e-3)
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
  walk      revocation-walk kernel vs its plain per-hour loop on the card:
            T = 1, ragged T and lanes, all-available and all-revoked
            starts, hazard 0 with recovery 1, and the main shape (32 draws
            x 1024 pools x 117 weeks of hours); states and interruptions
            bit for bit, prices within 1e-6, a rerun bit for bit
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
            shape (the sweep also at the scenario plan's 262,144 x 128 x
            1,344; flash: prefill_tc at the bf16 prefill, decode_split at
            the bf16 decode, simt at the f32 prefill, and at head dim 128
            beside the library; RWKV6 also at a short prompt's T = 128;
            the revocation walk at its main shape; the turnover kernel's
            from phase turnover),
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
# The spot band on that fleet: the rolling grid plan's and the one-shot
# plan's bills with spot=True as this script first printed them.
SPOT_BILL = {"total_cost": 3942802368.0, "one_shot_cost": 5440932352.0,
             "hindsight_cost": 5018841088.0, "spot_cost": 765553088.0}
SPOT_ONE_SHOT_BILL = {"total_cost": 417067461.5701953,
                      "committed_cost": 324499680.31017286,
                      "spot_cost": 83008230.7904413,
                      "aggregate_cost": 411927335.9105216}
SPOT_TARGET = 0.95           # SpotConfig().availability_target
SPOT_REPLAY_DRAWS = 32
SPOT_REALIZED_RTOL = 0.10    # realized vs planned cost of the replay
EXPECTED_WALK_LAUNCHES = 1   # one walk per replay
# The revocation walk's main shape: the replay's draws x pools x hours
# (the 117 replayed weeks of the grid plan); prices within WALK_PRICE_TOL
# of the plain version, states bit for bit.
WALK_MAIN = (SPOT_REPLAY_DRAWS, NUM_POOLS, 117 * 168)
WALK_PRICE_TOL = 1e-6
# operations per lane-hour: 3 compares, a select, a sub, 3 muls, 2 adds,
# the clip's max and min
WALK_OPS = 12
STACK_TOL = dict(rtol=0.03, atol=0.05)  # widths and levels, card vs CPU
SWEEP_COST_BOUND = 1e-3     # grid+refine: C(c) <= C(c_exact) (1 + bound)
PLAIN_CHUNK = 512           # rows per plain-version chunk at the main shape
# Generation turnover: the kernel's main shape is the turnover fleet's
# (P, T); the per-hour loop oracle runs on its first TURNOVER_LOOP_HOURS.
# Float32 operations, counting an expf as one: per (edge, hour) t - mid,
# the rate's product, the sigmoid's expf, add and divide, the move's
# product, the source's sub, the gain's product, the successor's add and
# the two outputs' deflator products; per lone (pool, hour) the deflator's
# product; per hour the deflator's product and expf.
TURNOVER_LOOP_HOURS = 4096
TURNOVER_PAIR_OPS = 11
TURNOVER_HOUR_OPS = 2
TURNOVER_VOLUME_RTOL = 1e-4   # perf-adjusted volume, the reference's bound
# The migration and convertible bands on the turnover fleet: sweep launches
# of the aware rolling grid plan (pool rows and cloud rows, each replayed
# week of the rolling and the one-shot replay), of the blind one, and the
# bills as this script first printed them.
EXPECTED_MIGRATION_LAUNCHES = 468
EXPECTED_TURNOVER_LAUNCHES = 1   # the fleet's synthesis
MIGRATION_BILL = {"total_cost": 2187169220.0, "one_shot_cost": 2926051328.0,
                  "hindsight_cost": 2391582720.0,
                  "convertible_cost": 9718212.0}
MIGRATION_ONE_SHOT_BILL = {"total_cost": 131127077.20286283,
                           "committed_cost": 117252783.51498042,
                           "aggregate_cost": 126406127.60638298}
MIGRATION_REGIONS = ("region_0", "region_1")   # the card-vs-CPU subset
# The one-shot convertible band where it is nonzero: the full-width fleet
# over 30 weeks with the reference's planted two-edge table (its
# tests/test_generations.py fixture: aws C6i -> C7i from week 8 over 12
# weeks, gcp N2 -> N4 from week 16 over 10), a 4-week horizon; the bill as
# this script first printed it.
PLANTED_GENERATIONS = (("aws", "C6i", "C7i", 8, 12.0, 0.25),
                       ("gcp", "N2-Standard", "N4-Standard", 16, 10.0, 0.50))
PLANTED_WEEKS, PLANTED_HORIZON_WEEKS = 30, 4
PLANTED_ONE_SHOT_BILL = {"total_cost": 31999601.274787903,
                         "conv_cost": 246545.78058510643}
# Scenario batching (scenarios=): N futures flattened into the replay's
# rows.  The fleet-scale setting of benchmarks/paper_benches.py
# (bench_fleet_scale: N = 32 growth futures, cadence 1, start 26, horizon
# 8, the quantile solver, no baselines); the grid plan at phase plan's
# settings with N = 32 regime futures (its sweep launches unchanged, the
# scenarios ride the row axis); an N = 8 spot plan and the replay of one
# of its scenarios; an N = 4 aware plan on the turnover fleet (468
# launches, as without scenarios); and N = 4 with chunk 3 on 16 pools.
SCEN_N = 32
SCEN_FLEET_KW = dict(cadence_weeks=1, start_weeks=26, horizon_weeks=8,
                     compare=False)
SCEN_SPOT_N, SCEN_SPOT_REPLAYED = 8, 3
SCEN_AWARE_N = 4
# N = 4 chunked by 3 on 16 pools over the fleet's first 39 weeks, start
# 26 (the CPU's plain sweep over 64 rows and three years took minutes)
SCEN_CHUNK_N, SCEN_CHUNK, SCEN_CHUNK_POOLS = 4, 3, 16
SCEN_CHUNK_WEEKS, SCEN_CHUNK_START = 39, 26
# scenarios whose rows of each perturbation are held against the numpy
# rows on the host, and the pools sampled (growth: every pool)
SCEN_CHECKED = (1, SCEN_N - 1)
SCEN_SAMPLED_POOLS = (0, 1, 511, NUM_POOLS - 1)
# The tournament at the reference's defaults (5 policies x 5 families x 32
# seeds x 3 pools x 48 weeks; start 20, cadence 2, horizon 8): each path's
# bill card against CPU within rel 1e-4; the scan backend against the loop
# backend within the replay parity's bill tolerance, rel 1e-3 (the loop's
# direct refit differs from the prefix-sum refit by ~1e-4 in the forecasts,
# ROADMAP Queue 3; a CPU run at this size puts paths 1.07e-4 apart).
TOURNAMENT_RTOL = 1e-4
TOURNAMENT_LOOP_RTOL = 1e-3
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


_START = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One phase's JSON line, with the seconds since the script started
    (``elapsed_s``), so a run's time can be split by phase."""
    print(json.dumps({"phase": phase, **fields,
                      "elapsed_s": time.perf_counter() - _START}),
          flush=True)


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


def main_shape_inputs(dev, seed=0, pools=NUM_POOLS):
    """Demand-like rows (synthetic forecasts repeated over 8 prefixes),
    per-row grids max(f) x linspace(0, 1, G), 0/1 prefix-mask weights —
    the shapes and weights the grid solver hands the kernel (``pools``
    rows of forecasts: the fleet's pools, or pools x scenarios)."""
    from repro_torch.numerics import linspace
    gen = torch.Generator().manual_seed(seed)
    base = 40.0 + 200.0 * torch.rand(pools, 1, generator=gen)
    t = torch.arange(MAIN_T, dtype=torch.float32)
    shape = 1.0 + 0.15 * torch.cos(2 * torch.pi * (t - 15) / 24)
    noise = 1.0 + 0.02 * torch.randn(pools, MAIN_T, generator=gen)
    yhat = (base * shape * noise).to(dev)
    f = yhat.repeat_interleave(HORIZON_WEEKS, 0).contiguous()
    wk = torch.arange(1, HORIZON_WEEKS + 1) * 168
    masks = (t[None, :] < wk[:, None]).to(torch.float32)
    w = masks.repeat(pools, 1).to(dev)
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
    from repro_torch.kernels.generation_turnover import (
        generation_turnover as gk,
    )
    from repro_torch.kernels.linrec import linrec as lk
    from repro_torch.kernels.revocation_walk import revocation_walk as wk
    return {"commitment_sweep": ck, "flash_attention": fk, "rwkv6": lk,
            "revocation_walk": wk, "generation_turnover": gk}


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
            "rwkv6": mods["rwkv6"].SOURCE,
            "revocation_walk": mods["revocation_walk"].SOURCE,
            "generation_turnover": mods["generation_turnover"].SOURCE}


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


def grid_cells(pools, rep, num_grid, demand=None):
    """(S, R) grid-cell width max(yhat)/(G-1) of every replayed week's
    forecast, recomputed on the CPU with the port's forecaster, of the
    fleet's rows or of the (R, T) ``demand`` rows given."""
    from repro_torch.core import forecast as fc
    if demand is None:
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
    prof_summary, _ = profiled(lambda: plan(req))

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
         fit_flops=fit_flops, fit_shape_p_t_d=fit_shape, **prof_summary,
         grid_refine_over_exact=over_exact,
         golden_card_vs_cpu_rel=golden_rel, nvidia_smi=smi(), **costs)
    return launches


def timed(fn, counted):
    """(fn(), wall seconds, launches of kernel ``counted`` in it, peak
    memory), with every launch count set to 0 just before."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return (res, secs, read_launches()[counted],
            torch.cuda.max_memory_allocated())


def phase_spot(pools, grid_rep):
    """The spot band on the whole fleet: the rolling grid plan and the
    one-shot plan with spot=True (the main path, launches counted from 0
    around each), both modes on the first 16 pools card against the CPU,
    then the rolling report replayed against 32 revocation draws."""
    from repro_torch.capacity.simulator import replay_spot_plan
    from repro_torch.core.api import PlanRequest, RollingConfig, plan
    from repro_torch.core.demand import PoolSet
    out = {}
    rolling = RollingConfig(solver="grid", num_grid=NUM_GRID)
    rep, secs, launches, peak = timed(lambda: plan(PlanRequest(
        pools=pools, mode="rolling", rolling=rolling, spot=True)),
        "commitment_sweep")
    costs = dict(total_cost=rep.total_cost, one_shot_cost=rep.one_shot_cost,
                 hindsight_cost=rep.hindsight_cost,
                 spot_cost=float(rep.spot_cost.sum()))
    if not all(np.isfinite(v) and v > 0 for v in costs.values()):
        raise AssertionError(f"non-finite or non-positive costs: {costs}")
    if launches != EXPECTED_LAUNCHES:
        raise AssertionError(f"{launches} sweep launches in the spot plan, "
                             f"expected {EXPECTED_LAUNCHES}")
    if not rep.total_cost < grid_rep.total_cost:
        raise AssertionError(
            f"spot total {rep.total_cost} not below the spot-free "
            f"{grid_rep.total_cost}")
    if not (rep.spot_floor >= rep.active.sum(-1) - 1e-3).all():
        raise AssertionError("a spot floor below the committed stack top")
    out["bill_rel"] = {k: abs(costs[k] - v) / v
                       for k, v in SPOT_BILL.items()}
    if max(out["bill_rel"].values()) > BILL_RTOL:
        raise AssertionError(f"the spot plan's bill moved: "
                             f"{out['bill_rel']}")
    out.update(rolling_wall_s=secs, rolling_max_memory_allocated=peak,
               rolling_sweep_launches=launches,
               rolling_vs_spot_free=rep.total_cost / grid_rep.total_cost,
               rolling=costs)

    one, secs, launches, peak = timed(
        lambda: plan(PlanRequest(pools=pools, spot=True)),
        "commitment_sweep")
    one_costs = {k: getattr(one, k) for k in ONE_SHOT_COSTS + ("spot_cost",)}
    if not all(np.isfinite(v) for v in one_costs.values()):
        raise AssertionError(f"non-finite one-shot costs: {one_costs}")
    if launches != EXPECTED_ONE_SHOT_LAUNCHES:
        raise AssertionError(f"{launches} sweep launches in the one-shot "
                             f"spot plan, expected "
                             f"{EXPECTED_ONE_SHOT_LAUNCHES}")
    out["one_shot_bill_rel"] = {k: abs(one_costs[k] - v) / abs(v)
                                for k, v in SPOT_ONE_SHOT_BILL.items()}
    if max(out["one_shot_bill_rel"].values()) > BILL_RTOL:
        raise AssertionError(f"the one-shot spot bill moved: "
                             f"{out['one_shot_bill_rel']}")
    out.update(one_shot_wall_s=secs, one_shot_max_memory_allocated=peak,
               one_shot_sweep_launches=launches, one_shot=one_costs)

    # the first 16 pools, card against CPU, as shares of the CPU bill
    sub = PoolSet(keys=pools.keys[:16], demand=pools.demand[:16],
                  configs=pools.configs[:16])
    card_cpu = {}
    for mode, fields, req in (
            ("rolling", ("total_cost", "one_shot_cost"),
             PlanRequest(pools=sub, mode="rolling", rolling=rolling,
                         spot=True)),
            ("one_shot", ("total_cost", "committed_cost", "on_demand_cost"),
             PlanRequest(pools=sub, spot=True))):
        cpu, card = plan(req, device="cpu"), plan(req)
        bill = abs(cpu.total_cost)
        rel = {k: abs(getattr(card, k) - getattr(cpu, k)) / bill
               for k in fields}
        rel["spot_cost"] = abs(float(np.sum(card.spot_cost))
                               - float(np.sum(cpu.spot_cost))) / bill
        if max(rel.values()) > CARD_CPU_RTOL:
            raise AssertionError(f"spot {mode} card vs CPU: {rel}")
        card_cpu[mode] = rel
    out["card_vs_cpu_16_rel"] = card_cpu

    # the Monte-Carlo replay of the rolling plan: the walk on the card
    rr, secs, walk_launches, peak = timed(
        lambda: replay_spot_plan(pools, rep, num_draws=SPOT_REPLAY_DRAWS),
        "revocation_walk")
    realized_rel = abs(rr.realized_cost - rr.planned_cost) / rr.planned_cost
    if walk_launches != EXPECTED_WALK_LAUNCHES:
        raise AssertionError(f"{walk_launches} walk launches in the replay")
    if not (rr.meets_target and rr.fleet_availability >= SPOT_TARGET):
        raise AssertionError(
            f"replay misses its target: min pool availability "
            f"{float(rr.mean_availability.min())}, fleet "
            f"{rr.fleet_availability}")
    if realized_rel > SPOT_REALIZED_RTOL:
        raise AssertionError(f"realized cost {realized_rel} from planned")

    # where the time goes: the spot plan and the replay under the profiler
    for label, fn in (
            ("rolling_profile", lambda: plan(PlanRequest(
                pools=pools, mode="rolling", rolling=rolling, spot=True))),
            ("replay_profile", lambda: replay_spot_plan(
                pools, rep, num_draws=SPOT_REPLAY_DRAWS))):
        out[label] = profiled(fn)[0]
    emit("spot", pools=NUM_POOLS, hours=NUM_HOURS, solver="grid",
         replay=dict(draws=rr.num_draws, wall_s=secs,
                     max_memory_allocated=peak, walk_launches=walk_launches,
                     meets_target=rr.meets_target,
                     min_pool_availability=float(rr.mean_availability.min()),
                     fleet_availability=rr.fleet_availability,
                     planned_cost=rr.planned_cost,
                     realized_cost=rr.realized_cost,
                     realized_vs_planned_rel=realized_rel,
                     realized_spot_cost=rr.realized_spot_cost,
                     fallback_on_demand_cost=rr.fallback_on_demand_cost,
                     requeue_cost=rr.requeue_cost,
                     shortfall_chip_hours=rr.shortfall_chip_hours),
         nvidia_smi=smi(), **out)
    return walk_launches, rep


def phase_migration(grid_rep):
    """The migration and convertible bands (a main path): the turnover
    fleet synthesized on the card through the turnover kernel (launches
    counted from 0 around it), the rolling grid plan and the one-shot plan
    with migration=True and convertible=True, and the migration-blind
    rolling grid plan on the same fleet (sweep launches counted from 0
    around each); then both modes on the 16 pools of MIGRATION_REGIONS,
    card against the CPU.  Returns (turnover launches, sweep launches of
    the aware rolling plan, the turnover fleet, the aware rolling
    report)."""
    from repro_torch.capacity import generations as gn
    from repro_torch.core.api import PlanRequest, RollingConfig, plan
    from repro_torch.core.demand import PoolSet
    from repro_torch.data import traces
    pools, synth_s, turnover_launches, _ = timed(
        lambda: traces.synthetic_pool_set(
            num_pools=NUM_POOLS, num_hours=NUM_HOURS, seed=0,
            migration=True),
        "generation_turnover")
    if turnover_launches != EXPECTED_TURNOVER_LAUNCHES:
        raise AssertionError(
            f"{turnover_launches} turnover launches synthesizing the fleet")
    edges = gn.migration_edges(pools.keys)
    regions = {k[1] for k in pools.keys}
    clouds = sorted({k[0] for k in pools.keys})
    if (edges.num_edges, len(regions), len(clouds)) != (
            NUM_POOLS // 2, NUM_POOLS // 8, 3):
        raise AssertionError(
            f"turnover fleet: {edges.num_edges} edges, {len(regions)} "
            f"regions, clouds {clouds}")
    if not (np.isfinite(pools.demand).all() and (pools.demand >= 0).all()):
        raise AssertionError("turnover fleet: non-finite or negative demand")
    out = dict(fleet=dict(pools=NUM_POOLS, hours=NUM_HOURS,
                          edges=edges.num_edges, regions=len(regions),
                          clouds=clouds, synth_s=synth_s,
                          turnover_launches=turnover_launches))

    rolling = RollingConfig(solver="grid", num_grid=NUM_GRID)
    bands = dict(migration=True, convertible=True)
    rep, secs, launches, peak = timed(lambda: plan(PlanRequest(
        pools=pools, mode="rolling", rolling=rolling, **bands)),
        "commitment_sweep")
    costs = dict(total_cost=rep.total_cost, one_shot_cost=rep.one_shot_cost,
                 hindsight_cost=rep.hindsight_cost,
                 convertible_cost=float(rep.conv_committed_cost.sum()))
    if not all(np.isfinite(v) and v > 0 for v in costs.values()):
        raise AssertionError(f"non-finite or non-positive costs: {costs}")
    if launches != EXPECTED_MIGRATION_LAUNCHES:
        raise AssertionError(f"{launches} sweep launches in the migration "
                             f"plan, expected {EXPECTED_MIGRATION_LAUNCHES}")
    k = len(rep.options)
    for i, w in enumerate(rep.weeks):
        np.testing.assert_allclose(
            rep.ladders.option_widths(int(w) * 168, k), rep.active[i],
            rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(
            rep.conv_ladders.option_widths(int(w) * 168,
                                           len(rep.conv_options)),
            rep.conv_active[i], rtol=1e-4, atol=1e-3)
    out["bill_rel"] = {kk: abs(costs[kk] - v) / v
                       for kk, v in MIGRATION_BILL.items()}
    if max(out["bill_rel"].values()) > BILL_RTOL:
        raise AssertionError(f"the migration plan's bill moved: "
                             f"{out['bill_rel']}")
    out.update(rolling_wall_s=secs, rolling_max_memory_allocated=peak,
               rolling_sweep_launches=launches, rolling=costs,
               convertible_final_width=float(rep.conv_active[-1].sum()))

    one, secs, one_launches, peak = timed(
        lambda: plan(PlanRequest(pools=pools, **bands)), "commitment_sweep")
    one_costs = {kk: getattr(one, kk) for kk in ONE_SHOT_COSTS
                 + ("conv_cost",)}
    if not all(np.isfinite(v) for v in one_costs.values()):
        raise AssertionError(f"non-finite one-shot costs: {one_costs}")
    if one_launches != EXPECTED_ONE_SHOT_LAUNCHES:
        raise AssertionError(f"{one_launches} sweep launches in the "
                             "one-shot migration plan")
    out["one_shot_bill_rel"] = {
        kk: abs(one_costs[kk] - v) / abs(v)
        for kk, v in MIGRATION_ONE_SHOT_BILL.items()}
    if max(out["one_shot_bill_rel"].values()) > BILL_RTOL:
        raise AssertionError(f"the one-shot migration bill moved: "
                             f"{out['one_shot_bill_rel']}")
    out.update(one_shot_wall_s=secs, one_shot_max_memory_allocated=peak,
               one_shot_sweep_launches=one_launches, one_shot=one_costs,
               one_shot_conv_width=float(one.conv_widths.sum()),
               one_shot_conv_alloc=float(one.conv_alloc.sum()))

    blind, secs, blind_launches, peak = timed(lambda: plan(PlanRequest(
        pools=pools, mode="rolling", rolling=rolling)), "commitment_sweep")
    if blind_launches != EXPECTED_LAUNCHES:
        raise AssertionError(f"{blind_launches} sweep launches in the "
                             "blind plan")
    out.update(blind_wall_s=secs, blind_max_memory_allocated=peak,
               blind_sweep_launches=blind_launches,
               blind_total_cost=blind.total_cost,
               aware_vs_blind_margin=1.0 - rep.total_cost / blind.total_cost,
               aware_vs_blind_wall_s=out["rolling_wall_s"] - secs,
               turnover_fleet_vs_grid_fleet_bill=(
                   blind.total_cost / grid_rep.total_cost))

    # the 16 pools of two regions (whole pairs, all three clouds), card
    # against CPU, as shares of the CPU bill
    keep = [i for i, key in enumerate(pools.keys)
            if key[1] in MIGRATION_REGIONS]
    sub = PoolSet(keys=tuple(pools.keys[i] for i in keep),
                  demand=pools.demand[keep],
                  configs=tuple(pools.configs[i] for i in keep))
    card_cpu = {}
    for mode, fields, conv, req in (
            ("rolling", ("total_cost", "one_shot_cost"),
             lambda r: float(r.conv_committed_cost.sum()),
             PlanRequest(pools=sub, mode="rolling", rolling=rolling,
                         **bands)),
            ("one_shot", ("total_cost", "committed_cost", "on_demand_cost"),
             lambda r: r.conv_cost,
             PlanRequest(pools=sub, **bands))):
        cpu, card = plan(req, device="cpu"), plan(req)
        bill = abs(cpu.total_cost)
        rel = {kk: abs(getattr(card, kk) - getattr(cpu, kk)) / bill
               for kk in fields}
        rel["convertible_cost"] = abs(conv(card) - conv(cpu)) / bill
        if max(rel.values()) > CARD_CPU_RTOL:
            raise AssertionError(f"migration {mode} card vs CPU: {rel}")
        card_cpu[mode] = rel
    out["card_vs_cpu_16_rel"] = dict(pools=len(keep), **card_cpu)
    out["planted_one_shot"] = planted_one_shot()
    emit("migration", solver="grid", nvidia_smi=smi(), **out)
    return turnover_launches, launches, pools, rep


def planted_one_shot():
    """The one-shot plan's convertible band where the fleet buys one: the
    planted two-edge table on NUM_POOLS pools over PLANTED_WEEKS, card
    against CPU (costs as shares of the CPU bill, the cloud bands and their
    allocation within the stack tolerance), a nonzero band, and the bill
    within rel 1e-4 of PLANTED_ONE_SHOT_BILL."""
    from repro_torch.capacity import generations as gn
    from repro_torch.capacity import pricing
    from repro_torch.core.api import PlanRequest, plan
    from repro_torch.data import traces
    plant = gn.MigrationConfig(generations=tuple(
        pricing.Generation(*g) for g in PLANTED_GENERATIONS))
    pools = traces.synthetic_pool_set(
        num_pools=NUM_POOLS, num_hours=PLANTED_WEEKS * 168, seed=3,
        migration=plant)
    req = PlanRequest(pools=pools, horizon_weeks=PLANTED_HORIZON_WEEKS,
                      migration=plant, convertible=True)
    cpu, card = plan(req, device="cpu"), plan(req)
    if not card.conv_cost > 0.0:
        raise AssertionError("planted fleet: the one-shot plan bought no "
                             "convertible band")
    bill = abs(cpu.total_cost)
    rel = {k: abs(getattr(card, k) - getattr(cpu, k)) / bill
           for k in ("total_cost", "committed_cost", "on_demand_cost",
                     "conv_cost")}
    if max(rel.values()) > CARD_CPU_RTOL:
        raise AssertionError(f"planted one-shot card vs CPU: {rel}")
    np.testing.assert_allclose(card.conv_widths, cpu.conv_widths,
                               **STACK_TOL)
    np.testing.assert_allclose(card.conv_alloc, cpu.conv_alloc, **STACK_TOL)
    bill_rel = {k: abs(getattr(card, k) - v) / abs(v)
                for k, v in PLANTED_ONE_SHOT_BILL.items()}
    if max(bill_rel.values()) > BILL_RTOL:
        raise AssertionError(f"the planted one-shot bill moved: {bill_rel}")
    return dict(pools=NUM_POOLS, weeks=PLANTED_WEEKS,
                edges=card.migration_edges.num_edges,
                conv_cost=card.conv_cost, total_cost=card.total_cost,
                conv_widths=card.conv_widths.sum(-1).tolist(),
                conv_clouds=list(card.conv_clouds),
                card_vs_cpu_rel=rel, bill_rel=bill_rel)


def bits_equal(name, got, want):
    """Raise unless the arrays hold the same bits (and shape)."""
    a = np.ascontiguousarray(np.asarray(got))
    b = np.ascontiguousarray(np.asarray(want))
    if a.shape != b.shape or a.tobytes() != b.tobytes():
        diff = (np.asarray(a != b).sum() if a.shape == b.shape
                else f"shapes {a.shape} vs {b.shape}")
        raise AssertionError(f"{name}: not bit for bit ({diff} differ)")


def scenario0_equal(label, batch, base, fields):
    """Scenario 0 of a batched report against the unbatched report, bit
    for bit: per-week arrays, weekly costs and the bills."""
    for name in fields:
        bits_equal(f"{label} {name}", getattr(batch, name)[:, 0],
                   getattr(base, name))
    bits_equal(f"{label} weekly_cost", batch.weekly_cost[:, 0],
               base.weekly_cost)
    pairs = [("scenario_cost", "total_cost")]
    if base.one_shot_cost is not None:
        pairs += [("scenario_one_shot_cost", "one_shot_cost"),
                  ("scenario_hindsight_cost", "hindsight_cost")]
        bits_equal(f"{label} hindsight_widths", batch.hindsight_widths[0],
                   base.hindsight_widths)
    for mine, theirs in pairs:
        if float(getattr(batch, mine)[0]) != getattr(base, theirs):
            raise AssertionError(
                f"{label}: {mine}[0] {float(getattr(batch, mine)[0])} != "
                f"{theirs} {getattr(base, theirs)}")
    return True


def perturbations_on_card(pools):
    """Each perturbation's scenario rows built on the card against the
    port's plain numpy rows (the reference's arithmetic) on the host, bit
    for bit: growth on every pool, the others on SCEN_SAMPLED_POOLS."""
    from repro_torch.data import scenarios as sc
    demand = pools.demand[:, :(pools.num_hours // 168) * 168]
    checked = {}
    for family in sc.PERTURBATIONS[1:]:
        cfg = sc.ScenarioConfig(n_scenarios=SCEN_N, family=family)
        rows = (range(NUM_POOLS) if family == "growth"
                else SCEN_SAMPLED_POOLS)
        for s in SCEN_CHECKED:
            card = sc.scenario_block(demand, cfg, s, s + 1)[0]
            got = card[list(rows)].cpu().numpy()
            want = np.stack([
                sc._perturb(family, demand[p], sc._rng(family, 0, s, p))
                for p in rows]).astype(np.float32)
            bits_equal(f"{family} scenario {s}", got, want)
        checked[family] = len(rows) * len(SCEN_CHECKED)
    return checked


def phase_scenarios(pools, grid_rep, plan_s, plan_profile, spot_rep,
                    mig_pools, mig_rep):
    """Scenario batching on the card (a main path, launches counted from 0
    around each plan): the perturbations against their numpy rows; the
    fleet-scale batch (N = 32 growth, quantile) with scenario 0 against the
    unbatched replay; api.plan with the grid solver and N = 32 regime
    futures at phase plan's settings, scenario 0 against phase plan's
    report, 234 sweep launches, wall time, peak memory, device busy under
    the profiler; an N = 8 spot plan against phase spot's report and
    replay_spot_plan of scenario 3; an N = 4 aware plan against phase
    migration's report (468 launches); and on 16 pools over the fleet's
    first 39 weeks N = 4 chunked by 3 against the unchunked run (bits) and
    against the CPU."""
    from repro_torch.capacity.simulator import replay_spot_plan
    from repro_torch.core.api import (
        PlanRequest, RollingConfig, ScenarioConfig, plan)
    from repro_torch.core.demand import PoolSet
    from repro_torch.core.replan import replan_fleet_pools
    from repro_torch.data import scenarios as sc
    t0 = time.perf_counter()
    out = {"perturbed_rows_checked": perturbations_on_card(pools),
           "perturbation_check_s": time.perf_counter() - t0}
    per_week = ("targets", "increments", "active", "committed_cost",
                "on_demand_cost", "utilization")

    # the fleet-scale setting: N = 32 growth futures, quantile solver
    cfg = ScenarioConfig(n_scenarios=SCEN_N, family="growth")
    batch, secs, _, peak = timed(lambda: replan_fleet_pools(
        pools, scenarios=cfg, **SCEN_FLEET_KW), "commitment_sweep")
    single, single_s, _, single_peak = timed(lambda: replan_fleet_pools(
        pools, **SCEN_FLEET_KW), "commitment_sweep")
    scenario0_equal("fleet scale", batch, single, per_week)
    if not np.isfinite(batch.scenario_cost).all():
        raise AssertionError("fleet scale: non-finite scenario costs")
    out["fleet_scale"] = dict(
        scenarios=SCEN_N, family="growth", solver="quantile",
        weeks_replayed=len(batch.weeks), wall_s=secs,
        max_memory_allocated=peak, unbatched_wall_s=single_s,
        unbatched_max_memory_allocated=single_peak,
        scenario0_bit_for_bit=True,
        scenario_cost_mean=float(batch.scenario_cost.mean()),
        scenario_cost_p95=float(np.quantile(batch.scenario_cost, 0.95)))

    # the grid plan at phase plan's settings with N = 32 regime futures
    rolling = RollingConfig(solver="grid", num_grid=NUM_GRID)
    req = PlanRequest(pools=pools, mode="rolling", rolling=rolling,
                      scenarios=ScenarioConfig(n_scenarios=SCEN_N,
                                               family="regime"))
    rep, secs, launches, peak = timed(lambda: plan(req), "commitment_sweep")
    if launches != EXPECTED_LAUNCHES:
        raise AssertionError(f"{launches} sweep launches in the {SCEN_N}-"
                             f"scenario plan, expected {EXPECTED_LAUNCHES}")
    if rep.targets.shape != (len(rep.weeks), SCEN_N, NUM_POOLS,
                             len(rep.options)):
        raise AssertionError(f"scenario targets shape {rep.targets.shape}")
    scenario0_equal("grid plan", rep, grid_rep, per_week)
    cr = rep.scenario_cr
    if not (np.isfinite(cr).all() and (rep.scenario_cost > 0).all()):
        raise AssertionError("grid plan: non-finite scenario ratios")
    summary, _ = profiled(lambda: plan(req))
    out["grid_plan"] = dict(
        scenarios=SCEN_N, family="regime", rows=SCEN_N * NUM_POOLS,
        sweep_rows=SCEN_N * NUM_POOLS * HORIZON_WEEKS, wall_s=secs,
        max_memory_allocated=peak, sweep_launches=launches,
        scenario0_bit_for_bit=True, plan_phase_wall_s=plan_s,
        plan_phase_device_busy_s=plan_profile["device_busy_s"],
        plan_phase_device_busy_share=plan_profile[
            "device_busy_share_of_profiled"],
        profile=summary, summary={
            k: v for k, v in rep.summary().items()
            if k.startswith("scenario_") or k == "total_cost"})

    # N = 8 spot plan; one scenario's Monte-Carlo replay
    req = PlanRequest(pools=pools, mode="rolling", rolling=rolling,
                      spot=True, scenarios=ScenarioConfig(
                          n_scenarios=SCEN_SPOT_N, family="regime"))
    rep, secs, launches, peak = timed(lambda: plan(req), "commitment_sweep")
    if launches != EXPECTED_LAUNCHES:
        raise AssertionError(f"{launches} sweep launches in the spot "
                             "scenario plan")
    scenario0_equal("spot plan", rep, spot_rep,
                    per_week + ("spot_floor", "spot_cost", "spot_volume"))
    rr, replay_s, walk_launches, replay_peak = timed(
        lambda: replay_spot_plan(pools, rep, num_draws=SPOT_REPLAY_DRAWS,
                                 scenario=SCEN_SPOT_REPLAYED),
        "revocation_walk")
    realized_rel = abs(rr.realized_cost - rr.planned_cost) / rr.planned_cost
    if walk_launches != EXPECTED_WALK_LAUNCHES:
        raise AssertionError(f"{walk_launches} walk launches in the replay")
    if rr.planned_cost != float(rep.scenario_cost[SCEN_SPOT_REPLAYED]):
        raise AssertionError("the replay's planned bill is not its "
                             "scenario's")
    if not (rr.meets_target and rr.fleet_availability >= SPOT_TARGET):
        raise AssertionError(
            f"scenario {SCEN_SPOT_REPLAYED} replay misses its target: "
            f"{float(rr.mean_availability.min())}")
    if realized_rel > SPOT_REALIZED_RTOL:
        raise AssertionError(f"scenario replay realized {realized_rel} "
                             "from planned")
    out["spot"] = dict(
        scenarios=SCEN_SPOT_N, wall_s=secs, max_memory_allocated=peak,
        sweep_launches=launches, scenario0_bit_for_bit=True,
        replay=dict(scenario=SCEN_SPOT_REPLAYED, draws=rr.num_draws,
                    wall_s=replay_s, max_memory_allocated=replay_peak,
                    walk_launches=walk_launches,
                    min_pool_availability=float(rr.mean_availability.min()),
                    fleet_availability=rr.fleet_availability,
                    planned_cost=rr.planned_cost,
                    realized_vs_planned_rel=realized_rel))

    # N = 4 aware plan on the turnover fleet
    req = PlanRequest(pools=mig_pools, mode="rolling", rolling=rolling,
                      migration=True, convertible=True,
                      scenarios=ScenarioConfig(n_scenarios=SCEN_AWARE_N,
                                               family="scale"))
    rep, secs, launches, peak = timed(lambda: plan(req), "commitment_sweep")
    if launches != EXPECTED_MIGRATION_LAUNCHES:
        raise AssertionError(f"{launches} sweep launches in the aware "
                             f"scenario plan, expected "
                             f"{EXPECTED_MIGRATION_LAUNCHES}")
    scenario0_equal("aware plan", rep, mig_rep, per_week + (
        "conv_targets", "conv_active", "conv_alloc", "conv_committed_cost"))
    out["aware"] = dict(scenarios=SCEN_AWARE_N, family="scale", wall_s=secs,
                        max_memory_allocated=peak, sweep_launches=launches,
                        scenario0_bit_for_bit=True)

    # 16 pools, N = 4 chunked by 3: against the unchunked run (bits) and
    # the CPU (costs within rel 1e-4, targets within one grid cell)
    sub = PoolSet(keys=pools.keys[:SCEN_CHUNK_POOLS],
                  demand=pools.demand[:SCEN_CHUNK_POOLS,
                                      :SCEN_CHUNK_WEEKS * 168],
                  configs=pools.configs[:SCEN_CHUNK_POOLS])
    kw = dict(solver="grid", num_grid=NUM_GRID, start_weeks=SCEN_CHUNK_START)
    full_cfg = ScenarioConfig(n_scenarios=SCEN_CHUNK_N, family="growth")
    chunk_cfg = ScenarioConfig(n_scenarios=SCEN_CHUNK_N, family="growth",
                               chunk=SCEN_CHUNK)
    chunked = replan_fleet_pools(sub, scenarios=chunk_cfg, **kw)
    full = replan_fleet_pools(sub, scenarios=full_cfg, **kw)
    for name in per_week + ("one_shot_weekly_cost", "hindsight_weekly_cost",
                            "hindsight_widths", "scenario_cost",
                            "scenario_cr", "scenario_one_shot_cost"):
        bits_equal(f"chunked {name}", getattr(chunked, name),
                   getattr(full, name))
    if chunked.total_cost != full.total_cost:
        raise AssertionError("chunked total differs from unchunked")
    t0 = time.perf_counter()
    cpu = replan_fleet_pools(sub, scenarios=chunk_cfg, device="cpu", **kw)
    cpu_s = time.perf_counter() - t0
    cost_rel = float(np.max(np.abs(chunked.scenario_cost - cpu.scenario_cost)
                            / cpu.scenario_cost))
    if cost_rel > 1e-4:
        raise AssertionError(f"chunked card vs CPU scenario costs {cost_rel}")
    t_hist = (sub.num_hours // 168) * 168
    rows = sc.scenario_batch(sub.demand[:, :t_hist], chunk_cfg,
                             device="cpu").reshape(-1, t_hist)
    cells = grid_cells(sub, cpu, NUM_GRID, demand=rows).reshape(
        len(cpu.weeks), SCEN_CHUNK_N, SCEN_CHUNK_POOLS)[..., None]
    diff = np.abs(chunked.targets - cpu.targets)
    if (diff > cells * (1.0 + (NUM_GRID - 1) * 1e-4)).any():
        raise AssertionError("chunked card vs CPU targets differ by more "
                             f"than one cell ({float((diff / cells).max())})")
    out["chunked_16"] = dict(
        pools=SCEN_CHUNK_POOLS, weeks=SCEN_CHUNK_WEEKS,
        start_weeks=SCEN_CHUNK_START, scenarios=SCEN_CHUNK_N,
        chunk=SCEN_CHUNK,
        chunked_equals_unchunked=True, card_vs_cpu_cost_rel=cost_rel,
        card_vs_cpu_max_target_cells=float((diff / cells).max()),
        cpu_wall_s=cpu_s)
    emit("scenarios", pools=NUM_POOLS, hours=NUM_HOURS, nvidia_smi=smi(),
         **out)
    return out["grid_plan"]["sweep_launches"]


def phase_tournament(dev):
    """run_tournament at the reference's defaults on the card (every
    registry policy, 5 families x 32 seeds x 3 pools x 48 weeks, the
    (F*N*P) rows of one replay per policy), against the CPU on the same
    paths (each path's bill within TOURNAMENT_RTOL) and the scan backend
    against the loop backend (TOURNAMENT_LOOP_RTOL)."""
    from repro_torch.capacity import pricing
    from repro_torch.core import forecast as fc
    from repro_torch.core import policy as pol
    from repro_torch.core import portfolio as pf
    from repro_torch.core import tournament as tn
    from repro_torch.data import scenarios as sc
    names = list(pol.POLICIES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = tn.run_tournament(names, device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    paths = np.stack([sc.scenario_paths(f, num_pools=3, num_weeks=48,
                                        num_seeds=32)
                      for f in sc.FAMILIES])
    kw = dict(start_weeks=20, cadence_weeks=2, horizon_weeks=8,
              options=pf.options_from_pricing(),
              od=pricing.on_demand_premium(), cfg=fc.ForecastConfig())
    t0 = time.perf_counter()
    cpu = tn._run_on_paths([pol.get_policy(p) for p in names], sc.FAMILIES,
                           paths, backend="scan", device=torch.device("cpu"),
                           **kw)
    cpu_s = time.perf_counter() - t0
    loop = tn._run_on_paths([pol.get_policy(p) for p in names], sc.FAMILIES,
                            paths, backend="loop", device=dev, **kw)
    rel = {
        "card_vs_cpu": float(np.max(np.abs(card.cost / cpu.cost - 1.0))),
        "card_vs_cpu_hindsight": float(np.max(np.abs(
            card.hindsight_cost / cpu.hindsight_cost - 1.0))),
        "scan_vs_loop": float(np.max(np.abs(card.cost / loop.cost - 1.0))),
    }
    if (max(rel["card_vs_cpu"], rel["card_vs_cpu_hindsight"])
            > TOURNAMENT_RTOL or rel["scan_vs_loop"] > TOURNAMENT_LOOP_RTOL):
        raise AssertionError(f"tournament disagreement: {rel}")
    if not np.isfinite(card.competitive_ratio).all():
        raise AssertionError("tournament: non-finite ratios")
    emit("tournament", policies=names, families=list(sc.FAMILIES),
         seeds=card.num_seeds, pools=3, weeks=48, wall_s=secs,
         cpu_wall_s=cpu_s, rel=rel,
         cr_mean={p: {f: card.family_stats(p, f)["cr_mean"]
                      for f in card.families} for p in card.policies},
         cr_min=float(card.competitive_ratio.min()))


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


def profiled(fn):
    """fn() once under torch.profiler: (summary, kernels), the summary
    the profiled wall seconds, device busy seconds and events and the top
    device kernels (ms, count, name); kernels as device_kernels gives
    them.  CUDA activity only: the host-side op events add nothing to the
    device time and multiply both the profiled wall time and the time to
    process the trace."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    kernels = device_kernels(prof)
    if not kernels:
        raise AssertionError("the profiler recorded no device time")
    busy = sum(k[0] for k in kernels) / 1e6
    return dict(profiled_wall_s=wall, device_busy_s=busy,
                device_events=sum(n for _, n, _ in kernels),
                device_busy_share_of_profiled=busy / wall,
                top_kernels=[[round(us / 1e3, 3), n, key[:80]]
                             for us, n, key in kernels[:8]]), kernels


def phase_profile(pools, rep, plan_s):
    """Where the plan's time goes: the grid plan again under
    torch.profiler (device time by kernel, device busy share), and the
    host-side tranche book timed alone on the plan's own targets."""
    from repro_torch.core import ladder as ld
    from repro_torch.core.api import PlanRequest, RollingConfig, plan
    req = PlanRequest(pools=pools, mode="rolling",
                      rolling=RollingConfig(solver="grid", num_grid=NUM_GRID))
    summary, kernels = profiled(lambda: plan(req))
    prof_s, busy_s = summary["profiled_wall_s"], summary["device_busy_s"]
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
         sweep_device_s=sweep_s, ladder_book_host_s=ladder_s, **summary)
    return summary


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


def walk_inputs(dev, n, p, t, seed, clouds=None):
    """Revocation parameters for ``p`` pools on the synthetic fleet's
    clouds (aws, azure, gcp in turn) and the noise of ``n`` draws over
    ``t`` hours, drawn on the card from a seeded generator."""
    from repro_torch.capacity import preemption as pe
    clouds = clouds or [("aws", "azure", "gcp")[i % 3] for i in range(p)]
    params = pe.params_for_clouds(clouds, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return params, pe.draw_noise(params, t, n, gen)


def phase_walk(dev):
    """The revocation-walk kernel against its plain per-hour loop, both on
    the card: one hour; ragged hours (not a multiple of the kernel's
    unroll) over ragged lanes (not a multiple of its block); every lane
    starting available and every lane starting revoked; hazard 0 with
    recovery 1; the main shape.  States and interruptions bit for bit,
    prices within WALK_PRICE_TOL, and a rerun equal to the first run."""
    from repro_torch.capacity import preemption as pe
    cases = {  # (draws, pools, hours, start, params override)
        "one_hour": (3, 5, 1, None, None),
        "ragged": (3, 37, 1001, None, None),
        "all_available": (2, 70, 333, 1.0, None),
        "all_revoked": (2, 70, 333, 0.0, None),
        "hazard0_recovery1": (4, 33, 200, None, (0.0, 1.0)),
        "main": WALK_MAIN + (None, None),
    }
    errs = {}
    for i, (name, (n, p, t, start, rates)) in enumerate(cases.items()):
        params, (avail0, us, zs) = walk_inputs(dev, n, p, t, 30 + i)
        if start is not None:
            avail0 = torch.full_like(avail0, start)
        if rates is not None:
            params = pe.PreemptionParams(
                torch.full_like(params.hazard, rates[0]),
                torch.full_like(params.recovery, rates[1]),
                params.discount, params.price_band)
        got = pe.revocation_walk(params, avail0, us, zs)
        again = pe.revocation_walk(params, avail0, us, zs)
        want = pe.revocation_walk_loop(params, avail0, us, zs)
        torch.cuda.synchronize()
        for field in ("available", "interrupted", "price"):
            a, b = getattr(got, field), getattr(again, field)
            if not torch.equal(a, b):
                raise AssertionError(f"walk {name}: rerun differs ({field})")
        for field in ("available", "interrupted"):
            if not torch.equal(getattr(got, field), getattr(want, field)):
                raise AssertionError(
                    f"walk {name}: {field} differs from the plain version")
        err = float((got.price - want.price).abs().max())
        if not err <= WALK_PRICE_TOL:
            raise AssertionError(f"walk {name}: price error {err}")
        if rates is not None and not bool(got.available.all()):
            raise AssertionError(f"walk {name}: revoked with hazard 0")
        errs[name] = err
        del got, again, want, avail0, us, zs
    emit("walk", max_abs_price_err=errs, price_tol=WALK_PRICE_TOL,
         states_bit_for_bit=True, rerun_bit_for_bit=True,
         main_shape_n_p_t=list(WALK_MAIN))
    return max(errs.values())


def turnover_args(base, edges):
    """The kernel wrapper's arguments for ``edges`` on base (P, T), with
    the unit table ops builds, so a timed call is the launch alone."""
    from repro_torch.capacity import generations as gn
    from repro_torch.kernels.generation_turnover import ops
    unit_rows, unit_edge = ops.units(base.shape[0], edges.src.tolist(),
                                     edges.dst.tolist(), base.device)
    return (base, unit_rows, unit_edge,
            edges.inv_gain, edges.midpoint_hours, edges.rate_per_hour,
            gn._sw_log(gn.MigrationConfig().software_efficiency_per_year))


def phase_turnover(dev, base):
    """The generation-turnover kernel against its plain version, both on
    the card: one hour; ragged hours over a turnover fleet of 14 pools; a
    fleet with no edges (pure deflation); edges at the first and last
    pool; the main shape, ``base`` (the turnover fleet before turnover),
    with its perf-adjusted volume conserved and a rerun equal to the first
    run; and the kernel against the per-hour loop on the main shape's
    first TURNOVER_LOOP_HOURS.  Bit for bit throughout.  Returns (max abs
    error, timing)."""
    from repro_torch.capacity import generations as gn
    from repro_torch.data import traces
    from repro_torch.kernels.generation_turnover import generation_turnover as gk
    from repro_torch.kernels.generation_turnover.ref import turnover_ref
    cfg = gn.MigrationConfig()
    sw_log = gn._sw_log(cfg.software_efficiency_per_year)

    def fleet_case(pools):
        edges = gn.migration_edges(pools.keys, cfg, device=dev)
        return torch.from_numpy(pools.demand).to(dev), edges

    gen = torch.Generator().manual_seed(50)
    ends = torch.rand(6, 513, generator=gen).mul(200.0).to(dev)
    first_last = (ends, gn.MigrationEdges(
        src=torch.tensor([5], device=dev), dst=torch.tensor([0], device=dev),
        uplift=torch.tensor([0.25], device=dev),
        inv_gain=1.0 / (1.0 + torch.tensor([0.25], device=dev)),
        midpoint_hours=torch.tensor([256.0], device=dev),
        rate_per_hour=torch.tensor([0.02], device=dev)))
    cases = {
        "one_hour": fleet_case(traces.synthetic_base_pool_set(
            num_pools=8, num_hours=1, seed=1)),
        "ragged": fleet_case(traces.synthetic_base_pool_set(
            num_pools=14, num_hours=1001, seed=2)),
        "no_edges": fleet_case(traces.synthetic_pool_set(
            num_pools=5, num_hours=777, seed=3)),
        "first_last": first_last,
        "main": fleet_case(base),
    }
    out = {}
    for name, (b, edges) in cases.items():
        got = gn.migrate_demand(b, edges)
        want = turnover_ref(b, edges.src, edges.dst, edges.inv_gain,
                            edges.midpoint_hours, edges.rate_per_hour,
                            sw_log)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(
                f"turnover {name}: differs from the plain version by "
                f"{float((got - want).abs().max())}")
        out[name] = dict(shape=list(b.shape), edges=edges.num_edges)
    if not torch.equal(cases["no_edges"][0] * torch.exp(
            -sw_log * torch.arange(777, dtype=torch.float32, device=dev)),
            gn.migrate_demand(*cases["no_edges"])):
        raise AssertionError("turnover without edges is not the deflation")

    b, edges = cases["main"]
    got = gn.migrate_demand(b, edges)
    again = gn.migrate_demand(b, edges)
    if not torch.equal(got, again):
        raise AssertionError("turnover main: a rerun differs")
    t = torch.arange(b.shape[1], dtype=torch.float64, device=dev)
    eff = gn.software_deflator(t.float(), cfg.software_efficiency_per_year)
    perf = torch.ones(b.shape[0], dtype=torch.float64, device=dev)
    perf[edges.dst] = 1.0 + edges.uplift.double()
    vol = float(((got.double() / eff.double()) * perf[:, None]).sum())
    vol_rel = abs(vol / float(b.double().sum()) - 1.0)
    if vol_rel > TURNOVER_VOLUME_RTOL:
        raise AssertionError(f"turnover main: volume moved by {vol_rel}")

    hb = b[:, :TURNOVER_LOOP_HOURS].contiguous()
    got = gn.migrate_demand(hb, edges)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loop = gn.migrate_demand_loop(hb, edges)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    if not torch.equal(got, loop):
        raise AssertionError(
            "turnover: kernel differs from the per-hour loop by "
            f"{float((got - loop).abs().max())}")
    del got, again, loop, hb

    name = torch.cuda.get_device_name(0)
    peak = PEAKS["pcie" if "PCIe" in name else "sxm"]
    args = turnover_args(b, edges)
    ms, plain_ms, kern_sets, plain_sets = time_turns(
        lambda: gk.generation_turnover_cuda(*args),
        lambda: turnover_ref(b, edges.src, edges.dst, edges.inv_gain,
                             edges.midpoint_hours, edges.rate_per_hour,
                             sw_log))
    p, t, g = b.shape[0], b.shape[1], edges.num_edges
    # every row read once and written once, and the edges' five columns
    # (src, dst as int32, gain, midpoint, rate); the unit table is the
    # kernel's own layout of src and dst, not more input
    nbytes = 4 * (2 * p * t + 5 * g)
    nops = (TURNOVER_PAIR_OPS * g + (p - 2 * g) + TURNOVER_HOUR_OPS) * t
    ms_bound, by = bound(nops, nbytes, peak["fp32_flops"], peak)
    timing = dict(shape_p_t=[p, t], edges=g, ms=ms, plain_ms=plain_ms,
                  kernel_ms=kern_sets, plain_ms_sets=plain_sets,
                  bound_ms=ms_bound, bound_by=by, bound_bytes=nbytes,
                  bound_ops=nops,
                  share_of_bound=ms_bound / ms,
                  loop_s=loop_s, loop_shape_p_t=[p, TURNOVER_LOOP_HOURS])
    emit("turnover", cases=out, bit_for_bit=True, rerun_bit_for_bit=True,
         loop_bit_for_bit=True, volume_rel=vol_rel, nvidia_smi=smi(),
         **timing)
    return 0.0, timing


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


def timing_walk(dev, peak):
    """The revocation walk and its plain per-hour loop at the main shape
    (one plain run a turn: it is ~20 launches an hour); the bound is the
    larger of its bytes (us and zs read, three outputs written, avail0 and
    the parameters) and its WALK_OPS float32 operations per lane-hour."""
    from repro_torch.capacity import preemption as pe
    n, p, t = WALK_MAIN
    params, (avail0, us, zs) = walk_inputs(dev, n, p, t, 40)
    ms, plain_ms, kern_sets, plain_sets = time_turns(
        lambda: pe.revocation_walk(params, avail0, us, zs),
        lambda: pe.revocation_walk_loop(params, avail0, us, zs),
        plain_reps=1)
    nbytes = 4 * (5 * n * p * t + n * p + 3 * p)
    ms_bound, by = bound(WALK_OPS * n * p * t, nbytes, peak["fp32_flops"],
                         peak)
    return dict(shape_n_p_t=[n, p, t], ms=ms, plain_ms=plain_ms,
                kernel_ms=kern_sets, plain_ms_sets=plain_sets,
                bound_ms=ms_bound, bound_by=by, bound_bytes=nbytes,
                bound_ops=WALK_OPS * n * p * t, share_of_bound=ms_bound / ms)


def sweep_work(w, rows, peak):
    """(operations, bytes, (bound ms, by)) of one sweep over ``rows`` rows
    with weights ``w``: per hour with w != 0 a binary search over G + 1
    buckets and its terms, per output a step of the scan; f, w and the
    candidates read once, over and under written once."""
    nnz_w = float((w != 0).sum())
    ops = (nnz_w * (math.ceil(math.log2(MAIN_G + 1)) + OPS_PER_HOUR)
           + OPS_PER_OUTPUT * rows * MAIN_G)
    nbytes = 4 * (2 * rows * MAIN_T + 3 * rows * MAIN_G)
    return ops, nbytes, bound(ops, nbytes, peak["fp32_flops"], peak), nnz_w


def timing_sweep_scenarios(dev, peak):
    """The sweep at the scenario-batched grid plan's shape, SCEN_N x the
    main shape's rows (the plain version in row chunks, fewer turns).
    The wrapper's output there is held against the plain version's (the
    timed pass's) within the tolerance, against the timed launch's and
    against the bucketed plain version (per block of MAIN_P rows, the
    algebra is per row) bit for bit."""
    from repro_torch.kernels.commitment_sweep import commitment_sweep as ck
    from repro_torch.kernels.commitment_sweep import ops as sweep_ops
    from repro_torch.kernels.commitment_sweep.ref import (
        commitment_sweep_bucketed_ref,
    )
    f, w, cs = main_shape_inputs(dev, pools=NUM_POOLS * SCEN_N)
    rows = f.shape[0]
    last = {}

    def kernel():
        last["kernel"] = ck.commitment_sweep_cuda(f, w, cs)

    def plain():
        last["plain"] = plain_chunked(f, w, cs)

    ms, plain_ms, kern_sets, plain_sets = time_turns(
        kernel, plain, kernel_reps=10, plain_reps=1)
    got = sweep_ops.commitment_sweep_over_under(f, cs, w)
    torch.cuda.synchronize()
    err, rel = compare("scenario_shape", got, last["plain"])
    if not all(torch.equal(a, b) for a, b in zip(got, last["kernel"])):
        raise AssertionError("scenario_shape: the wrapper's sweep != the "
                             "timed launch's bit for bit")
    for i in range(0, rows, MAIN_P):
        want = commitment_sweep_bucketed_ref(
            f[i:i + MAIN_P], w[i:i + MAIN_P], cs[i:i + MAIN_P])
        if not (torch.equal(got[0][i:i + MAIN_P], want[0])
                and torch.equal(got[1][i:i + MAIN_P], want[1])):
            raise AssertionError(
                f"scenario_shape rows {i}..{i + MAIN_P - 1}: kernel != "
                "bucketed plain version bit for bit")
    del last, got, want
    ops, nbytes, (ms_bound, by), _ = sweep_work(w, rows, peak)
    return dict(shape=[rows, MAIN_G, MAIN_T], ms=ms, plain_ms=plain_ms,
                kernel_ms=kern_sets, plain_ms_sets=plain_sets,
                bound_ms=ms_bound, bound_by=by, bound_ops=ops,
                bound_bytes=nbytes, share_of_bound=ms_bound / ms,
                library_ms=None, max_abs_err=err, cost_rel_err=rel,
                equals_bucketed_plain=True)


def phase_timing(dev, launches, errs, turnover):
    from repro_torch.kernels.commitment_sweep import commitment_sweep as ck
    name = torch.cuda.get_device_name(0)
    peak = PEAKS["pcie" if "PCIe" in name else "sxm"]
    f, w, cs = main_shape_inputs(dev)
    ms, plain_ms, kern_sets, plain_sets = time_turns(
        lambda: ck.commitment_sweep_cuda(f, w, cs),
        lambda: plain_chunked(f, w, cs))
    ops, nbytes, sweep_bound, nnz_w = sweep_work(w, MAIN_P, peak)
    # reference figures: the brute force's operations over the hours the
    # masks keep, and over every (row, candidate, hour) triple
    masked_flops = FLOPS_PER_TRIPLE * MAIN_G * nnz_w
    full_flops = FLOPS_PER_TRIPLE * MAIN_P * MAIN_G * MAIN_T
    del f, w, cs
    scen = timing_sweep_scenarios(dev, peak)
    fl = timing_flash(dev, peak)
    lin = timing_linrec(dev, peak)
    walk = timing_walk(dev, peak)
    emit("timing", peak=peak,
         commitment_sweep=dict(
             shape=[MAIN_P, MAIN_G, MAIN_T], kernel_ms=kern_sets,
             plain_ms=plain_sets, bound_ops=ops, bound_bytes=nbytes,
             bound_ms=sweep_bound[0], bound_by=sweep_bound[1],
             share_of_bound=sweep_bound[0] / ms,
             bound_ms_masked_triples=1e3 * masked_flops / peak["fp32_flops"],
             bound_ms_all_triples=1e3 * full_flops / peak["fp32_flops"],
             scenario_shape=scen),
         flash=dict(shapes=dict(
             prefill_tc=f"{FLASH_PREFILL} causal bfloat16",
             simt=f"{FLASH_PREFILL} causal float32",
             simt_d128=f"{FLASH_PREFILL[:3] + (128,)} causal float32",
             decode_split=f"{FLASH_DECODE} cache {SERVE_CACHE} bfloat16"),
             **fl),
         rwkv6=lin, revocation_walk=walk, generation_turnover=turnover)
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
            # with migration=True, convertible=True the grid plan also
            # sweeps the cloud rows (3 clouds x 8 horizons) every week
            "launches_per_migration_plan":
                launches["commitment_sweep_migration"],
            "migration_cloud_rows_shape": [3 * HORIZON_WEEKS, MAIN_G, MAIN_T],
            # with scenarios=ScenarioConfig(32) the same 234 launches
            # carry 32 x the rows; that shape's times and bound
            "launches_per_scenario_plan":
                launches["commitment_sweep_scenarios"],
            "scenario_shape": {key: scen[key] for key in (
                "shape", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "max_abs_err")},
            "max_abs_err": max(errs["commitment_sweep"],
                               scen["max_abs_err"]), "ms": ms,
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
        {
            "name": "revocation_walk", "route": "cuda",
            "source": "src/repro_torch/kernels/revocation_walk/csrc/"
                      "revocation_walk.cu",
            "replaces": "src/repro/capacity/preemption.py:190",
            "replaces_note": "the lax.scan over hours of the revocation "
                             "walk, not a Pallas kernel",
            "launches": launches["revocation_walk"],
            "launches_per_spot_replay": launches["revocation_walk"],
            "max_abs_err": errs["revocation_walk"], "ms": walk["ms"],
            "plain_ms": walk["plain_ms"], "bound_ms": walk["bound_ms"],
            "bound_by": walk["bound_by"], "library_ms": None,
            "library_note": "no single PyTorch call computes the walk",
            "shape": f"N, P, T = {WALK_MAIN} float32",
        },
        {
            "name": "generation_turnover", "route": "cuda",
            "source": "src/repro_torch/kernels/generation_turnover/csrc/"
                      "generation_turnover.cu",
            "replaces": "src/repro/capacity/generations.py:275",
            "replaces_note": "the lax.scan over hours of migrate_demand "
                             "(its step _mig_step at :251), not a Pallas "
                             "kernel",
            "launches": launches["generation_turnover"],
            "launches_per_turnover_fleet": launches["generation_turnover"],
            "max_abs_err": errs["generation_turnover"],
            "ms": turnover["ms"], "plain_ms": turnover["plain_ms"],
            "bound_ms": turnover["bound_ms"],
            "bound_by": turnover["bound_by"], "library_ms": None,
            "library_note": "no single PyTorch call computes the turnover",
            "shape": f"P, T = {tuple(turnover['shape_p_t'])} float32",
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
    errs["revocation_walk"] = phase_walk(dev)
    from repro_torch.data import traces
    errs["generation_turnover"], turnover = phase_turnover(
        dev, traces.synthetic_base_pool_set(
            num_pools=NUM_POOLS, num_hours=NUM_HOURS, seed=0))
    t0 = time.perf_counter()
    pools = traces.synthetic_pool_set(
        num_pools=NUM_POOLS, num_hours=NUM_HOURS, seed=0)
    emit("fleet", pools=NUM_POOLS, hours=NUM_HOURS,
         synth_s=time.perf_counter() - t0)
    phase_cpu(pools)
    grid_rep, sweep_launches, plan_s = phase_plan(pools)
    phase_quantile(pools, grid_rep)
    one_shot_launches = phase_one_shot(pools, dev)
    walk_launches, spot_rep = phase_spot(pools, grid_rep)
    turnover_launches, migration_launches, mig_pools, mig_rep = (
        phase_migration(grid_rep))
    plan_profile = phase_profile(pools, grid_rep, plan_s)
    scenario_launches = phase_scenarios(pools, grid_rep, plan_s,
                                        plan_profile, spot_rep, mig_pools,
                                        mig_rep)
    del pools, grid_rep, spot_rep, mig_pools, mig_rep
    phase_tournament(dev)
    phase_model_cpu(dev)
    launches = {"commitment_sweep": sweep_launches,
                "commitment_sweep_one_shot": one_shot_launches,
                "revocation_walk": walk_launches,
                "generation_turnover": turnover_launches,
                "commitment_sweep_migration": migration_launches,
                "commitment_sweep_scenarios": scenario_launches}
    launches["flash_attention"], dense = phase_serve(
        "serve_dense", "stablelm-1.6b", dev, "flash_attention")
    launches["flash_by_kernel"] = dense["launches"]["flash_by_kernel"]
    launches["rwkv6"], _ = phase_serve(
        "serve_rwkv", "rwkv6-3b", dev, "rwkv6")
    phase_timing(dev, launches, errs, turnover)
    print(smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
