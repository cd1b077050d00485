"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Drives the port's main path, the rolling commitment planner, on the card
and checks its one kernel, the commitment sweep, against the plain PyTorch
version.  Phases, in this order, each printing one JSON line and raising
on failure:

  device    card name and power limit, torch and CUDA versions
  build     nvcc build of the kernel (time, ptxas report)
  kernel    kernel vs plain version on the card: ragged shapes, the
            (T,)/(G,) cases, no weights, prefix masks, the main-path shape
            8192 x 128 x 1344; batched launch == one launch per row block
  ties      the solvers' sorts on tied inputs, card vs CPU bit for bit
  fleet     the 1024-pool, 3-year synthetic fleet (seed 0)
  cpu       its first 16 pools replayed on the CPU (plain version) and on
            the card (kernel): totals, targets, tranche book vs carried
            stack, host syncs of the card replay; the first planner call on
            the card, so the timed plans below find CUDA initialized
  plan      api.plan on the whole fleet with the grid solver: costs, wall
            time, peak memory, sweep launches (the main path)
  quantile  the same fleet with the quantile solver (grid within 2%)
  profile   the grid plan under torch.profiler: device busy time, time by
            kernel (full table in build/chip_smoke/profile_grid_plan.txt), and
            the host-side tranche book timed alone
  timing    kernel and plain-version times at the main-path shape, then
            the kernel line {"kernels": [...]}

The last two lines are the card's name and power limit, then
{"ok": true, "device": {...}}.  Without a CUDA device it exits 1 before any
phase.
"""

from __future__ import annotations

import json
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
PLAIN_CHUNK = 512           # rows per plain-version chunk at the main shape
# Peak rates for the bound (NVIDIA data sheets, dense, at the full power
# limit): FP32 on the CUDA cores and HBM bandwidth.
PEAKS = {
    "sxm": {"fp32_flops": 67e12, "bytes": 3.35e12},
    "pcie": {"fp32_flops": 51e12, "bytes": 2.0e12},
}
FLOPS_PER_TRIPLE = 6        # sub, 2 max, 2 fma (2 flops each) per hour


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


def phase_build():
    from repro_torch.kernels.commitment_sweep import commitment_sweep as ck
    t0 = time.perf_counter()
    lib = ck.build()
    ck.load()
    secs = time.perf_counter() - t0
    log = Path(str(lib) + ".log").read_text()
    ptxas = [ln.strip() for ln in log.splitlines() if "ptxas info" in ln]
    emit("build", seconds=secs, library=str(lib.relative_to(ROOT)),
         ptxas=ptxas)


def phase_kernel(dev):
    from repro_torch.kernels.commitment_sweep import ops
    gen = torch.Generator().manual_seed(1)

    def rnd(*shape, lo=0.0, hi=300.0):
        return (lo + (hi - lo) * torch.rand(*shape, generator=gen)).to(dev)

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

    f, w, cs = main_shape_inputs(dev)
    got = ops.commitment_sweep_over_under(f, cs, w)
    want = plain_chunked(f, w, cs)
    torch.cuda.synchronize()
    err, rel = compare("main_shape", got, want)
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

    # Batched launch == one launch per row block, bit for bit (blocks of
    # 1000 rows do not align with the kernel's 8-row tiles).
    bit_exact = True
    for i in range(0, MAIN_P, 1000):
        o1, u1 = ops.commitment_sweep_over_under(
            f[i:i + 1000], cs[i:i + 1000], w[i:i + 1000]
        )
        bit_exact &= bool(torch.equal(o1, got[0][i:i + 1000]))
        bit_exact &= bool(torch.equal(u1, got[1][i:i + 1000]))
    if not bit_exact:
        raise AssertionError("batched sweep != per-block sweeps bit for bit")
    emit("kernel", ragged={k: {"max_abs_err": v[0], "cost_rel_err": v[1]}
                           for k, v in results.items()},
         main_shape=[MAIN_P, MAIN_G, MAIN_T], max_abs_err=err,
         cost_rel_err=rel, over_rel_err_vs_f64_kernel=kern_rel,
         over_rel_err_vs_f64_plain=plain_rel, batched_equals_blocks=bit_exact)
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
    from repro_torch.kernels.commitment_sweep import commitment_sweep as ck
    req = PlanRequest(pools=pools, mode="rolling",
                      rolling=RollingConfig(solver="grid", num_grid=NUM_GRID))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ck.LAUNCHES = 0
    t0 = time.perf_counter()
    rep = plan(req)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = ck.LAUNCHES
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
    emit("plan", solver="grid", pools=NUM_POOLS, hours=NUM_HOURS,
         weeks_replayed=len(rep.weeks), wall_s=secs,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         sweep_launches=launches, **costs)
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
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            card = replan_fleet_pools(sub, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    card_s = time.perf_counter() - t0
    syncs = sum("synchroniz" in str(w.message) for w in caught)
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
    # Device-side events only (kernels, memcpys, memsets): the aten ops
    # on the host side carry their kernels' time too and would count twice;
    # the profiler's own buffer events are not the plan's work.
    kernels = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        on_device = str(getattr(ev, "device_type", "")).endswith("CUDA")
        if dev_us > 0 and on_device and "Buffer" not in ev.key:
            kernels.append((dev_us, ev.count, ev.key))
    kernels.sort(reverse=True)
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
         device_busy_share_of_profiled=busy_s / prof_s,
         sweep_device_s=sweep_s, ladder_book_host_s=ladder_s,
         top_kernels=[[round(us / 1e3, 3), n, key[:80]]
                      for us, n, key in kernels[:8]])


def median_ms(fn, reps):
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
            enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def phase_timing(dev, launches, max_abs_err):
    from repro_torch.kernels.commitment_sweep import commitment_sweep as ck
    f, w, cs = main_shape_inputs(dev)
    kernel = lambda: ck.commitment_sweep_cuda(f, w, cs)  # noqa: E731
    plain = lambda: plain_chunked(f, w, cs)  # noqa: E731
    for fn in (kernel, plain):
        fn()
    torch.cuda.synchronize()
    # plain, kernel, kernel, plain: both measured in turns on one card
    plain_a = median_ms(plain, 5)
    kern_a = median_ms(kernel, 25)
    kern_b = median_ms(kernel, 25)
    plain_b = median_ms(plain, 5)
    ms, plain_ms = statistics.median([kern_a, kern_b]), (plain_a + plain_b) / 2
    name = torch.cuda.get_device_name(0)
    peak = PEAKS["pcie" if "PCIe" in name else "sxm"]
    nnz_w = float((w != 0).sum())
    flops = FLOPS_PER_TRIPLE * MAIN_G * nnz_w      # work the masks need
    nbytes = 4 * (f.numel() + w.numel() + cs.numel() + 2 * MAIN_P * MAIN_G)
    t_ops, t_bytes = flops / peak["fp32_flops"], nbytes / peak["bytes"]
    bound_ms = 1e3 * max(t_ops, t_bytes)
    full_flops = FLOPS_PER_TRIPLE * MAIN_P * MAIN_G * MAIN_T
    emit("timing", shape=[MAIN_P, MAIN_G, MAIN_T], kernel_ms=[kern_a, kern_b],
         plain_ms=[plain_a, plain_b], bound_flops=flops, bound_bytes=nbytes,
         bound_ms_all_triples=1e3 * full_flops / peak["fp32_flops"],
         peak=peak)
    print(json.dumps({"kernels": [{
        "name": "commitment_sweep", "route": "cuda",
        "source": "src/repro_torch/kernels/commitment_sweep/csrc/"
                  "commitment_sweep.cu",
        "replaces": "src/repro/kernels/commitment_sweep/commitment_sweep.py:64",
        "launches": launches, "launches_per_plan": launches,
        "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None,
    }]}), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    phase_device()
    phase_build()
    max_abs_err = phase_kernel(dev)
    phase_ties(dev)
    from repro_torch.data import traces
    t0 = time.perf_counter()
    pools = traces.synthetic_pool_set(
        num_pools=NUM_POOLS, num_hours=NUM_HOURS, seed=0)
    emit("fleet", pools=NUM_POOLS, hours=NUM_HOURS,
         synth_s=time.perf_counter() - t0)
    phase_cpu(pools)
    grid_rep, launches, plan_s = phase_plan(pools)
    phase_quantile(pools, grid_rep)
    phase_profile(pools, grid_rep, plan_s)
    phase_timing(dev, launches, max_abs_err)
    print(smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
