"""Fleet simulator: turns training jobs and serving fleets into per-pool
chip demand, then runs the paper's planning pipeline against it.

The serving fleets report chips per replica times autoscaled replica
counts, the training jobs blocks of chips over windows of hours; the
simulator rolls them into hourly chip demand per (cloud, region,
machine-family) pool (:func:`fleet_pool_demand`), and the planners
(``core.planner``, ``core.replan``) price commitments for the fleet:
one level or a Table-2 portfolio on the fleet total (:func:`plan_fleet`,
:func:`plan_fleet_portfolio`, with §4's time shifting), or per pool
(:func:`simulate_and_plan_pools`, :func:`simulate_and_replan_pools`).

A spot-enabled rolling plan is replayed against sampled revocation paths
by :func:`replay_spot_plan`, on the device the plan ran on, for any
scenario of a scenario-batched plan.

Request traces come from ``torch.Generator`` seeded ``seed + i`` for
fleet i, so they are not the reference's ``jax.random`` draws; given the
same traces, the private ``_pools_from_requests`` attributes them to
pools with the reference's float32 operations, bit for bit.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict

import numpy as np
import torch

from repro_torch import configs
from repro_torch.capacity import generations as gn
from repro_torch.capacity import preemption as pe
from repro_torch.capacity import pricing
from repro_torch.capacity.pricing import on_demand_premium
from repro_torch.core import demand as dm
from repro_torch.core import planner as pl
from repro_torch.core import portfolio as pf
from repro_torch.core import timeshift as ts
from repro_torch.data import scenarios as sc
from repro_torch.device import resolve_device
from repro_torch.models.model import num_params

pricing.validate_tables()


@dataclasses.dataclass(frozen=True)
class ServingFleet:
    """A served architecture: replicas autoscale with request demand.

    ``pool`` pins the fleet's chips to one (cloud, region, machine-family)
    pool, the granularity commitments are bought at (§6).  None falls back
    to a deterministic slot in the default pool catalog."""

    arch: str
    chips_per_replica: int
    tokens_per_sec_per_replica: float
    base_requests_per_hour: float
    demand_cfg: dm.DemandConfig = dataclasses.field(
        default_factory=lambda: dm.DemandConfig(base_level=1.0)
    )
    pool: dm.PoolKey | None = None


@dataclasses.dataclass(frozen=True)
class TrainingJob:
    """A scheduled training run: a block of chips for a window of hours."""

    arch: str
    chips: int
    start_hour: int
    duration_hours: int
    deferrable: bool = False
    deadline_slack_hours: int = 0
    pool: dm.PoolKey | None = None


def default_pool_catalog() -> list[dm.PoolKey]:
    """12 (cloud, region, machine-family) pools drawn from the Table-2 SKUs,
    the pool granularity the released dataset keys demand by."""
    regions = ["region_0", "region_1", "region_2", "region_3"]
    plans = list(pricing.SAVINGS_PLANS)
    catalog = [
        (p.cloud, regions[i % len(regions)], p.family)
        for i, p in enumerate(plans)
    ]
    catalog += [
        (p.cloud, regions[(i + 1) % len(regions)], p.family)
        for i, p in enumerate(plans[:4])
    ]
    return catalog


def default_fleet() -> tuple[list[ServingFleet], list[TrainingJob]]:
    """A fleet spanning the registry's ten architectures: chips per replica
    scale with the parameter count (bf16 weights plus KV or state under
    ~12 GB per chip), counted from each family's shape table
    (:func:`repro_torch.models.model.num_params`).  Every fleet and job is
    pinned to a pool of the default catalog."""
    catalog = default_pool_catalog()
    fleets = []
    for i, arch in enumerate(sorted(configs.ARCHS)):
        n = num_params(configs.get(arch))
        chips = max(1, int(np.ceil(n * 2 / (12 * 1024**3))))
        fleets.append(ServingFleet(
            arch=arch,
            chips_per_replica=chips,
            tokens_per_sec_per_replica=5e4 / chips,
            base_requests_per_hour=50.0 * chips,
            pool=catalog[i % len(catalog)],
        ))
    jobs = [
        TrainingJob("stablelm-1.6b", chips=64, start_hour=24 * 7,
                    duration_hours=24 * 5, pool=catalog[10]),
        TrainingJob("internlm2-20b", chips=256, start_hour=24 * 30,
                    duration_hours=24 * 14, pool=catalog[11]),
        TrainingJob("jamba-v0.1-52b", chips=512, start_hour=24 * 60,
                    duration_hours=24 * 21, pool=catalog[6]),
    ]
    return fleets, jobs


def _pools_from_requests(
    fleets: list[ServingFleet],
    jobs: list[TrainingJob],
    requests,
    num_hours: int,
    *,
    migration: "gn.MigrationConfig | bool | None" = None,
    device: "torch.device | str | None" = None,
) -> dm.PoolSet:
    """Hourly chip demand per pool from the fleets' request traces
    ``requests`` (one (T,) trace per fleet), in host numpy with the reference's float32
    operations: each trace is scaled to its fleet's base rate, served by
    ceil(rate / 50) replicas of ``chips_per_replica`` chips, and lands in
    its fleet's pool; each job adds its chips over its window.  Unpinned
    members fall back to a deterministic catalog slot.

    ``migration`` runs the attributed demand through the generation
    turnover model (``capacity.generations.migrate_pool_set``, on
    ``device``: one turnover launch on the card)."""
    catalog = default_pool_catalog()
    per_pool: dict[dm.PoolKey, np.ndarray] = defaultdict(
        lambda: np.zeros(num_hours, np.float64)
    )
    for i, fl in enumerate(fleets):
        req = np.asarray(requests[i], np.float32)
        req = req / req.mean() * fl.base_requests_per_hour
        # replicas needed to serve the request rate (ceil'd, autoscaled)
        replicas = np.ceil(req / 50.0)
        key = fl.pool if fl.pool is not None else catalog[i % len(catalog)]
        per_pool[tuple(key)] += replicas * fl.chips_per_replica
    for j, job in enumerate(jobs):
        lo = min(job.start_hour, num_hours)
        hi = min(job.start_hour + job.duration_hours, num_hours)
        key = job.pool if job.pool is not None else catalog[j % len(catalog)]
        per_pool[tuple(key)][lo:hi] += job.chips
    pools = dm.PoolSet.from_dict(dict(per_pool))
    mig = gn.resolve_migration(migration)
    if mig is not None:
        pools = gn.migrate_pool_set(pools, mig, device=device)
    return pools


def fleet_pool_demand(
    fleets: list[ServingFleet],
    jobs: list[TrainingJob],
    num_hours: int,
    *,
    seed: int = 0,
    migration: "gn.MigrationConfig | bool | None" = None,
    device: "torch.device | str | None" = None,
) -> dm.PoolSet:
    """Hourly chip demand of the fleet, attributed per pool.

    Fleet i's request trace is ``dm.synth_demand`` under a
    ``torch.Generator`` seeded ``seed + i``;
    ``_pools_from_requests`` turns the traces into pools and, with
    ``migration``, runs them through the turnover model on ``device``."""
    requests = [
        dm.synth_demand(num_hours, fl.demand_cfg,
                        generator=torch.Generator().manual_seed(seed + i)
                        ).numpy()
        for i, fl in enumerate(fleets)
    ]
    return _pools_from_requests(fleets, jobs, requests, num_hours,
                                     migration=migration, device=device)


def fleet_chip_demand(
    fleets: list[ServingFleet],
    jobs: list[TrainingJob],
    num_hours: int,
    *,
    seed: int = 0,
) -> np.ndarray:
    """Hourly total chip demand of the fleet: the per-pool demand summed
    over pools (the aggregate view of single-level planning)."""
    return fleet_pool_demand(
        fleets, jobs, num_hours, seed=seed
    ).aggregate().astype(np.float64)


@dataclasses.dataclass
class FleetPlan:
    commitment: float
    on_demand_chip_hours: float
    unused_chip_hours: float
    committed_cost: float
    on_demand_cost: float
    total_cost: float
    all_on_demand_cost: float
    savings_vs_on_demand: float


def _split(demand: np.ndarray, horizon_weeks: int, dev):
    """(history, held-out window) float32 tensors on ``dev``."""
    cut = horizon_weeks * dm.HOURS_PER_WEEK
    d = torch.from_numpy(np.asarray(demand, np.float32)).to(dev)
    return d[:-cut], d[-cut:]


def plan_fleet(
    demand: np.ndarray,
    *,
    horizon_weeks: int = 8,
    shiftable_frac: float = 0.0,
    device: "torch.device | str | None" = None,
) -> FleetPlan:
    """Algorithm 1 on the fleet's total demand (T,), on ``device``: fit on
    all but the last ``horizon_weeks``, buy one commitment level, bill the
    held-out weeks; with ``shiftable_frac`` > 0 that fraction of the demand
    above the level is first time-shifted into the troughs (§4,
    :func:`repro_torch.core.timeshift.shift_demand`), the full paper
    pipeline.  :func:`plan_fleet_portfolio` buys a stack of Table-2
    purchase options instead of the single level."""
    hist, actual = _split(demand, horizon_weeks, resolve_device(device))
    c = pl.plan_commitment(hist, num_horizons=horizon_weeks).commitment
    if shiftable_frac > 0:
        actual = ts.shift_demand(actual, c, shiftable_frac)

    premium = on_demand_premium()
    over, under, volume = torch.stack([
        torch.clamp(actual - c, min=0.0).sum(),
        torch.clamp(c - actual, min=0.0).sum(),
        actual.sum(),
    ]).cpu().tolist()
    committed_cost = c * actual.shape[0]   # committed rate = 1.0/chip-hour
    od_cost = premium * over
    all_od = premium * volume
    total = committed_cost + od_cost
    return FleetPlan(
        commitment=float(c),
        on_demand_chip_hours=over,
        unused_chip_hours=under,
        committed_cost=committed_cost,
        on_demand_cost=od_cost,
        total_cost=total,
        all_on_demand_cost=all_od,
        savings_vs_on_demand=1.0 - total / all_od,
    )


@dataclasses.dataclass
class PortfolioFleetPlan:
    """Fleet plan built from a stack of Table-2 purchasing options."""

    options: list[pf.PurchaseOption]
    widths: np.ndarray                  # (K,) committed band widths
    total_commitment: float             # stack top
    breakdown: dict[str, float]         # per-option committed spend (nonzero)
    committed_cost: float
    on_demand_cost: float
    total_cost: float
    all_on_demand_cost: float
    savings_vs_on_demand: float
    single_level_cost: float            # the single-level plan, same trace
    savings_vs_single_level: float


def plan_fleet_portfolio(
    demand: np.ndarray,
    *,
    horizon_weeks: int = 8,
    shiftable_frac: float = 0.0,
    options: list[pf.PurchaseOption] | None = None,
    term_weighting: float = 0.0,
    device: "torch.device | str | None" = None,
) -> PortfolioFleetPlan:
    """The §3 pipeline with the Table-2 purchase portfolio instead of one
    averaged level, on ``device``: Algorithm 1 per option term, the stack
    billed per option at its own committed rate (one sweep launch on the
    card), beside all-on-demand and the single-level :func:`plan_fleet`
    on the same trace.

    Rates are normalized so the mean 3y committed rate is 1.0, the units
    of :func:`plan_fleet`, so ``savings_vs_single_level`` speaks of mixing
    SKUs, not of units."""
    options = options if options is not None else pf.options_from_pricing()
    premium = on_demand_premium()
    dev = resolve_device(device)
    hist, actual = _split(demand, horizon_weeks, dev)
    res = pl.plan_portfolio(
        hist, options, num_horizons=horizon_weeks,
        od_rate=premium, term_weighting=term_weighting,
    )
    widths = res.widths.cpu().numpy()
    single = plan_fleet(
        demand, horizon_weeks=horizon_weeks, shiftable_frac=shiftable_frac,
        device=dev,
    )
    if shiftable_frac > 0:
        actual = ts.shift_demand(actual, float(widths.sum()), shiftable_frac)

    spend = pf.portfolio_spend(actual, widths, options, od_rate=premium)
    breakdown = {
        o.name: float(c)
        for o, c in zip(options, spend.committed) if c > 0
    }
    return PortfolioFleetPlan(
        options=options,
        widths=widths,
        total_commitment=float(widths.sum()),
        breakdown=breakdown,
        committed_cost=float(spend.committed.sum()),
        on_demand_cost=spend.on_demand,
        total_cost=spend.total,
        all_on_demand_cost=spend.all_on_demand,
        savings_vs_on_demand=spend.savings_vs_on_demand,
        single_level_cost=single.total_cost,
        savings_vs_single_level=1.0 - spend.total / single.total_cost,
    )


def simulate_and_plan_pools(
    fleets: list[ServingFleet] | None = None,
    jobs: list[TrainingJob] | None = None,
    *,
    num_hours: int = 24 * 7 * 40,
    horizon_weeks: int = 8,
    seed: int = 0,
    demand_migration: "gn.MigrationConfig | bool | None" = None,
    device: "torch.device | str | None" = None,
    **plan_kw,
) -> tuple[dm.PoolSet, pl.FleetPoolsPlan]:
    """One call per-pool pipeline on ``device``: attribute the (default)
    fleet's demand to its pools, then run the batched Algorithm-1
    portfolio planner over the pool axis.  Returns the PoolSet beside the
    plan.

    ``demand_migration`` is the generative turnover switch (demand volume
    moves between families); pass ``migration=`` in ``plan_kw`` to make
    the planner migration-aware as well."""
    if fleets is None or jobs is None:
        d_fleets, d_jobs = default_fleet()
        fleets = d_fleets if fleets is None else fleets
        jobs = d_jobs if jobs is None else jobs
    pools = fleet_pool_demand(
        fleets, jobs, num_hours, seed=seed, migration=demand_migration,
        device=device,
    )
    return pools, pl.plan_fleet_pools(
        pools, horizon_weeks=horizon_weeks, device=device, **plan_kw
    )


def simulate_and_replan_pools(
    fleets: list[ServingFleet] | None = None,
    jobs: list[TrainingJob] | None = None,
    *,
    num_hours: int = 24 * 7 * 60,
    cadence_weeks: int = 1,
    horizon_weeks: int = 8,
    seed: int = 0,
    device: "torch.device | str | None" = None,
    **replan_kw,
):
    """The rolling counterpart of :func:`simulate_and_plan_pools`: replay
    the weekly re-planning loop over the whole simulated window.  Returns
    ``(PoolSet, repro_torch.core.replan.RollingPlanReport)``, with the
    one-shot and hindsight baselines of the same window.  ``cadence_weeks``
    and any rolling knob in ``replan_kw`` go to ``plan_fleet_pools`` as
    loose keywords, as in the reference (a ``DeprecationWarning``).  Pass
    ``spot=...`` for the preemptible band, then hand the report to
    :func:`replay_spot_plan`."""
    return simulate_and_plan_pools(
        fleets, jobs, num_hours=num_hours, horizon_weeks=horizon_weeks,
        seed=seed, mode="rolling", cadence_weeks=cadence_weeks,
        device=device, **replan_kw,
    )


@dataclasses.dataclass
class SpotReplayReport:
    """A spot-enabled plan replayed against sampled revocation paths.

    For ``num_draws`` Monte-Carlo revocation paths, demand routed above the
    spot floor is billed at the market spot price while the slice is up,
    falls back to on-demand while it is revoked, and pays the requeue
    penalty on every revocation of a serving slice.  ``availability`` is
    demand-weighted: 1 - (spot demand-hours caught by a revoked slice) /
    (all demand-hours), the quantity the chance constraint promises stays
    >= the target.  Host numpy and floats."""

    num_draws: int
    availability_target: float
    availability: np.ndarray        # (N, P) realized per draw per pool
    mean_availability: np.ndarray   # (P,) mean over draws
    fleet_availability: float       # demand-weighted, mean over draws
    meets_target: bool              # min over pools of mean availability
    shortfall_chip_hours: float     # mean over draws, fleet total
    planned_cost: float             # the plan's expected-rate bill
    realized_cost: float            # mean over draws
    realized_spot_cost: float       # market-price spot bill, mean
    fallback_on_demand_cost: float  # revoked-hours od fallback, mean
    requeue_cost: float             # recompute penalty, mean


def replay_spot_plan(
    pools: dm.PoolSet,
    report,
    *,
    num_draws: int = 32,
    seed: int = 0,
    scenario: int = 0,
) -> SpotReplayReport:
    """Replay a spot-enabled rolling plan against sampled revocation paths.

    ``report`` is a :class:`repro_torch.core.replan.RollingPlanReport`
    made with ``spot=...`` on the same ``pools``.  On the device of the
    report's spot lines (where the plan ran): the weekly spot floors are
    broadcast to hours, ``num_draws`` revocation paths are walked from a
    generator seeded ``seed`` (one kernel launch on the card), and the
    realized three-way bill is summed per draw.  Nothing of the (N, P, T)
    paths comes to the host.

    On a scenario-batched report ``scenario`` selects the demand future
    to replay: its floors and costs are sliced off the report's N axis
    (the spot lines are the same for every scenario), and for ``scenario > 0`` that scenario's demand
    alone is rebuilt from the report's ``scenario_config`` (scenarios are
    pure functions of the realized trace and the config, so these are the
    rows the replay billed).  Scenario 0, the realized trace, is the
    default and the only index of an unbatched report."""
    cfg = report.spot_config
    demand, spot_dem, lines, base, planned = _scenario_inputs(
        pools, report, scenario)
    gen = torch.Generator(device=demand.device)
    gen.manual_seed(seed)
    paths = pe.simulate_revocations(lines.params, demand.shape[1],
                                    num_draws=num_draws, generator=gen)
    return _bill_paths(paths, demand, spot_dem, lines.market_rate,
                       cfg.requeue_hours, cfg.availability_target, base,
                       planned)


def _scenario_inputs(pools, report, scenario):
    """(demand, spot demand, spot lines, path-independent bill, planned
    bill) of one scenario of ``report``, on the device of its spot lines:
    the demand and spot demand (P, T) of the replayed weeks, the report's
    (P,) spot lines (every scenario's), and the committed, mid-band
    on-demand and convertible bill read off the report."""
    if report.spot_floor is None:
        raise ValueError("report has no spot band; re-plan with spot=...")
    batched = np.asarray(report.spot_floor).ndim == 3      # (S, N, P)
    n_scen = report.n_scenarios if batched else 1
    if not 0 <= scenario < n_scen:
        raise ValueError(
            f"scenario index {scenario} out of range for a report with "
            f"{n_scen} scenario(s)"
        )

    def pick(a):
        a = np.asarray(a)
        return a[:, scenario] if batched else a

    floors = pick(report.spot_floor)
    lines = report.spot_lines
    dev = lines.rate.device
    wk = dm.HOURS_PER_WEEK
    if scenario == 0:
        demand = pools.demand
    else:
        t_hist = (pools.num_hours // wk) * wk
        demand = sc.scenario_block(
            pools.demand[:, :t_hist], report.scenario_config, scenario,
            scenario + 1, device=dev)[0]
    demand, spot_dem = _spot_demand(demand, floors, report.start_weeks, dev)
    base = float(pick(report.committed_cost).sum()
                 + pick(report.on_demand_cost).sum())
    if report.conv_committed_cost is not None:
        base += float(pick(report.conv_committed_cost).sum())
    planned = (float(report.scenario_cost[scenario]) if batched
               else report.total_cost)
    return demand, spot_dem, lines, base, planned


def _spot_demand(demand, spot_floor, start_weeks, device):
    """(demand, spot demand), (P, T) float32 on ``device``: the replayed
    weeks' hourly demand from ``start_weeks`` on (``demand`` host numpy or
    a tensor, whole hours from 0), and what of it lies above the week's
    spot floor ``spot_floor`` (S, P), broadcast to its hours."""
    wk = dm.HOURS_PER_WEEK
    floor = torch.from_numpy(np.array(spot_floor, np.float32)).to(device)
    s = floor.shape[0]
    t0 = start_weeks * wk
    if not isinstance(demand, torch.Tensor):
        demand = torch.from_numpy(np.ascontiguousarray(
            np.asarray(demand, np.float32)[:, t0:t0 + s * wk]))
    else:
        demand = demand[:, t0:t0 + s * wk]
    demand = demand.to(device=device, dtype=torch.float32).contiguous()
    spot_dem = torch.clamp(
        demand - floor.T.repeat_interleave(wk, dim=1), min=0.0)
    return demand, spot_dem


def _bill_paths(paths, demand, spot_dem, market_rate, requeue_hours,
                target, base, planned) -> SpotReplayReport:
    """The realized bill of spot demand ``spot_dem`` (P, T) on ``paths``:
    served hours at the market price, revoked hours at on-demand, and the
    requeue penalty; ``base`` is the path-independent rest of the bill."""
    up = paths.available                                  # (N, P, T)
    served = spot_dem[None] * up
    fallback = spot_dem[None] * (1.0 - up)
    od = on_demand_premium()
    market = market_rate[None, :, None]
    spot_bill = (market * paths.price * served).sum(-1)   # (N, P)
    fallback_sum = fallback.sum(-1)                       # (N, P)
    fallback_bill = od * fallback_sum
    requeue_bill = od * pe.requeue_cost_hours(paths, spot_dem,
                                              requeue_hours)
    total_dem = torch.clamp(demand.sum(-1), min=1e-9)     # (P,)
    avail = 1.0 - fallback_sum / total_dem
    fleet_avail = 1.0 - fallback_sum.sum(-1).mean() / total_dem.sum()
    draw_bill = (spot_bill + fallback_bill + requeue_bill).sum(-1)
    host = torch.cat([
        avail.reshape(-1),
        torch.stack([fleet_avail, fallback_sum.sum(-1).mean(),
                     draw_bill.mean(), spot_bill.sum(-1).mean(),
                     fallback_bill.sum(-1).mean(),
                     requeue_bill.sum(-1).mean()]),
    ]).cpu().numpy()
    n = avail.numel()
    avail_np = host[:n].reshape(avail.shape)
    (fleet, shortfall, realized, spot_cost, fallback_cost,
     requeue_cost) = (float(x) for x in host[n:])
    mean_avail = avail_np.mean(0)
    return SpotReplayReport(
        num_draws=int(up.shape[0]),
        availability_target=target,
        availability=avail_np,
        mean_availability=mean_avail,
        fleet_availability=fleet,
        meets_target=bool(mean_avail.min() >= target),
        shortfall_chip_hours=shortfall,
        planned_cost=planned,
        realized_cost=base + realized,
        realized_spot_cost=spot_cost,
        fallback_on_demand_cost=fallback_cost,
        requeue_cost=requeue_cost,
    )
