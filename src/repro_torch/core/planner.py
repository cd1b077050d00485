"""Algorithm 1: Optimal Commitment For Demand Forecast (paper §3.3.3).

Step 1  Fit the forecaster on the hourly training history; forecast ahead.
Step 2  For each weekly horizon w = 1..W, take the forecast prefix X̂_w.
Step 3  Compute the minimal-cost commitment level c_w over each prefix.
Step 4  c* = min_w c_w: commitments can be increased later but never
        reduced, so the safe level to buy now is the minimum over horizons.

:func:`plan_commitment` runs it for one level, :func:`plan_portfolio` for a
stack of purchase options (one threshold per option at its critical
fractile, each option's minimum over the horizons within its term), and
:func:`_plan_fleet_pools_one_shot` for every pool of a fleet at once: one
batched fit, one sort per pool for all horizons x options, and a spend on
the held-out window whose over-integrals are one commitment-sweep launch.
It is the default mode of :func:`repro_torch.core.api.plan`.

The batched helpers take a leading pool axis the reference writes as a
vmap.  Their sorts are stable (``stable=True``), as ``jnp.argsort`` is:
tied forecast hours and the ``inf`` depth of options off the envelope must
keep input order for the thresholds to match.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Literal

import numpy as np
import torch

from repro_torch.capacity import generations as gn
from repro_torch.capacity import pricing
from repro_torch.core import commitment as cm
from repro_torch.core import demand as dm
from repro_torch.core import forecast as fc
from repro_torch.core import ladder as ld
from repro_torch.core import migration as mg
from repro_torch.core import portfolio as pf
from repro_torch.core import spot as spot_mod
from repro_torch.core.demand import HOURS_PER_WEEK
from repro_torch.device import resolve_device

pricing.validate_tables()

#: Keywords whose subsystem the port does not have yet, by ROADMAP item.
UNPORTED_BANDS = {
    "telemetry": "item 14: telemetry emitters",
}


def reject_unported_bands(**kw) -> None:
    """Raise ``NotImplementedError`` naming the ROADMAP item for each
    keyword of :data:`UNPORTED_BANDS` set to anything but None or False."""
    for name, value in kw.items():
        if value is not None and value is not False:
            raise NotImplementedError(
                f"{name}= is not ported yet "
                f"(ROADMAP Queue 1, {UNPORTED_BANDS[name]})"
            )


def _prefix_weighted_quantiles(
    yhat: torch.Tensor, w_hours: torch.Tensor, qs: torch.Tensor
) -> torch.Tensor:
    """Thresholds (P, W, K): for each pool's horizon prefix yhat[p, :w] the
    quantile at each fractile qs[p, k] — one sort for all horizons x
    options.  yhat (P, H), w_hours (W,), qs (P, K)."""
    order = torch.argsort(yhat, dim=-1, stable=True)
    sorted_y = torch.gather(yhat, -1, order)
    valid = (order[:, None, :] < w_hours[None, :, None]).to(yhat.dtype)
    cum = torch.cumsum(valid, dim=-1)                    # (P, W, H)
    frac = cum / torch.clamp(cum[..., -1:], min=1.0)
    num_w = w_hours.shape[0]
    q = qs[:, None, :].expand(-1, num_w, -1).contiguous()
    # frac is nondecreasing along H, so the first index with frac >= q is
    # a left search; "none" (index H) maps to 0 like an argmax of all-False.
    idx = torch.searchsorted(frac, q, side="left")       # (P, W, K)
    idx = torch.where(idx >= yhat.shape[-1], 0, idx)
    return torch.gather(
        sorted_y[:, None, :].expand(-1, num_w, -1), -1, idx
    )


def _prefix_spot_floors(
    yhat: torch.Tensor, w_hours: torch.Tensor, cap: torch.Tensor
) -> torch.Tensor:
    """Spot floor levels (P, W): on each pool's horizon prefix yhat[p, :w],
    the smallest forecast level whose above-floor volume fits the
    chance-constraint cap, sum_t max(yhat_t - floor, 0) <= cap[p] *
    sum_t yhat_t.  One sort per pool for all horizons, as in
    :func:`_prefix_weighted_quantiles`; the floor snaps up to an observed
    level, so the cap is never exceeded.  yhat (P, H), cap (P,)."""
    order = torch.argsort(yhat, dim=-1, stable=True)
    sorted_y = torch.gather(yhat, -1, order)[:, None, :]        # (P, 1, H)
    valid = (order[:, None, :] < w_hours[None, :, None]).to(yhat.dtype)
    v = sorted_y * valid                                         # (P, W, H)
    suf = torch.flip(torch.cumsum(torch.flip(v, [-1]), -1), [-1])
    cnt = torch.flip(torch.cumsum(torch.flip(valid, [-1]), -1), [-1])
    # volume above level sorted_y[i] over the prefix hours, nonincreasing
    # in i: the first index inside the cap is the lowest floor (index 0,
    # as an argmax of all-False, when none is)
    va = (suf - v) - sorted_y * (cnt - valid)
    inside = va <= cap[:, None, None] * suf[..., :1]
    h = yhat.shape[-1]
    idx = torch.where(inside, torch.arange(h, device=yhat.device), h)
    idx = idx.amin(-1)
    idx = torch.where(idx >= h, 0, idx)
    return torch.gather(sorted_y[:, 0], -1, idx)


def _spot_floors(yhat, w_hours, u_env, cap) -> torch.Tensor:
    """Per-horizon spot floors (P, W) on forecasts yhat (P, H): the higher
    of the envelope entry (the u_env-quantile of each prefix; below it a
    commitment prices better than spot) and the chance-constraint volume
    bound; +inf where the cap is 0, so an uneconomic spot market is never
    routed to."""
    env = _prefix_weighted_quantiles(yhat, w_hours, u_env[:, None])[..., 0]
    floors = torch.maximum(env, _prefix_spot_floors(yhat, w_hours, cap))
    return torch.where(cap[:, None] > 0, floors, torch.inf)


def _monotone_stack(
    per_horizon: torch.Tensor,
    qs: torch.Tensor,
    term_weeks: torch.Tensor,
    num_horizons: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Step 4 of Algorithm 1 for each pool's option stack.

    per_horizon (P, W, K) prefix thresholds, qs (P, K) critical fractiles
    -> (widths (P, K), levels (P, K)): each option's min over the horizons
    within its own term, then a running max in envelope-depth order since
    per-option minima over different horizon sets can cross."""
    dev = per_horizon.device
    weeks = torch.arange(1, num_horizons + 1, device=dev)[:, None]  # (W, 1)
    in_term = weeks <= torch.clamp(term_weeks[None, :], min=1)      # (W, K)
    mins = torch.where(in_term, per_horizon, torch.inf).amin(1)      # (P, K)
    on_env = qs > 0

    depth = torch.argsort(
        torch.where(on_env, qs, torch.inf), dim=-1, stable=True
    )
    inv = torch.argsort(depth, dim=-1, stable=True)
    mins_d = torch.gather(torch.where(on_env, mins, 0.0), -1, depth)
    tops_d = torch.cummax(mins_d, dim=-1).values
    prev_d = torch.cat(
        [torch.zeros_like(tops_d[:, :1]), tops_d[:, :-1]], dim=-1
    )
    widths_d = torch.where(
        torch.gather(on_env, -1, depth), tops_d - prev_d, 0.0
    )
    return torch.gather(widths_d, -1, inv), torch.gather(tops_d, -1, inv)


def _to_host(*tensors: torch.Tensor) -> list[np.ndarray]:
    """Float32 numpy copies of same-device tensors through one copy to the
    host (one sync, however many tensors)."""
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
    host = flat.cpu().numpy()
    out, start = [], 0
    for t in tensors:
        out.append(host[start:start + t.numel()].reshape(t.shape))
        start += t.numel()
    return out


@dataclasses.dataclass
class PlanResult:
    commitment: float                   # c* to purchase now
    per_horizon_levels: torch.Tensor    # (W,) c_w for each horizon
    argmin_horizon: int                 # which horizon set the binding level
    forecast: torch.Tensor              # (W*168,) hourly forecast used


def _golden_prefix_levels(yhat, w_hours, a, b) -> torch.Tensor:
    """(W,) golden-section minimizer of C(c) on each prefix yhat[:w]: 60
    iterations with the planner's own 0.381966/0.618034, the bracket the
    prefix's min and max.  Each prefix is a sweep row whose weight row is
    its 0/1 mask, so an iteration's 2 x W costs are one sweep launch."""
    t = torch.arange(yhat.shape[0], device=yhat.device)
    mask = t[None, :] < w_hours[:, None]                      # (W, H)
    rows = yhat.expand(w_hours.shape[0], -1)
    lo = torch.where(mask, rows, torch.inf).amin(-1)
    hi = torch.where(mask, rows, -torch.inf).amax(-1)
    return cm.golden_rows(rows, mask.to(yhat.dtype), lo, hi, a, b,
                          iters=60, fractions=(0.381966, 0.618034))


def plan_commitment(
    history: torch.Tensor,
    *,
    num_horizons: int = 52,
    a: float = cm.DEFAULT_A,
    b: float = cm.DEFAULT_B,
    cfg: fc.ForecastConfig = fc.ForecastConfig(),
    solver: Literal["quantile", "golden"] = "quantile",
) -> PlanResult:
    """Run Algorithm 1 on an hourly demand history (T,), on its device.

    ``solver="quantile"``: each c_w is the exact A/(A+B) quantile of its
    prefix, one shared sort.  ``solver="golden"``: golden section on each
    masked prefix (:func:`_golden_prefix_levels`)."""
    if solver not in ("quantile", "golden"):
        raise ValueError(
            f"unknown solver {solver!r}; known: ('quantile', 'golden')"
        )
    history = torch.as_tensor(history, dtype=torch.float32)
    model = fc.fit(history, cfg)
    yhat = fc.forecast_horizon(                                   # Step 1
        model, history.shape[-1], num_horizons * HOURS_PER_WEEK
    )
    w_hours = torch.arange(                                       # Step 2
        1, num_horizons + 1, device=yhat.device
    ) * HOURS_PER_WEEK
    if solver == "quantile":                                      # Step 3
        q = torch.tensor([[a / (a + b)]], dtype=yhat.dtype, device=yhat.device)
        levels = _prefix_weighted_quantiles(yhat[None], w_hours, q)[0, :, 0]
    else:
        levels = _golden_prefix_levels(yhat, w_hours, a, b)
    return PlanResult(
        commitment=float(levels.min()),                           # Step 4
        per_horizon_levels=levels,
        argmin_horizon=int(torch.argmin(levels)),
        forecast=yhat,
    )


@dataclasses.dataclass
class PortfolioPlanResult:
    """Algorithm 1 generalized to a commitment portfolio (one run per
    option term).  Tensors are aligned with ``options``."""

    options: list[pf.PurchaseOption]
    widths: torch.Tensor               # (K,) band width to purchase now
    levels: torch.Tensor               # (K,) stack tops (envelope-monotone)
    per_horizon_levels: torch.Tensor   # (W, K) per-horizon prefix thresholds
    fractiles: torch.Tensor            # (K,) per-option critical fractiles
    forecast: torch.Tensor             # (W*168,) hourly forecast used


def plan_portfolio(
    history: torch.Tensor,
    options: list[pf.PurchaseOption] | None = None,
    *,
    num_horizons: int = 52,
    od_rate: float = 2.1,
    term_weighting: float = 0.0,
    cfg: fc.ForecastConfig = fc.ForecastConfig(),
    lines: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> PortfolioPlanResult:
    """Algorithm 1 with one horizon sweep per purchasing option, on the
    history's device.

    Steps 1-2 are shared (one forecast, ``num_horizons`` weekly prefixes).
    Step 3 computes each option's threshold on every prefix, a weighted
    quantile at the option's critical fractile.  Step 4 takes each
    option's minimum over the horizons within its own term (a commitment
    cannot be reduced while its term runs) and re-monotonizes the stack.

    ``lines`` overrides the (alphas, betas) cost lines derived from
    ``options``: the hook that prices one pool's wrong-cloud options at
    the on-demand rate."""
    history = torch.as_tensor(history, dtype=torch.float32)
    dev = history.device
    options = options if options is not None else pf.options_from_pricing()
    alphas, betas = (
        (lines[0].to(dev), lines[1].to(dev)) if lines is not None
        else pf.option_lines(options, term_weighting=term_weighting,
                             device=dev)
    )
    qs = pf.handover_fractiles(alphas, betas, od_rate=od_rate)

    model = fc.fit(history, cfg)
    horizon_hours = num_horizons * HOURS_PER_WEEK
    yhat = fc.forecast_horizon(model, history.shape[-1], horizon_hours)
    w_hours = torch.arange(1, num_horizons + 1, device=dev) * HOURS_PER_WEEK

    per_horizon = _prefix_weighted_quantiles(yhat[None], w_hours, qs[None])
    term_weeks = torch.tensor([o.term_weeks for o in options], device=dev)
    widths, levels = _monotone_stack(
        per_horizon, qs[None], term_weeks, num_horizons
    )
    return PortfolioPlanResult(
        options=options,
        widths=widths[0],
        levels=levels[0],
        per_horizon_levels=per_horizon[0],
        fractiles=qs,
        forecast=yhat,
    )


@dataclasses.dataclass
class PoolPlanEntry:
    """One pool's slice of a fleet plan: Algorithm-1 stack + evaluation."""

    key: dm.PoolKey
    widths: np.ndarray            # (K,) band widths, options-aligned
    levels: np.ndarray            # (K,) stack tops
    total_commitment: float       # stack top = on-demand threshold
    spend: pf.PortfolioSpend      # real-dollar eval on the held-out window


@dataclasses.dataclass
class FleetPoolsPlan:
    """Per-pool fleet plan: Algorithm 1 batched over the P pool axis.

    ``pooling_premium`` is sum-of-pool-plan cost over the cost of one plan
    on the pooled (aggregate) trace, minus 1: the pooling benefit an
    aggregate planner overstates, since commitments cannot move across
    clouds and SKUs.  With a spot band, ``spot_lines`` holds the per-pool
    :class:`~repro_torch.core.spot.SpotLines`, ``spot_floor`` (P,) the
    full-window floors and ``spot_cost`` the spot bill, which
    ``total_cost`` includes.  With the migration band, ``migration_edges``
    holds the matched :class:`~repro_torch.capacity.generations.
    MigrationEdges`; with the convertible band, ``conv_options`` the
    cloud-level SKUs, ``conv_clouds`` their cloud axis, ``conv_widths``
    (C, Kc) the bands bought, ``conv_alloc`` (P,) their re-pin onto the
    pools for the window, ``conv_ladders`` the cloud-level book and
    ``conv_cost`` their bill, which ``total_cost`` includes."""

    keys: tuple[dm.PoolKey, ...]
    options: list[pf.PurchaseOption]
    available: np.ndarray             # (P, K) purchasable mask (cloud match)
    widths: np.ndarray                # (P, K) band widths to purchase now
    levels: np.ndarray                # (P, K) stack tops
    fractiles: np.ndarray             # (P, K) per-pool critical fractiles
    per_horizon_levels: np.ndarray    # (P, W, K) prefix thresholds
    forecasts: np.ndarray             # (P, W*168) hourly forecasts
    ladders: ld.PoolLadderBook        # per-pool tranche stacks
    per_pool: list[PoolPlanEntry]
    committed_cost: float
    on_demand_cost: float
    total_cost: float
    all_on_demand_cost: float
    savings_vs_on_demand: float
    aggregate_cost: float             # one plan on the summed fleet trace
    pooling_premium: float
    spot_lines: Any = None
    spot_floor: np.ndarray | None = None
    spot_cost: float = 0.0
    migration_edges: Any = None
    conv_options: list[pf.PurchaseOption] | None = None
    conv_clouds: tuple[str, ...] | None = None
    conv_widths: np.ndarray | None = None
    conv_alloc: np.ndarray | None = None
    conv_ladders: ld.PoolLadderBook | None = None
    conv_cost: float = 0.0

    def commitment(
        self,
        cloud: str | None = None,
        region: str | None = None,
        term_weeks: int | None = None,
    ) -> float:
        """Answer "how much 3y GCP commitment in us-central1": total width
        purchased, filtered by pool cloud/region and option term."""
        total = 0.0
        for p, key in enumerate(self.keys):
            if cloud is not None and key[0] != cloud:
                continue
            if region is not None and key[1] != region:
                continue
            for k, opt in enumerate(self.options):
                if term_weeks is not None and opt.term_weeks != term_weeks:
                    continue
                total += float(self.widths[p, k])
        return total


def plan_fleet_pools(
    pools: dm.PoolSet,
    options: list[pf.PurchaseOption] | None = None,
    *,
    horizon_weeks: int = 8,
    od_rate: float | None = None,
    term_weighting: float = 0.0,
    cfg: fc.ForecastConfig = fc.ForecastConfig(),
    mode: Literal["one_shot", "rolling"] = "one_shot",
    spot=None,
    migration=None,
    convertible=None,
    policy=None,
    telemetry=None,
    device: "torch.device | str | None" = None,
    **rolling_kw,
):
    """The legacy spelling of :func:`repro_torch.core.api.plan`: builds the
    equivalent :class:`~repro_torch.core.api.PlanRequest` and plans it on
    ``device``.  ``mode="one_shot"`` returns a :class:`FleetPoolsPlan`,
    ``mode="rolling"`` a :class:`~repro_torch.core.replan.RollingPlanReport`.
    Loose rolling knobs in ``rolling_kw`` (``cadence_weeks=``,
    ``backend=``, ...) emit a ``DeprecationWarning`` pointing at
    ``RollingConfig``."""
    from repro_torch.core import api

    if mode != "rolling":
        if rolling_kw:
            raise TypeError(
                "unexpected arguments for mode='one_shot': "
                f"{sorted(rolling_kw)}"
            )
        if policy is not None:
            raise TypeError("policy= applies to mode='rolling' only")
        if telemetry is not None:
            raise TypeError("telemetry= applies to mode='rolling' only")
        request = api.PlanRequest(
            pools=pools, options=options, mode="one_shot",
            horizon_weeks=horizon_weeks, od_rate=od_rate,
            term_weighting=term_weighting, forecast=cfg, spot=spot,
            migration=migration, convertible=convertible,
        )
        return api.plan(request, device=device)

    scenarios = rolling_kw.pop("scenarios", None)
    rolling_fields = {f.name for f in dataclasses.fields(api.RollingConfig)}
    unknown = set(rolling_kw) - rolling_fields
    if unknown:
        raise TypeError(
            f"unexpected arguments for mode='rolling': {sorted(unknown)}"
        )
    if rolling_kw:
        warnings.warn(
            "passing rolling-replay knobs as loose keyword arguments "
            f"({sorted(rolling_kw)}) is deprecated; build a "
            "repro_torch.core.api.PlanRequest with "
            "rolling=RollingConfig(...) and call repro_torch.core.api.plan()",
            DeprecationWarning,
            stacklevel=2,
        )
    request = api.PlanRequest(
        pools=pools, options=options, mode="rolling",
        horizon_weeks=horizon_weeks, od_rate=od_rate,
        term_weighting=term_weighting, forecast=cfg, spot=spot,
        migration=migration, convertible=convertible, policy=policy,
        scenarios=scenarios, telemetry=telemetry,
        rolling=api.RollingConfig(**rolling_kw),
    )
    return api.plan(request, device=device)


def _plan_fleet_pools_one_shot(
    pools: dm.PoolSet,
    options: list[pf.PurchaseOption] | None = None,
    *,
    horizon_weeks: int = 8,
    od_rate: float | None = None,
    term_weighting: float = 0.0,
    cfg: fc.ForecastConfig = fc.ForecastConfig(),
    spot=None,
    migration=None,
    convertible=None,
    device: "torch.device | str | None" = None,
) -> FleetPoolsPlan:
    """The one-shot plan behind :func:`repro_torch.core.api.plan`, on
    ``device`` (``None`` = the card).

    The last ``horizon_weeks`` of the trace are held out.  Every pool is
    fit on the rest in one batched pass, forecast over the holdout, and
    given an option stack (Algorithm 1 with per-pool cost lines: options
    off the pool's cloud are priced at the on-demand rate and get zero
    width).  The stacks are billed in real dollars on the holdout, per pool
    and fleet-total, beside one plan on the pooled trace for the
    pooling-premium diagnostic.

    ``spot`` (True or a :class:`~repro_torch.core.spot.SpotConfig`) adds
    the spot band: per-horizon floors (the envelope entry against the
    chance-constraint volume cap) truncate each pool's committed stack,
    and demand above the full-window floor bills at the pool's effective
    spot rate; the aggregate baseline gets the demand-weighted spot line.

    The pools' spend is one commitment-sweep launch over the P rows (with
    spot: the level and the floor of each row), the aggregate's one more;
    the results come to the host in a fixed number of copies, however many
    pools there are.

    ``migration`` (True or a ``generations.MigrationConfig``) fits the
    structural forecaster on turnover-invariant pair totals and recomposes
    per-pool forecasts from total x logistic share (``core.migration``).
    ``convertible`` (True or a list of convertible options) adds the
    cloud-level band: a stack sized on each cloud's total forecast,
    truncated below the pools' pinned stacks, re-pinned onto the pools by
    forecast-peak excess for the window (lifting their billed level), and
    billed at its committed rates over the window."""
    dev = resolve_device(device)
    options = options if options is not None else pf.options_from_pricing()
    od = od_rate if od_rate is not None else pricing.on_demand_premium()
    eval_hours = horizon_weeks * HOURS_PER_WEEK
    if pools.num_hours <= eval_hours:
        raise ValueError(
            f"need > {eval_hours} hours of demand for a {horizon_weeks}-week"
            f" holdout, got {pools.num_hours}"
        )
    demand = torch.as_tensor(pools.demand, dtype=torch.float32).to(dev)
    hist, actual = demand[:, :-eval_hours], demand[:, -eval_hours:]

    al_p, be_p, avail = pf.pool_option_lines(
        options, pools.clouds, term_weighting=term_weighting, od_rate=od,
        device=dev,
    )
    qs = pf.handover_fractiles(al_p, be_p, od_rate=od)            # (P, K)

    # Steps 1-2: one batched fit and forecast over the P axis.  With the
    # migration band the fit runs on pair totals, and per-pool forecasts
    # are recomposed from total x logistic share.
    mig_cfg = gn.resolve_migration(migration)
    edges = (gn.migration_edges(pools.keys, mig_cfg, device=dev)
             if mig_cfg is not None else None)
    use_mig = edges is not None and edges.num_edges > 0
    t_fut = hist.shape[-1] + torch.arange(eval_hours, device=dev)
    if use_mig:
        model = fc.fit_batched(mg.transform_for_fit(hist, edges), cfg)
        sh_a, sh_b = mg.fit_share(hist, edges, t_max=model.t_max,
                                  prior_weight=mig_cfg.share_prior_weight)
        yhat = mg.compose_forecast(
            fc.predict_batched(model, t_fut),
            mg.predict_share(sh_a, sh_b, t_fut, model.t_max), edges)
    else:
        model = fc.fit_batched(hist, cfg)
        yhat = fc.predict_batched(model, t_fut)                   # (P, H)
    w_hours = torch.arange(1, horizon_weeks + 1, device=dev) * HOURS_PER_WEEK

    # Steps 3-4, per-pool fractiles riding along.
    per_horizon = _prefix_weighted_quantiles(yhat, w_hours, qs)   # (P, W, K)

    # Spot band: capacity above each horizon's floor is cheaper to serve
    # from risk-priced preemptible supply than to commit to or buy on
    # demand, so the floors truncate the committed stack.
    sp_res = spot_mod.resolve_spot(spot, pools.clouds, od_rate=od,
                                   device=dev)
    spot_rate = spot_floor = None
    if sp_res is not None:
        s_lines = sp_res[1]
        u_env = spot_mod.spot_entry_fractile(al_p, be_p, s_lines.rate,
                                             od_rate=od)          # (P,)
        floors = _spot_floors(yhat, w_hours, u_env, s_lines.cap)  # (P, W)
        per_horizon = torch.minimum(per_horizon, floors[..., None])
        spot_rate, spot_floor = s_lines.rate, floors[:, -1]

    term_weeks = torch.tensor([o.term_weeks for o in options], device=dev)
    widths, levels = _monotone_stack(
        per_horizon, qs, term_weeks, horizon_weeks
    )                                                             # (P, K)

    conv_opts = pf.resolve_convertible(convertible, pools.clouds)
    conv_alloc = None
    if conv_opts is not None:
        conv_clouds, conv_widths, conv_alloc = _one_shot_convertible(
            conv_opts, pools.clouds, yhat, widths, w_hours, horizon_weeks,
            term_weighting, od)

    spends = pf.portfolio_spends(actual, widths, options, od_rate=od,
                                 spot_rate=spot_rate, spot_floor=spot_floor,
                                 level_offset=conv_alloc)
    host = [widths, levels, qs, per_horizon, yhat]
    if conv_opts is not None:
        host += [conv_widths, conv_alloc]
    widths_np, levels_np, qs_np, per_h_np, yhat_np, *conv_np = _to_host(
        *host)
    conv_cost = 0.0
    if conv_opts is not None:
        conv_widths_np, conv_alloc_np = conv_np
        conv_rates = np.asarray([o.rate for o in conv_opts])
        conv_cost = float((conv_rates * conv_widths_np).sum() * eval_hours)
        conv_ladders = ld.convertible_ladder_book(
            conv_widths_np[:, None, :],
            np.asarray([o.term_weeks * HOURS_PER_WEEK for o in conv_opts]),
            conv_clouds,
        )

    # Per-pool tranche stacks: buy every band now; terms are per-SKU.
    term_hours = np.asarray([o.term_weeks * HOURS_PER_WEEK for o in options])
    ladders = ld.plan_pool_portfolio_purchases(
        widths_np[:, None, :], term_hours, pools.keys
    )
    per_pool = [
        PoolPlanEntry(
            key=key,
            widths=widths_np[p],
            levels=levels_np[p],
            total_commitment=float(widths_np[p].sum()),
            spend=spends[p],
        )
        for p, key in enumerate(pools.keys)
    ]
    committed = sum(float(e.spend.committed.sum()) for e in per_pool)
    on_demand = sum(e.spend.on_demand for e in per_pool)
    spot_cost = sum(e.spend.spot for e in per_pool)
    total = committed + on_demand + spot_cost + conv_cost
    all_od = sum(e.spend.all_on_demand for e in per_pool)
    savings = 1.0 - total / all_od if all_od > 0 else 0.0

    # The aggregate (single-pool) plan the fleet trace used to collapse to:
    # same pipeline, pooled demand, every option purchasable.
    agg_res = plan_portfolio(
        hist.sum(0), options, num_horizons=horizon_weeks, od_rate=od,
        term_weighting=term_weighting, cfg=cfg,
    )
    agg_widths, agg_rate, agg_floor = agg_res.widths, None, None
    if sp_res is not None:
        agg_widths, agg_rate, agg_floor = _aggregate_spot(
            agg_res, hist, s_lines, options, term_weeks, w_hours,
            horizon_weeks, od, term_weighting)
    agg_spend = pf.portfolio_spends(
        actual.sum(0)[None], agg_widths[None], options, od_rate=od,
        spot_rate=agg_rate, spot_floor=agg_floor,
    )[0]

    return FleetPoolsPlan(
        keys=pools.keys,
        options=options,
        available=avail,
        widths=widths_np,
        levels=levels_np,
        fractiles=qs_np,
        per_horizon_levels=per_h_np,
        forecasts=yhat_np,
        ladders=ladders,
        per_pool=per_pool,
        committed_cost=committed,
        on_demand_cost=on_demand,
        total_cost=total,
        all_on_demand_cost=all_od,
        savings_vs_on_demand=savings,
        aggregate_cost=agg_spend.total,
        # An empty holdout window (every pool retired) has no plan to
        # compare against: report a neutral premium instead of dividing by 0.
        pooling_premium=(
            total / agg_spend.total - 1.0 if agg_spend.total > 0 else 0.0
        ),
        spot_lines=s_lines if sp_res is not None else None,
        spot_floor=(None if spot_floor is None
                    else spot_floor.cpu().numpy()),
        spot_cost=spot_cost,
        migration_edges=edges if use_mig else None,
        conv_options=conv_opts,
        conv_clouds=None if conv_opts is None else tuple(conv_clouds),
        conv_widths=None if conv_opts is None else conv_widths_np,
        conv_alloc=None if conv_opts is None else conv_alloc_np,
        conv_ladders=None if conv_opts is None else conv_ladders,
        conv_cost=conv_cost,
    )


def _one_shot_convertible(conv_opts, clouds, yhat, widths, w_hours,
                          horizon_weeks, term_weighting, od):
    """The one-shot plan's convertible band, on the forecasts' device:
    Algorithm 1 on each cloud's total forecast with the convertible lines,
    the stack truncated below the cloud's summed pinned stacks (the band
    convertible buys is safe at cloud level but pinnable to no single
    family), and the width re-pinned onto the pools by their excess of the
    window's forecast *peak* over their own stacks (allocating sunk
    capacity is free, and a mean-based need would leave the diurnal peaks
    on demand).  Returns (clouds, widths (C, Kc), allocation (P,))."""
    conv_clouds, member, _, _, qs_c, conv_terms = pf.convertible_cloud_setup(
        conv_opts, clouds, term_weighting=term_weighting, od_rate=od,
        device=yhat.device)
    pool_top = widths.sum(-1)
    per_h_c = _prefix_weighted_quantiles(member @ yhat, w_hours, qs_c)
    cw, ct = _monotone_stack(per_h_c, qs_c, conv_terms, horizon_weeks)
    conv_widths = pf.truncate_convertible_stack(ct, cw, member @ pool_top)
    excess = torch.clamp(yhat.amax(-1) - pool_top, min=0.0)
    alloc = pf.allocate_convertible(conv_widths.sum(-1), excess, member)
    return conv_clouds, conv_widths, alloc


def _aggregate_spot(agg_res, hist, s_lines, options, term_weeks, w_hours,
                    horizon_weeks, od, term_weighting):
    """The aggregate baseline's spot band, so the pooling premium isolates
    the pooling effect: the demand-weighted mean of the per-pool lines
    (pooled capacity has no single cloud; float64 sums cast to float32),
    floors from the pooled forecast, the committed stack truncated the same
    way.  Returns (widths (K,), rate (1,), floor (1,)); the floor is +inf
    when the pooled cap is 0."""
    dev = hist.device
    share = hist.sum(-1).double()
    share = share / torch.clamp(share.sum(), min=1e-9)
    rate = (s_lines.rate.double() * share).sum().float()
    cap = (s_lines.cap.double() * share).sum().float()
    al, be = pf.option_lines(options, term_weighting=term_weighting,
                             device=dev)
    u_env = spot_mod.spot_entry_fractile(al, be, rate, od_rate=od)
    floors = _spot_floors(agg_res.forecast[None], w_hours, u_env[None],
                          cap[None])[0]                           # (W,)
    per_h = torch.minimum(agg_res.per_horizon_levels, floors[:, None])
    widths, _ = _monotone_stack(per_h[None], agg_res.fractiles[None],
                                term_weeks, horizon_weeks)
    # With cap 0 the floors are +inf and leave the stack as it was.
    return widths[0], rate[None], floors[-1:]


def compare_horizons(
    yhat: torch.Tensor,
    horizons_weeks: tuple[int, ...] = (1, 2),
    a: float = cm.DEFAULT_A,
    b: float = cm.DEFAULT_B,
    eval_weeks: int | None = None,
) -> dict:
    """Paper Fig 8: the commitment from a w1-week horizon vs a w2-week
    horizon, both applied over the longer evaluation window and costed by
    Eq. (1), as the figure's caption does (C(c_w1, X̂_w2) vs
    C(c_w2, X̂_w2)).  The longer horizon sees the upcoming demand drop, so
    its level is lower and cheaper."""
    eval_weeks = eval_weeks or max(horizons_weeks)
    eval_slice = yhat[: eval_weeks * HOURS_PER_WEEK]
    out = {}
    for w in horizons_weeks:
        prefix = yhat[: w * HOURS_PER_WEEK]
        c_w = float(cm.optimal_commitment_quantile(prefix, a, b))
        spend = float(cm.commitment_cost(eval_slice, c_w, a, b))
        out[w] = {"level": c_w, "total_spend": spend}
    return out
