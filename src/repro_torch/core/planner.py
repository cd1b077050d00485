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

from repro_torch.capacity import pricing
from repro_torch.core import commitment as cm
from repro_torch.core import demand as dm
from repro_torch.core import forecast as fc
from repro_torch.core import ladder as ld
from repro_torch.core import portfolio as pf
from repro_torch.core.demand import HOURS_PER_WEEK
from repro_torch.device import resolve_device

pricing.validate_tables()

#: Keywords whose subsystem the port does not have yet, by ROADMAP item.
UNPORTED_BANDS = {
    "spot": "item 10: spot band",
    "migration": "item 11: generation turnover and convertibles",
    "convertible": "item 11: generation turnover and convertibles",
    "scenarios": "item 12: scenario batching",
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
    clouds and SKUs.  The spot, migration and convertible fields keep the
    reference's layout and stay None or 0.0 until those bands are ported
    (ROADMAP Queue 1, items 10 and 11)."""

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

    The pools' spend is one commitment-sweep launch over the P rows, the
    aggregate's one more; the results come to the host in a fixed number
    of copies, however many pools there are.  ``spot``, ``migration`` and
    ``convertible`` raise ``NotImplementedError`` naming their ROADMAP
    item."""
    reject_unported_bands(spot=spot, migration=migration,
                          convertible=convertible)
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

    # Steps 1-2: one batched fit and forecast over the P axis.
    model = fc.fit_batched(hist, cfg)
    t_fut = hist.shape[-1] + torch.arange(eval_hours, device=dev)
    yhat = fc.predict_batched(model, t_fut)                       # (P, H)
    w_hours = torch.arange(1, horizon_weeks + 1, device=dev) * HOURS_PER_WEEK

    # Steps 3-4, per-pool fractiles riding along.
    per_horizon = _prefix_weighted_quantiles(yhat, w_hours, qs)   # (P, W, K)
    term_weeks = torch.tensor([o.term_weeks for o in options], device=dev)
    widths, levels = _monotone_stack(
        per_horizon, qs, term_weeks, horizon_weeks
    )                                                             # (P, K)

    spends = pf.portfolio_spends(actual, widths, options, od_rate=od)
    widths_np, levels_np, qs_np, per_h_np, yhat_np = _to_host(
        widths, levels, qs, per_horizon, yhat
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
    total = committed + on_demand + spot_cost
    all_od = sum(e.spend.all_on_demand for e in per_pool)
    savings = 1.0 - total / all_od if all_od > 0 else 0.0

    # The aggregate (single-pool) plan the fleet trace used to collapse to:
    # same pipeline, pooled demand, every option purchasable.
    agg_res = plan_portfolio(
        hist.sum(0), options, num_horizons=horizon_weeks, od_rate=od,
        term_weighting=term_weighting, cfg=cfg,
    )
    agg_spend = pf.portfolio_spends(
        actual.sum(0)[None], agg_res.widths[None], options, od_rate=od
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
        spot_cost=spot_cost,
    )


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
