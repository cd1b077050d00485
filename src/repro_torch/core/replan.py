"""Rolling weekly re-planning over pool portfolios (paper §3.3.3-§3.3.4).

Algorithm 1 as the paper operates it: re-run the purchase decision every
week as new demand history arrives, buying only increments on top of what
is already committed (commitments are added any week and only expire):

    for each week w (from ``start_weeks``):
        roll off tranches whose term ends at w
        re-fit the forecaster on the demand prefix [0, w·168)
        forecast ``horizon_weeks`` ahead; solve the per-horizon portfolio
            thresholds (Algorithm 1 steps 2-4) for every pool
        on decision weeks (every ``cadence_weeks``): buy, per pool per
            option, the increment that lifts the active width to target
        bill the week: every active tranche at its committed rate,
            demand above the stack top at the on-demand rate (with a spot
            band: on-demand up to the week's spot floor, the effective
            spot rate above it)

The reference runs this as one ``lax.scan``.  Here it is a Python loop over
weeks that carries ``(active (P, K), rolloff (P, K, W), pstate)`` as tensors
on the replay's device.  Nothing inside the loop reads a device value back
on the host: the cadence rule is host arithmetic on the week number, and
the per-week outputs are stacked on the device and copied to the host once
after the loop.

``solver="grid"`` solves each week's per-horizon prefixes with the grid
solver on the commitment sweep; on the card that is the hand-written CUDA
kernel, one launch per replayed week of each replay.  ``solver="quantile"``
uses sorts and gathers.  ``backend="scan"`` refits from prefix sums of the
normal equations, ``backend="loop"`` re-accumulates them every week (the
independent implementation the reference's python-loop replay is).

The report compares three operating points on the same evaluation window:
the rolling replay; the one-shot baseline (the same replay with a single
decision week, with the same spot band); and hindsight (the optimal
constant stack on the realized demand, short tranches repurchased
back-to-back; commitments only).

``spot=`` adds the spot band, the fast half of the capacity split: every
week the forecast's per-horizon spot floors (the envelope entry against
the chance-constraint volume cap, sorts and gathers only) truncate the
per-horizon committed levels, and the horizon-1 floor is that week's
spot decision, never carried.

``migration=`` makes the weekly forecasts turnover-aware
(``core.migration``): the structural state fits pair totals in
old-equivalent units, a share prefix state rides beside it, and each
week's per-pool forecasts are recomposed from total x logistic share by
the policy's ``compose_forecast`` hook.  ``convertible=`` adds the
cloud-level exchangeable SKUs, carried as ``(active_c, rolloff_c)``
(C, Kc): each week rolls off, sizes the cloud-level stack on the cloud
totals of the forecast (truncated below the pools' pinned stacks), buys
increments, re-pins the live width onto the pools by the coming week's
forecast-peak excess, suppresses the standard buys pro rata, and bills the
pools at their level plus that allocation.  Under ``solver="grid"`` the
cloud rows are a second sweep launch each replayed week.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import numpy as np
import torch

from repro_torch.capacity import generations as gn
from repro_torch.capacity import pricing
from repro_torch.core import demand as dm
from repro_torch.core import forecast as fc
from repro_torch.core import ladder as ld
from repro_torch.core import migration as mg
from repro_torch.core import policy as pol
from repro_torch.core import portfolio as pf
from repro_torch.core import spot as spot_mod
from repro_torch.core.demand import HOURS_PER_WEEK
from repro_torch.core.planner import (
    UNPORTED_BANDS,
    _monotone_stack,
    _prefix_weighted_quantiles,
    _spot_floors,
    reject_unported_bands,
)
from repro_torch.device import resolve_device

pricing.validate_tables()


@dataclasses.dataclass
class RollingPlanReport:
    """Replay of the rolling re-planning loop plus its two baselines.

    Per-week arrays are aligned with ``weeks`` (absolute week indices into
    the trace, starting at ``start_weeks``); per-pool axes align with
    ``keys``; option axes with ``options``.  All arrays are host numpy."""

    keys: tuple[dm.PoolKey, ...]
    options: list[pf.PurchaseOption]
    cadence_weeks: int
    start_weeks: int
    horizon_weeks: int
    weeks: np.ndarray                 # (S,) absolute week index
    targets: np.ndarray               # (S, P, K) per-week solver targets
    increments: np.ndarray            # (S, P, K) tranches actually bought
    active: np.ndarray                # (S, P, K) committed stack after buys
    committed_cost: np.ndarray        # (S, P) weekly committed spend
    on_demand_cost: np.ndarray        # (S, P) weekly shortfall spend
    utilization: np.ndarray           # (S, P) used / committed chip-hours
    ladders: ld.PoolLadderBook        # the purchases as a tranche book
    total_cost: float
    all_on_demand_cost: float
    savings_vs_on_demand: float
    # one-shot baseline: buy the week-``start_weeks`` plan, never re-plan
    one_shot_weekly_cost: np.ndarray | None = None    # (S,)
    one_shot_cost: float | None = None
    savings_vs_one_shot: float | None = None
    # hindsight baseline: optimal constant stack on the realized demand
    hindsight_widths: np.ndarray | None = None        # (P, K)
    hindsight_weekly_cost: np.ndarray | None = None   # (S,)
    hindsight_cost: float | None = None
    regret_vs_hindsight: float | None = None
    # Spot band (None on spot-free replays): re-decided every week from
    # that week's forecast, no tranche, no term.  ``spot_floor`` is clamped
    # to the committed stack top; demand above it bills at the effective
    # spot rate, between stack top and floor at on-demand.
    spot_config: "spot_mod.SpotConfig | None" = None
    spot_lines: "spot_mod.SpotLines | None" = None
    spot_floor: np.ndarray | None = None              # (S, P) weekly floors
    spot_cost: np.ndarray | None = None               # (S, P) weekly spend
    spot_volume: np.ndarray | None = None             # (S, P) chip-hours
    spot_ladders: ld.PoolLadderBook | None = None     # 1-week audit tranches
    # Migration awareness (None on migration-blind replays): the successor
    # table and the edges it matched onto the fleet.
    migration_config: "gn.MigrationConfig | None" = None
    migration_edges: "gn.MigrationEdges | None" = None
    # Convertible band (None on convertible-free replays): cloud-level
    # tranches carried per cloud, re-pinned onto that cloud's pools every
    # week (``conv_alloc``).  Cloud axes align with ``conv_clouds``, option
    # axes with ``conv_options``.
    conv_options: "list[pf.PurchaseOption] | None" = None
    conv_clouds: tuple[str, ...] | None = None
    conv_targets: np.ndarray | None = None            # (S, C, Kc) targets
    conv_increments: np.ndarray | None = None         # (S, C, Kc) buys
    conv_active: np.ndarray | None = None             # (S, C, Kc) stack
    conv_alloc: np.ndarray | None = None              # (S, P) re-pinned
    conv_committed_cost: np.ndarray | None = None     # (S, C) weekly spend
    conv_ladders: ld.PoolLadderBook | None = None     # cloud-level book
    # Which policy drove the weekly decisions (``core.policy``), and the
    # weeks on which it could buy.
    policy_name: str = "rolling_portfolio"
    decision_mask: np.ndarray | None = None           # (S,) bool

    @property
    def weekly_cost(self) -> np.ndarray:
        """(S,) fleet-total spend per week."""
        total = self.committed_cost + self.on_demand_cost
        if self.spot_cost is not None:
            total = total + self.spot_cost
        total = total.sum(-1)
        if self.conv_committed_cost is not None:
            total = total + self.conv_committed_cost.sum(-1)
        return total

    def summary(self) -> dict:
        out = {
            "weeks_evaluated": int(len(self.weeks)),
            "cadence_weeks": self.cadence_weeks,
            "total_cost": self.total_cost,
            "savings_vs_on_demand": self.savings_vs_on_demand,
        }
        if self.decision_mask is not None:
            out["decision_weeks"] = int(self.decision_mask.sum())
        if self.spot_cost is not None:
            out["spot_cost"] = float(self.spot_cost.sum())
            out["spot_chip_hours"] = float(self.spot_volume.sum())
        if self.conv_committed_cost is not None:
            out["convertible_cost"] = float(self.conv_committed_cost.sum())
            out["convertible_final_width"] = float(
                self.conv_active[-1].sum()
            )
        if self.one_shot_cost is not None:
            out["one_shot_cost"] = self.one_shot_cost
            out["savings_vs_one_shot"] = self.savings_vs_one_shot
        if self.hindsight_cost is not None:
            out["hindsight_cost"] = self.hindsight_cost
            out["regret_vs_hindsight"] = self.regret_vs_hindsight
        return out


def _validate(total_weeks: int, start_weeks: int, cadence_weeks: int):
    if cadence_weeks < 1:
        raise ValueError(f"cadence_weeks must be >= 1, got {cadence_weeks}")
    if not 1 <= start_weeks < total_weeks:
        raise ValueError(
            f"start_weeks={start_weeks} must leave history and an "
            f"evaluation window inside {total_weeks} whole trace weeks"
        )


def _reject_unported(**kw) -> None:
    """Raise ``NotImplementedError`` for every keyword set to anything but
    its disabled value whose subsystem the port does not have yet."""
    reject_unported_bands(**{name: kw[name] for name in UNPORTED_BANDS})
    if kw["cadence"] != "weekly":
        if kw["cadence"] != "breach":
            raise ValueError(
                f"unknown cadence {kw['cadence']!r}; "
                "known: ('weekly', 'breach')"
            )
        raise NotImplementedError(
            "cadence='breach' is not ported yet (ROADMAP Queue 1, item 14: "
            "telemetry emitters and breach cadence)"
        )
    if kw["irls_carry"]:
        raise NotImplementedError(
            "irls_carry=True is not ported yet (ROADMAP Queue 1, item 6: "
            "carried IRLS moments)"
        )


def replan_fleet_pools(
    pools: dm.PoolSet,
    options: list[pf.PurchaseOption] | None = None,
    *,
    cadence_weeks: int = 1,
    start_weeks: int | None = None,
    horizon_weeks: int = 8,
    od_rate: float | None = None,
    term_weighting: float = 0.0,
    cfg: fc.ForecastConfig = fc.ForecastConfig(),
    solver: Literal["quantile", "grid"] = "quantile",
    num_grid: int = 128,
    use_kernel: bool = False,
    irls_iters: int = 0,
    backend: Literal["scan", "loop"] = "scan",
    compare: bool = True,
    spot=None,
    migration=None,
    convertible=None,
    policy: "pol.Policy | str | None" = None,
    scenarios=None,
    irls_carry: bool = False,
    telemetry=None,
    cadence: str = "weekly",
    breach_band: tuple = (0.05, 0.95),
    breach_tolerance: float = 4.0,
    device: "torch.device | str | None" = None,
) -> RollingPlanReport:
    """Replay the rolling re-planning loop over ``pools`` on ``device``
    (``None`` = ``"cuda"``; without a card pass ``device="cpu"``).

    The first ``start_weeks`` weeks are pure history (default: a quarter of
    the trace, at least ``horizon_weeks``); every week after that is
    forecast, (on cadence weeks) re-planned, and billed.  ``irls_iters``
    adds asymmetric-error IRLS passes to each weekly refit.  With
    ``compare`` the one-shot and hindsight baselines are replayed on the
    same window.  ``use_kernel`` is accepted for the reference's spelling:
    on the card the grid solver always runs the CUDA kernel (see
    ``portfolio.optimal_portfolio_grid``).

    ``spot`` (True, a :class:`~repro_torch.core.spot.SpotConfig` or a
    (SpotConfig, SpotLines) pair) adds the spot band, ``migration`` (True
    or a ``generations.MigrationConfig``) the turnover-aware forecasts,
    ``convertible`` (True or a list of convertible options) the
    cloud-level band; each needs a forecasting policy.  ``scenarios``,
    ``telemetry``, ``cadence="breach"`` and ``irls_carry=True`` belong to
    subsystems the port does not have yet; setting any of them raises
    ``NotImplementedError`` naming the ROADMAP item.  ``breach_band`` and
    ``breach_tolerance`` only matter under ``cadence="breach"``."""
    del use_kernel, breach_band, breach_tolerance
    _reject_unported(
        scenarios=scenarios, telemetry=telemetry, cadence=cadence,
        irls_carry=irls_carry,
    )
    if solver not in ("quantile", "grid"):
        raise ValueError(
            f"unknown solver {solver!r}; known: ('quantile', 'grid')"
        )
    if backend not in ("scan", "loop"):
        raise ValueError(
            f"unknown backend {backend!r}; known: ('scan', 'loop')"
        )
    dev = resolve_device(device)
    options = options if options is not None else pf.options_from_pricing()
    od = od_rate if od_rate is not None else pricing.on_demand_premium()
    total_weeks = pools.num_hours // HOURS_PER_WEEK
    if start_weeks is None:
        start_weeks = min(max(horizon_weeks, total_weeks // 4),
                          max(total_weeks - 1, 1))
    _validate(total_weeks, start_weeks, cadence_weeks)
    pcy = pol.get_policy(policy)

    num_pools, num_opts = pools.num_pools, len(options)
    horizon_hours = horizon_weeks * HOURS_PER_WEEK
    t_hist = total_weeks * HOURS_PER_WEEK
    demand_np = np.ascontiguousarray(pools.demand[:, :t_hist])
    demand = torch.as_tensor(demand_np, dtype=torch.float32).to(dev)
    clouds = pools.clouds

    al_p, be_p, _ = pf.pool_option_lines(
        options, clouds, term_weighting=term_weighting, od_rate=od,
        device=dev,
    )
    qs = pf.handover_fractiles(al_p, be_p, od_rate=od)       # (P, K)
    sp_res = spot_mod.resolve_spot(spot, clouds, od_rate=od, device=dev)
    if sp_res is not None:
        s_cfg, s_lines = sp_res
        u_env = spot_mod.spot_entry_fractile(al_p, be_p, s_lines.rate,
                                             od_rate=od)      # (P,)
    rates = torch.tensor(
        [o.rate for o in options], dtype=torch.float32, device=dev
    )
    term_list = [o.term_weeks for o in options]
    term_weeks = torch.tensor(term_list, dtype=torch.int64, device=dev)

    # Migration awareness: the structural state fits pair totals, a share
    # prefix state rides along, the policy recomposes each week's forecast.
    mig_cfg = gn.resolve_migration(migration)
    edges = (gn.migration_edges(pools.keys, mig_cfg, device=dev)
             if mig_cfg is not None else None)
    use_mig = edges is not None and edges.num_edges > 0

    # Convertible band: cloud-level SKUs beside the pool-pinned options.
    conv_opts = pf.resolve_convertible(convertible, clouds)
    max_term = max(term_list)
    if conv_opts is not None:
        conv_clouds, member, al_c, be_c, qs_c, conv_terms = (
            pf.convertible_cloud_setup(
                conv_opts, clouds, term_weighting=term_weighting,
                od_rate=od, device=dev,
            )
        )
        num_clouds, num_conv = len(conv_clouds), len(conv_opts)
        conv_rates = torch.tensor([o.rate for o in conv_opts],
                                  dtype=torch.float32, device=dev)
        conv_idx = torch.arange(num_conv, device=dev)
        max_term = max(max_term, max(o.term_weeks for o in conv_opts))
    sched_len = total_weeks + max_term + 1

    bands = [name for name, on in (("spot", sp_res is not None),
                                   ("migration", use_mig),
                                   ("convertible", conv_opts is not None))
             if on]
    if bands and not pcy.forecasting:
        raise ValueError(
            f"policy {pcy.name!r} does not forecast, but "
            f"{'/'.join(bands)} bands key on the weekly forecast; use a "
            "forecasting policy or disable the bands"
        )
    w_hours = torch.arange(1, horizon_weeks + 1, device=dev) * HOURS_PER_WEEK
    opt_idx = torch.arange(num_opts, device=dev)

    fit_demand = mg.transform_for_fit(demand, edges) if use_mig else demand
    state = fc.prefix_fit_state(
        fit_demand, cfg, horizon_hours=horizon_hours,
        min_prefix_hours=start_weeks * HOURS_PER_WEEK,
    )
    demand_wk = demand.reshape(num_pools, total_weeks, HOURS_PER_WEEK)
    # Horizon prefix masks of the grid solver, (R*Wh, H): row r's horizon
    # h keeps the first h weeks of the forecast.
    t_h = torch.arange(horizon_hours, device=dev)
    prefix_masks = (t_h[None, :] < w_hours[:, None]).to(torch.float32)
    pool_masks = cloud_masks = None
    if solver == "grid":
        pool_masks = prefix_masks.repeat(num_pools, 1)
        if conv_opts is not None:
            cloud_masks = prefix_masks.repeat(num_clouds, 1)

    def grid_prefix_levels(yhat, alphas, betas, masks):
        """Per-horizon stack tops via the over/under sweep on prefix-mask
        weights: horizon prefixes fold into the row axis, so the whole
        (R x Wh, H, G) problem is one sweep launch (rows R are pools for
        the standard options, clouds for the convertible band; ``masks``
        is ``prefix_masks`` repeated once per row)."""
        plan = pf.optimal_portfolio_grid(
            yhat.repeat_interleave(horizon_weeks, dim=0),
            alphas.repeat_interleave(horizon_weeks, dim=0),
            betas.repeat_interleave(horizon_weeks, dim=0),
            od_rate=od, num_grid=num_grid, weights=masks,
        )
        return plan.levels.reshape(yhat.shape[0], horizon_weeks,
                                   alphas.shape[-1])

    def targets_for(yhat):
        """Algorithm 1 steps 2-4 on one week's forecast: per-horizon prefix
        thresholds -> min within each option's term -> monotone stack
        widths (P, K).  With spot, the per-horizon levels truncate at the
        spot floors first, and the horizon-1 floor (P,) rides along as
        the week's spot decision (None without spot)."""
        if solver == "grid":
            per_h = grid_prefix_levels(yhat, al_p, be_p, pool_masks)
        else:
            per_h = _prefix_weighted_quantiles(yhat, w_hours, qs)
        floor = None
        if sp_res is not None:
            floors = _spot_floors(yhat, w_hours, u_env, s_lines.cap)
            per_h = torch.minimum(per_h, floors[..., None])
            floor = floors[:, 0]
        widths, _ = _monotone_stack(per_h, qs, term_weeks, horizon_weeks)
        return widths, floor

    def conv_targets_for(yhat, pool_top):
        """Cloud-level convertible targets (C, Kc) on one week's forecast.
        A cloud's total is turnover-invariant (demand moves between its
        families, not out of it), so the safe cloud-level stack comes from
        the same prefix thresholds -> term minima -> monotone stack on the
        cloud totals with the convertible lines, truncated below the
        cloud's summed pool stacks ``pool_top`` (P,): convertible buys the
        band that is safe at cloud level but pinnable to no one family."""
        total_c = member @ yhat                                # (C, H)
        if solver == "grid":
            per_h = grid_prefix_levels(total_c, al_c, be_c, cloud_masks)
        else:
            per_h = _prefix_weighted_quantiles(total_c, w_hours, qs_c)
        widths_c, tops_c = _monotone_stack(per_h, qs_c, conv_terms,
                                           horizon_weeks)
        return pf.truncate_convertible_stack(tops_c, widths_c,
                                             member @ pool_top)

    compose_forecast = None
    if use_mig:
        share_state = mg.share_prefix_state(
            demand, edges, t_max=state.t_max,
            prior_weight=mig_cfg.share_prior_weight,
        )

        def compose_forecast(yhat, w):
            """Pair totals x the week-``w`` prefix's logistic share fits
            -> per-pool forecasts (the policy's hook)."""
            sa, sb = mg.solve_share_prefix(share_state, w)
            sh = mg.predict_share(sa, sb, w * HOURS_PER_WEEK + t_h,
                                  share_state.t_max)
            return mg.compose_forecast(yhat, sh, edges)

    def convertible_week(w, dec, active, active_c, rolloff_c):
        """The convertible pass of week ``w``, decided before the standard
        buys: roll off, size the cloud band (truncated below the higher of
        this week's pool targets and the carried pool stacks, so surplus
        standard tranches are not covered twice), buy its increments,
        re-pin the live width onto the pools by the coming week's forecast
        peak above their stacks (allocating sunk capacity is free; a mean
        need would leave the diurnal peaks on demand), and scale the
        standard buys down pro rata by that allocation.  Returns (the
        standard increments (P, K), active_c, the cloud outputs)."""
        active_c = active_c - rolloff_c[:, :, w]
        widths = dec.targets
        pool_top = torch.maximum(widths.sum(-1), active.sum(-1))
        widths_c = conv_targets_for(dec.yhat, pool_top)
        inc_c = torch.clamp(widths_c - active_c, min=0.0)
        inc_c = torch.where((inc_c > ld.PURCHASE_EPS) & dec.is_decision,
                            inc_c, 0.0)
        active_c = active_c + inc_c
        rolloff_c[:, conv_idx, w + conv_terms] += inc_c
        need = torch.clamp(
            dec.yhat[:, :HOURS_PER_WEEK].amax(-1) - active.sum(-1), min=0.0)
        alloc = pf.allocate_convertible(active_c.sum(-1), need, member)
        desired = torch.clamp(widths - active, min=0.0)
        lift = desired.sum(-1)                                   # (P,)
        scale = torch.where(
            lift > ld.PURCHASE_EPS,
            torch.clamp(lift - alloc, min=0.0) / torch.clamp(lift, min=1e-9),
            0.0)
        inc = desired * scale[:, None]
        inc = torch.where((inc > ld.PURCHASE_EPS) & dec.is_decision, inc, 0.0)
        outs = {"conv_target": widths_c, "conv_inc": inc_c,
                "conv_active": active_c, "conv_alloc": alloc,
                "conv_committed":
                    (conv_rates * active_c).sum(-1) * HOURS_PER_WEEK}
        return inc, active_c, outs

    def replay(cadence_wk: int, solve_fn, step_policy: pol.Policy):
        """One pass over the evaluation weeks; returns the per-week outputs
        as host numpy arrays and the host decision flags."""
        ctx = pol.PolicyContext(
            demand=demand, options=options, clouds=clouds, od=od,
            rates=rates, term_weeks=term_weeks, qs=qs,
            w_hours=w_hours, start_weeks=start_weeks,
            cadence_weeks=cadence_wk, horizon_weeks=horizon_weeks,
            total_weeks=total_weeks, state=state, solve_fn=solve_fn,
            irls_iters=irls_iters, targets_for=targets_for,
            compose_forecast=compose_forecast,
        )
        pstate, decide = step_policy.setup(ctx)
        active = torch.zeros((num_pools, num_opts), device=dev)
        rolloff = torch.zeros((num_pools, num_opts, sched_len), device=dev)
        if conv_opts is not None:
            active_c = torch.zeros((num_clouds, num_conv), device=dev)
            rolloff_c = torch.zeros((num_clouds, num_conv, sched_len),
                                    device=dev)
        outs: dict[str, list] = {}
        is_dec = []
        for w in range(start_weeks, total_weeks):
            # 1. tranches whose term ends at week w roll off the stack
            active = active - rolloff[:, :, w]
            # 2-4. the policy decides this week's target stack; buys happen
            # only on decision weeks and only as increments
            pstate, dec = decide(pstate, pol.Observation(week=w, active=active))
            widths = dec.targets
            if conv_opts is None:
                inc = torch.clamp(widths - active, min=0.0)
                buy = (inc > ld.PURCHASE_EPS) & dec.is_decision
                inc = torch.where(buy, inc, 0.0)
            else:
                inc, active_c, conv_vals = convertible_week(
                    w, dec, active, active_c, rolloff_c)
            active = active + inc
            # The tranche bought at w expires at w + term.  The schedule
            # has total_weeks + max_term + 1 columns and w < total_weeks,
            # so the index is in range by construction; each option owns
            # one (option, column) cell, so the add has no collisions.
            rolloff[:, opt_idx, w + term_weeks] += inc
            # 5. bill the week: committed rates regardless of use, the
            # shortfall above the stack top at the on-demand rate; with a
            # spot band, on-demand only up to the floor and the effective
            # spot rate above it.  A convertible allocation lifts each
            # pool's level for the week (its tranches bill at cloud level).
            d = demand_wk[:, w]                                # (P, 168)
            level = active.sum(-1)
            committed = (rates * active).sum(-1) * HOURS_PER_WEEK
            if conv_opts is not None:
                level = level + conv_vals["conv_alloc"]
            used = torch.minimum(d, level[:, None]).sum(-1)
            util = torch.where(
                level > 0, used / (level * HOURS_PER_WEEK), 0.0
            )
            vals = {"target": widths, "inc": inc, "active": active,
                    "committed": committed, "util": util}
            if sp_res is None:
                over = torch.clamp(d - level[:, None], min=0.0).sum(-1)
            else:
                fl = torch.maximum(dec.floor, level)
                over = torch.clamp(
                    torch.minimum(d, fl[:, None]) - level[:, None], min=0.0
                ).sum(-1)
                spot_over = torch.clamp(d - fl[:, None], min=0.0)
                spot_vol = spot_over.sum(-1)
                vals.update(floor=fl, spot_vol=spot_vol,
                            spot=s_lines.rate * spot_vol,
                            spot_peak=spot_over.amax(-1))
            vals["od"] = od * over
            if conv_opts is not None:
                vals.update(conv_vals)
            for key, val in vals.items():
                outs.setdefault(key, []).append(val)
            is_dec.append(bool(dec.is_decision))
        ys = {k: torch.stack(v).cpu().numpy() for k, v in outs.items()}
        return ys, np.asarray(is_dec, bool)

    ys, dec = replay(
        cadence_weeks,
        fc.solve_prefix if backend == "scan" else fc.solve_prefix_direct,
        pcy,
    )
    weeks = np.arange(start_weeks, total_weeks)

    # The purchases as a tranche book: per-week targets (0 outside decision
    # weeks, so the ladder planner's "never below active" rule buys exactly
    # the replay's increments) threaded through the portfolio ladder.  With
    # the convertible band the targets are not what was bought (live
    # convertible capacity suppresses standard buys), so the book replays
    # the realized post-purchase stack instead.
    targets_full = np.zeros((num_pools, total_weeks, num_opts), np.float32)
    book = ys["target"] if conv_opts is None else ys["active"]
    targets_full[:, weeks[dec]] = np.swapaxes(book[dec], 0, 1)
    term_hours = np.asarray(term_list) * HOURS_PER_WEEK
    ladders = ld.plan_pool_portfolio_purchases(
        targets_full, term_hours, pools.keys
    )

    total = float(ys["committed"].sum() + ys["od"].sum())
    if sp_res is not None:
        total += float(ys["spot"].sum())
    if conv_opts is not None:
        total += float(ys["conv_committed"].sum())
    eval_np = demand_np[:, start_weeks * HOURS_PER_WEEK:]
    all_od = od * float(eval_np.sum())
    report = RollingPlanReport(
        keys=pools.keys,
        options=options,
        cadence_weeks=cadence_weeks,
        start_weeks=start_weeks,
        horizon_weeks=horizon_weeks,
        weeks=weeks,
        targets=ys["target"],
        increments=ys["inc"],
        active=ys["active"],
        committed_cost=ys["committed"],
        on_demand_cost=ys["od"],
        utilization=ys["util"],
        ladders=ladders,
        total_cost=total,
        all_on_demand_cost=all_od,
        savings_vs_on_demand=1.0 - total / all_od if all_od > 0 else 0.0,
        policy_name=pcy.name,
        decision_mask=dec,
    )
    if sp_res is not None:
        report.spot_config = s_cfg
        report.spot_lines = s_lines
        report.spot_floor = ys["floor"]
        report.spot_cost = ys["spot"]
        report.spot_volume = ys["spot_vol"]
        # The fast half of the split as a tranche book: every spot tranche
        # lasts exactly one week, sized at the week's peak spot usage.
        report.spot_ladders = ld.spot_ladder_book(
            ys["spot_peak"], pools.keys, start_week=start_weeks,
        )
    if use_mig:
        report.migration_config = mig_cfg
        report.migration_edges = edges
    if conv_opts is not None:
        report.conv_options = conv_opts
        report.conv_clouds = tuple(conv_clouds)
        report.conv_targets = ys["conv_target"]
        report.conv_increments = ys["conv_inc"]
        report.conv_active = ys["conv_active"]
        report.conv_alloc = ys["conv_alloc"]
        report.conv_committed_cost = ys["conv_committed"]
        # The cloud-level tranche book, with the pool book's increment-only
        # semantics: its live widths reconcile with the carried stack.
        conv_full = np.zeros((num_clouds, total_weeks, num_conv), np.float32)
        conv_full[:, weeks[dec]] = np.swapaxes(ys["conv_target"][dec], 0, 1)
        report.conv_ladders = ld.convertible_ladder_book(
            conv_full,
            np.asarray([o.term_weeks for o in conv_opts]) * HOURS_PER_WEEK,
            conv_clouds,
        )
    if not compare:
        return report

    # One-shot baseline: identical replay (the same spot, migration and
    # convertible bands, if any), single decision week, always the standard
    # rolling policy on the prefix-sum refit.
    one, _ = replay(0, fc.solve_prefix, pol.RollingPortfolioPolicy())
    one_weekly = (one["committed"] + one["od"]).sum(-1)
    if sp_res is not None:
        one_weekly = one_weekly + one["spot"].sum(-1)
    if conv_opts is not None:
        one_weekly = one_weekly + one["conv_committed"].sum(-1)
    report.one_shot_weekly_cost = one_weekly
    report.one_shot_cost = float(one_weekly.sum())
    report.savings_vs_one_shot = (
        1.0 - total / report.one_shot_cost
        if report.one_shot_cost > 0 else 0.0
    )

    # Hindsight baseline: the optimal constant stack on realized demand
    # (billing lines, term_weighting=0: every active tranche bills its
    # rate; expiring short tranches are repurchased back-to-back).
    al0, be0, _ = pf.pool_option_lines(
        options, clouds, term_weighting=0.0, od_rate=od, device=dev
    )
    hs = pf.optimal_portfolio_stack(
        demand[:, start_weeks * HOURS_PER_WEEK:], al0, be0, od_rate=od
    )
    hs_widths = hs.widths.cpu().numpy()
    hs_level = hs_widths.sum(-1)
    ed_wk = eval_np.reshape(num_pools, len(weeks), HOURS_PER_WEEK)
    hs_over = np.maximum(ed_wk - hs_level[:, None, None], 0.0).sum(-1)
    hs_committed = (
        rates.cpu().numpy() * hs_widths
    ).sum(-1) * HOURS_PER_WEEK
    hs_weekly = hs_committed[:, None] + od * hs_over      # (P, S)
    report.hindsight_widths = hs_widths
    report.hindsight_weekly_cost = hs_weekly.sum(0)
    report.hindsight_cost = float(hs_weekly.sum())
    report.regret_vs_hindsight = (
        total / report.hindsight_cost - 1.0
        if report.hindsight_cost > 0 else 0.0
    )
    return report
