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
            demand above the stack top at the on-demand rate

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
decision week); and hindsight (the optimal constant stack on the realized
demand, short tranches repurchased back-to-back).
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import numpy as np
import torch

from repro_torch.capacity import pricing
from repro_torch.core import demand as dm
from repro_torch.core import forecast as fc
from repro_torch.core import ladder as ld
from repro_torch.core import policy as pol
from repro_torch.core import portfolio as pf
from repro_torch.core.demand import HOURS_PER_WEEK
from repro_torch.core.planner import (
    UNPORTED_BANDS,
    _monotone_stack,
    _prefix_weighted_quantiles,
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
    # Which policy drove the weekly decisions (``core.policy``), and the
    # weeks on which it could buy.
    policy_name: str = "rolling_portfolio"
    decision_mask: np.ndarray | None = None           # (S,) bool

    @property
    def weekly_cost(self) -> np.ndarray:
        """(S,) fleet-total spend per week."""
        return (self.committed_cost + self.on_demand_cost).sum(-1)

    def summary(self) -> dict:
        out = {
            "weeks_evaluated": int(len(self.weeks)),
            "cadence_weeks": self.cadence_weeks,
            "total_cost": self.total_cost,
            "savings_vs_on_demand": self.savings_vs_on_demand,
        }
        if self.decision_mask is not None:
            out["decision_weeks"] = int(self.decision_mask.sum())
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

    ``spot``, ``migration``, ``convertible``, ``scenarios``, ``telemetry``,
    ``cadence="breach"`` and ``irls_carry=True`` belong to subsystems the
    port does not have yet; setting any of them raises
    ``NotImplementedError`` naming the ROADMAP item.  ``breach_band`` and
    ``breach_tolerance`` only matter under ``cadence="breach"``."""
    del use_kernel, breach_band, breach_tolerance
    _reject_unported(
        spot=spot, migration=migration, convertible=convertible,
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
    rates = torch.tensor(
        [o.rate for o in options], dtype=torch.float32, device=dev
    )
    term_list = [o.term_weeks for o in options]
    term_weeks = torch.tensor(term_list, dtype=torch.int64, device=dev)
    sched_len = total_weeks + max(term_list) + 1
    w_hours = torch.arange(1, horizon_weeks + 1, device=dev) * HOURS_PER_WEEK
    opt_idx = torch.arange(num_opts, device=dev)

    state = fc.prefix_fit_state(
        demand, cfg, horizon_hours=horizon_hours,
        min_prefix_hours=start_weeks * HOURS_PER_WEEK,
    )
    demand_wk = demand.reshape(num_pools, total_weeks, HOURS_PER_WEEK)
    # Horizon prefix masks of the grid solver, (R*Wh, H): pool p's horizon
    # h row keeps the first h weeks of the forecast.
    t_h = torch.arange(horizon_hours, device=dev)
    prefix_masks = (t_h[None, :] < w_hours[:, None]).to(torch.float32)
    grid_masks = prefix_masks.repeat(num_pools, 1) if solver == "grid" else None

    def grid_prefix_levels(yhat):
        """Per-horizon stack tops via the over/under sweep on prefix-mask
        weights: horizon prefixes fold into the row axis, so the whole
        (P x Wh, H, G) problem is one sweep launch."""
        plan = pf.optimal_portfolio_grid(
            yhat.repeat_interleave(horizon_weeks, dim=0),
            al_p.repeat_interleave(horizon_weeks, dim=0),
            be_p.repeat_interleave(horizon_weeks, dim=0),
            od_rate=od, num_grid=num_grid, weights=grid_masks,
        )
        return plan.levels.reshape(num_pools, horizon_weeks, num_opts)

    def targets_for(yhat):
        """Algorithm 1 steps 2-4 on one week's forecast: per-horizon prefix
        thresholds -> min within each option's term -> monotone stack
        widths (P, K)."""
        if solver == "grid":
            per_h = grid_prefix_levels(yhat)
        else:
            per_h = _prefix_weighted_quantiles(yhat, w_hours, qs)
        widths, _ = _monotone_stack(per_h, qs, term_weeks, horizon_weeks)
        return widths

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
        )
        pstate, decide = step_policy.setup(ctx)
        active = torch.zeros((num_pools, num_opts), device=dev)
        rolloff = torch.zeros((num_pools, num_opts, sched_len), device=dev)
        outs: dict[str, list] = {
            k: [] for k in
            ("target", "inc", "active", "committed", "od", "util")
        }
        is_dec = []
        for w in range(start_weeks, total_weeks):
            # 1. tranches whose term ends at week w roll off the stack
            active = active - rolloff[:, :, w]
            # 2-4. the policy decides this week's target stack; buys happen
            # only on decision weeks and only as increments
            pstate, dec = decide(pstate, pol.Observation(week=w, active=active))
            widths = dec.targets
            inc = torch.clamp(widths - active, min=0.0)
            buy = (inc > ld.PURCHASE_EPS) & dec.is_decision
            inc = torch.where(buy, inc, 0.0)
            active = active + inc
            # The tranche bought at w expires at w + term.  The schedule
            # has total_weeks + max_term + 1 columns and w < total_weeks,
            # so the index is in range by construction; each option owns
            # one (option, column) cell, so the add has no collisions.
            rolloff[:, opt_idx, w + term_weeks] += inc
            # 5. bill the week: committed rates regardless of use, the
            # shortfall above the stack top at the on-demand rate
            d = demand_wk[:, w]                                # (P, 168)
            level = active.sum(-1)
            committed = (rates * active).sum(-1) * HOURS_PER_WEEK
            used = torch.minimum(d, level[:, None]).sum(-1)
            util = torch.where(
                level > 0, used / (level * HOURS_PER_WEEK), 0.0
            )
            over = torch.clamp(d - level[:, None], min=0.0).sum(-1)
            for key, val in (
                ("target", widths), ("inc", inc), ("active", active),
                ("committed", committed), ("od", od * over),
                ("util", util),
            ):
                outs[key].append(val)
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
    # the replay's increments) threaded through the portfolio ladder.
    targets_full = np.zeros((num_pools, total_weeks, num_opts), np.float32)
    targets_full[:, weeks[dec]] = np.swapaxes(ys["target"][dec], 0, 1)
    term_hours = np.asarray(term_list) * HOURS_PER_WEEK
    ladders = ld.plan_pool_portfolio_purchases(
        targets_full, term_hours, pools.keys
    )

    total = float(ys["committed"].sum() + ys["od"].sum())
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
    if not compare:
        return report

    # One-shot baseline: identical replay, single decision week, always the
    # standard rolling policy on the prefix-sum refit.
    one, _ = replay(0, fc.solve_prefix, pol.RollingPortfolioPolicy())
    one_weekly = (one["committed"] + one["od"]).sum(-1)
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
