"""Commitment policies behind the rolling replay (paper §3.3.3 + baselines).

The weekly replay in :mod:`repro_torch.core.replan` is a harness: roll
expired tranches off, let a *policy* pick this week's per-pool target stack,
buy only the increments, bill the week.  A policy is two phases:
``setup(ctx)`` runs once per replay and returns ``(pstate0, decide)``;
``decide`` is called once per week:

    pstate, Decision(targets, floor, yhat, is_decision)
        = decide(pstate, Observation(week, active))

Ported so far:

    RollingPortfolioPolicy   the paper's Algorithm 1 loop: weekly prefix
                             refit -> per-horizon thresholds -> monotone
                             stack.
    OneShotPolicy            a single decision week (what the one-shot
                             planner prices at t0).
    HindsightPolicy          non-causal: the optimal constant stack on the
                             realized demand, rebought weekly.

The forecast-free hedging policies of Ambati et al. come with the
tournament slice (ROADMAP Queue 1, item 13).  ``is_decision`` is a host
bool: the cadence rule depends on the week number only, so deciding it
needs nothing from the device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core import forecast as fc
from repro_torch.core import portfolio as pf
from repro_torch.core.demand import HOURS_PER_WEEK


@dataclasses.dataclass
class PolicyContext:
    """Everything a policy may consult, assembled once per replay by
    ``replan.replan_fleet_pools``.  Tensors live on the replay's device;
    ``solve_fn``/``targets_for`` are callables of the harness."""

    demand: torch.Tensor         # (P, T) whole-week demand, history + eval
    options: list
    clouds: tuple[str, ...]
    od: float
    rates: torch.Tensor          # (K,) committed rates
    term_weeks: torch.Tensor     # (K,) int64 terms
    qs: torch.Tensor             # (P, K) handover fractiles
    w_hours: torch.Tensor        # (H,) horizon prefix lengths in hours
    start_weeks: int
    cadence_weeks: int
    horizon_weeks: int
    total_weeks: int
    state: fc.PrefixFitState
    solve_fn: Callable           # (state, week) -> beta  (scan or loop)
    irls_iters: int = 0
    # yhat (P, Wh*168) -> (targets (P, K), spot floor (P,) | None)
    targets_for: Callable | None = None
    # (yhat, week) -> yhat: the migration band's recomposition of pair-total
    # forecasts into per-pool forecasts (None without the band)
    compose_forecast: Callable | None = None

    @property
    def horizon_hours(self) -> int:
        return self.horizon_weeks * HOURS_PER_WEEK


class Observation(NamedTuple):
    """Per-week inputs the harness hands to ``decide``."""

    week: int                     # absolute week index
    active: torch.Tensor          # (P, K) committed stack after roll-offs


class Decision(NamedTuple):
    """Per-week outputs of ``decide``."""

    targets: torch.Tensor         # (P, K) absolute stack widths to hold
    floor: torch.Tensor | None    # (P,) spot floor (forecasting + spot only)
    yhat: torch.Tensor | None     # (P, H) forecast (None = non-forecasting)
    is_decision: bool             # may this week buy?


class Policy:
    """Base policy: subclass and implement :meth:`setup`."""

    name: str = "policy"
    #: produces a forecast (yhat), which the spot band keys on
    forecasting: bool = False

    def setup(self, ctx: PolicyContext) -> tuple[Any, Callable]:
        raise NotImplementedError

    def _is_decision(self, ctx: PolicyContext, w: int) -> bool:
        """The harness cadence rule: every ``cadence_weeks`` from the start
        week; ``cadence_weeks == 0`` means the single start week (the
        one-shot baseline replay)."""
        if ctx.cadence_weeks > 0:
            return (w - ctx.start_weeks) % ctx.cadence_weeks == 0
        return w == ctx.start_weeks


class RollingPortfolioPolicy(Policy):
    """The paper's rolling loop as a policy: re-fit the forecaster on the
    week-``w`` prefix, forecast the horizon (recomposed from pair totals
    and shares by ``ctx.compose_forecast`` under the migration band), and
    run Algorithm 1 steps 2-4 for the target stack."""

    name = "rolling_portfolio"
    forecasting = True

    def setup(self, ctx: PolicyContext):
        def decide(pstate, obs: Observation):
            w = obs.week
            beta = ctx.solve_fn(ctx.state, w)
            beta = fc.irls_refine(ctx.state, beta, w, ctx.irls_iters)
            yhat = fc.predict_from_beta(
                ctx.state, beta, w * HOURS_PER_WEEK, ctx.horizon_hours
            )
            if ctx.compose_forecast is not None:
                yhat = ctx.compose_forecast(yhat, w)
            targets, floor = ctx.targets_for(yhat)
            return pstate, Decision(
                targets, floor, yhat, self._is_decision(ctx, w)
            )

        return (), decide


class OneShotPolicy(RollingPortfolioPolicy):
    """Degenerate rolling policy: one decision at the start week, then
    tranches only expire."""

    name = "one_shot"

    def _is_decision(self, ctx: PolicyContext, w: int) -> bool:
        return w == ctx.start_weeks


class HindsightPolicy(Policy):
    """Non-causal reference: the optimal *constant* stack on the realized
    evaluation demand (billing lines, ``term_weighting=0``), held every
    week, so expiring tranches rebuy back-to-back."""

    name = "hindsight"

    def setup(self, ctx: PolicyContext):
        al0, be0, _ = pf.pool_option_lines(
            ctx.options, ctx.clouds, term_weighting=0.0, od_rate=ctx.od,
            device=ctx.demand.device,
        )
        eval_demand = ctx.demand[:, ctx.start_weeks * HOURS_PER_WEEK:]
        widths = pf.optimal_portfolio_stack(
            eval_demand, al0, be0, od_rate=ctx.od
        ).widths                                               # (P, K)

        def decide(pstate, obs: Observation):
            return pstate, Decision(widths, None, None, True)

        return (), decide


POLICIES: dict[str, Callable[[], Policy]] = {
    "rolling_portfolio": RollingPortfolioPolicy,
    "one_shot": OneShotPolicy,
    "hindsight": HindsightPolicy,
}

#: Registry names of the reference whose policies are not ported yet.
UNPORTED_POLICIES = ("deterministic_hedge", "randomized_hedge")


def get_policy(policy: "Policy | str | None") -> Policy:
    """Resolve the ``policy=`` planner kwarg: None -> the paper's rolling
    loop, a registry name -> a fresh instance, an instance -> itself."""
    if policy is None:
        return RollingPortfolioPolicy()
    if isinstance(policy, Policy):
        return policy
    if isinstance(policy, str):
        if policy in UNPORTED_POLICIES:
            raise NotImplementedError(
                f"policy {policy!r} is not ported yet (ROADMAP Queue 1, "
                "item 13: tournament and hedging policies)"
            )
        try:
            return POLICIES[policy]()
        except KeyError:
            raise ValueError(
                f"unknown policy {policy!r}; known: {sorted(POLICIES)}"
            ) from None
    raise TypeError(f"policy must be a Policy, name or None, got {policy!r}")
