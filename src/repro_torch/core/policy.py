"""Commitment policies behind the rolling replay (paper §3.3.3 + baselines).

The weekly replay in :mod:`repro_torch.core.replan` (and the tournament's
lean replay in :mod:`repro_torch.core.tournament`) is a harness: roll
expired tranches off, let a *policy* pick this week's per-pool target
stack, buy only the increments, bill the week.  A policy is two phases:
``setup(ctx)`` runs once per replay and returns ``(pstate0, decide)``;
``decide`` is called once per week:

    pstate, Decision(targets, floor, yhat, is_decision)
        = decide(pstate, Observation(week, active, d_prev))

    RollingPortfolioPolicy   the paper's Algorithm 1 loop: weekly prefix
                             refit -> per-horizon thresholds -> monotone
                             stack.
    OneShotPolicy            a single decision week (what the one-shot
                             planner prices at t0).
    HindsightPolicy          non-causal: the optimal constant stack on the
                             realized demand, rebought weekly.
    DeterministicHedgePolicy the break-even online algorithm of Ambati,
    RandomizedHedgePolicy    Urgaonkar & Sitaraman, *Hedge Your Bets*
                             (arXiv 2004.04302): forecast-free ski rental
                             per capacity band.

``is_decision`` is a host bool under the weekly cadence rule, which
depends on the week number only, so deciding it needs nothing from the
device.  Under ``cadence_mode="breach"`` the rolling policy decides from
realized demand instead, and ``is_decision`` is a per-row (R,) bool
tensor on the device, uniform within each scenario block.

The hedging policies cut the candidate range [0, top) of each pool into
``grid_size`` bands; each band accrues the on-demand spend it would have
absorbed while uncovered by a commitment, and is committed (into the
pool's cheapest available SKU) once that spend reaches ``z x`` its buy
price.  ``z = 1`` is the deterministic break-even rule; the randomized
variant draws ``z`` per band from the density ``e^z / (e - 1)`` on (0, 1].
A band's meter is a float32 running sum, so a meter that lands within
rounding of its price may cross it a week earlier or later than the
reference's, whose sums run in another order.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core import forecast as fc
from repro_torch.core import portfolio as pf
from repro_torch.core.demand import HOURS_PER_WEEK
from repro_torch.core.planner import _monotone_stack, _prefix_weighted_quantiles

#: The hedges' competitive-ratio guarantees (Hedge Your Bets): break-even
#: ski rental is 2-competitive, the randomized rule e/(e-1) in expectation.
DETERMINISTIC_CR_BOUND = 2.0
RANDOMIZED_CR_BOUND = math.e / (math.e - 1.0)


@dataclasses.dataclass
class PolicyContext:
    """Everything a policy may consult, assembled once per replay by
    ``replan.replan_fleet_pools`` or :func:`make_context`.  Tensors live on
    the replay's device; ``solve_fn``/``targets_for``/``compose_forecast``
    are callables of the harness.  Rows are pools, or (path, pool) pairs
    flattened path-major when the harness batches demand paths."""

    demand: torch.Tensor         # (P, T) whole-week demand, history + eval
    options: list
    clouds: tuple[str, ...]
    od: float
    rates: torch.Tensor          # (K,) committed rates
    term_weeks: torch.Tensor     # (K,) int64 terms
    avail: torch.Tensor          # (P, K) bool: option sold on the pool's cloud
    qs: torch.Tensor             # (P, K) handover fractiles
    w_hours: torch.Tensor        # (H,) horizon prefix lengths in hours
    start_weeks: int
    cadence_weeks: int
    horizon_weeks: int
    total_weeks: int
    state: fc.PrefixFitState
    solve_fn: Callable           # (state, week) -> beta  (scan or loop)
    irls_iters: int = 0
    #: carry the IRLS weight-adjustment moments in the policy state
    #: (frozen-weights incremental IRLS) instead of full masked passes per
    #: week (``fc.irls_carry_init``)
    irls_carry: bool = False
    # yhat (P, Wh*168) -> (targets (P, K), spot floor (P,) | None)
    targets_for: Callable | None = None
    # (yhat, week) -> yhat: the migration band's recomposition of pair-total
    # forecasts into per-pool forecasts (None without the band)
    compose_forecast: Callable | None = None
    #: the rows hold this many demand paths that each draw a policy's
    #: random thresholds afresh from its seed, as the reference's one
    #: context per tournament path does (1: one draw over all rows, as its
    #: scenario-batched replay does)
    path_blocks: int = 1
    #: "weekly" (the harness cadence rule) or "breach": re-solve only in
    #: weeks where last week's realized demand left the band held since
    #: the previous decision (and in the start week)
    cadence_mode: str = "weekly"
    #: (q_lo, q_hi) fractile pair of the breach band
    breach_band: tuple = (0.05, 0.95)
    #: a week breaches when more than ``breach_tolerance`` x the nominal
    #: miss mass of its 168 hours leave the band
    breach_tolerance: float = 4.0
    #: scenario blocks of the rows: a breach decision is fleet-wide per
    #: scenario, reduced over each block of ``num_pools / scenario_blocks``
    scenario_blocks: int = 1

    @property
    def num_pools(self) -> int:
        return self.demand.shape[0]

    @property
    def num_options(self) -> int:
        return self.qs.shape[-1]

    @property
    def horizon_hours(self) -> int:
        return self.horizon_weeks * HOURS_PER_WEEK


class Observation(NamedTuple):
    """Per-week inputs the harness hands to ``decide``."""

    week: int                     # absolute week index
    active: torch.Tensor          # (P, K) committed stack after roll-offs
    #: (P, 168) last week's realized demand; None unless the policy sets
    #: ``needs_prev_demand`` or the cadence is "breach"
    d_prev: torch.Tensor | None = None
    #: (P, TRAIL_WEEKS*168) trailing realized demand, the anchor of
    #: ``fc.anchored_fractile_levels``; gathered only under the breach
    #: cadence or calibration telemetry
    d_trail: torch.Tensor | None = None


class Decision(NamedTuple):
    """Per-week outputs of ``decide``."""

    targets: torch.Tensor         # (P, K) absolute stack widths to hold
    floor: torch.Tensor | None    # (P,) spot floor (forecasting + spot only)
    yhat: torch.Tensor | None     # (P, H) forecast (None = non-forecasting)
    #: may this week buy?  A host bool, or a per-row (P,) bool tensor
    #: under ``cadence_mode="breach"``
    is_decision: "bool | torch.Tensor"
    #: extra per-week tensors the harness forwards into the outputs (the
    #: breach band held, ``band_lo``/``band_hi``); None otherwise
    extras: dict | None = None


class Policy:
    """Base policy: subclass and implement :meth:`setup`."""

    name: str = "policy"
    #: produces a forecast (yhat), which the spot, migration and
    #: convertible bands key on
    forecasting: bool = False
    #: wants last week's realized demand in the Observation
    needs_prev_demand: bool = False

    def setup(self, ctx: PolicyContext) -> tuple[Any, Callable]:
        raise NotImplementedError

    def _is_decision(self, ctx: PolicyContext, w: int) -> bool:
        """The harness cadence rule: every ``cadence_weeks`` from the start
        week; ``cadence_weeks == 0`` means the single start week (the
        one-shot baseline replay)."""
        if ctx.cadence_weeks > 0:
            return (w - ctx.start_weeks) % ctx.cadence_weeks == 0
        return w == ctx.start_weeks

    def __repr__(self) -> str:
        return f"{type(self).__name__}()"


class RollingPortfolioPolicy(Policy):
    """The paper's rolling loop as a policy: re-fit the forecaster on the
    week-``w`` prefix, forecast the horizon (recomposed from pair totals
    and shares by ``ctx.compose_forecast`` under the migration band), and
    run Algorithm 1 steps 2-4 for the target stack."""

    name = "rolling_portfolio"
    forecasting = True

    def setup(self, ctx: PolicyContext):
        carry_irls = ctx.irls_carry and ctx.irls_iters > 0
        breach = ctx.cadence_mode == "breach"
        # Carried IRLS: the policy state starts from the exact adjustment
        # moments on the start prefix; each week solves against prefix +
        # carried moments and appends only the newest week's block.
        inner0 = (fc.irls_carry_init(ctx.state, ctx.start_weeks,
                                     ctx.irls_iters)
                  if carry_irls else ())
        if breach:
            q_lo, q_hi = ctx.breach_band
            # Integer hour budgets: a week breaches when strictly more than
            # tolerance x the nominal miss mass of its 168 hours leave the
            # band, so a host loop over the emitted bands reproduces the
            # mask exactly.
            allow_above = int(
                ctx.breach_tolerance * (1.0 - q_hi) * HOURS_PER_WEEK)
            allow_below = int(ctx.breach_tolerance * q_lo * HOURS_PER_WEEK)
            blocks = ctx.scenario_blocks
            rows_per = ctx.num_pools // blocks
            zeros = torch.zeros(ctx.num_pools, dtype=torch.float32,
                                device=ctx.demand.device)
            pstate0 = (inner0, (zeros, zeros))
        else:
            pstate0 = inner0

        def decide(pstate, obs: Observation):
            w = obs.week
            inner, (lo, hi) = pstate if breach else (pstate, (None, None))
            if carry_irls:
                g_adj, r_adj = inner
                beta = fc.solve_prefix_adjusted(ctx.state, w, g_adj, r_adj)
                inner = fc.irls_carry_extend(ctx.state, beta, g_adj, r_adj,
                                             w)
            else:
                beta = ctx.solve_fn(ctx.state, w)
                beta = fc.irls_refine(ctx.state, beta, w, ctx.irls_iters)
            yhat = fc.predict_from_beta(
                ctx.state, beta, w * HOURS_PER_WEEK, ctx.horizon_hours
            )
            if ctx.compose_forecast is not None:
                yhat = ctx.compose_forecast(yhat, w)
            targets, floor = ctx.targets_for(yhat)
            if not breach:
                return inner, Decision(
                    targets, floor, yhat, self._is_decision(ctx, w)
                )
            # Breach of the band held since the last decision week, on the
            # most recent completed week; any breaching pool re-solves its
            # whole scenario block.  All on the device: no host sync.
            above = (obs.d_prev > hi[:, None]).sum(-1)
            below = (obs.d_prev < lo[:, None]).sum(-1)
            is_dec = (above > allow_above) | (below > allow_below)
            if w == ctx.start_weeks:
                is_dec = torch.ones_like(is_dec)
            scen = is_dec.reshape(blocks, rows_per).any(dim=1)
            is_dec = scen[:, None].expand(blocks, rows_per).reshape(-1)
            band = fc.anchored_fractile_levels(obs.d_trail, (q_lo, q_hi))
            lo = torch.where(is_dec, band[:, 0], lo)
            hi = torch.where(is_dec, band[:, 1], hi)
            return (inner, (lo, hi)), Decision(
                targets, floor, yhat, is_dec, {"band_lo": lo, "band_hi": hi}
            )

        return pstate0, decide


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


def _hedge_threshold(u: torch.Tensor) -> torch.Tensor:
    """Inverse CDF of the density e^z/(e-1) on (0, 1]: the classical
    randomized ski-rental threshold distribution."""
    return torch.log1p(u * (math.e - 1.0))


class DeterministicHedgePolicy(Policy):
    """Ambati et al.'s break-even hedging rule per capacity band.

    The candidate range [0, ``top_multiplier`` x history peak) of each
    pool is split into ``grid_size`` equal bands.  A band accrues the
    on-demand spend it absorbed last week whenever it sits above the
    committed stack top; once the accrued spend reaches ``z x`` the band's
    buy price (rate x term, the term capped at the replay window, of the
    pool's cheapest available SKU) the band is committed and its meter
    resets.  No forecast, no solver; decisions fire every week, whatever
    the harness cadence."""

    name = "deterministic_hedge"
    needs_prev_demand = True

    def __init__(self, grid_size: int = 32, top_multiplier: float = 1.5):
        if grid_size < 1:
            raise ValueError(f"grid_size must be >= 1, got {grid_size}")
        if top_multiplier <= 0:
            raise ValueError(
                f"top_multiplier must be > 0, got {top_multiplier}"
            )
        self.grid_size = int(grid_size)
        self.top_multiplier = float(top_multiplier)

    def _thresholds(self, num_pools: int) -> torch.Tensor:
        """(num_pools, G) float32 thresholds z on the CPU."""
        return torch.ones((num_pools, self.grid_size), dtype=torch.float32)

    def _band_spend(self, d, levels, dg, od):
        """(P, G) on-demand spend each band would have absorbed over the
        demand block ``d`` (P, T): od x the band's clipped occupancy,
        summed over the hours.  The (P, G, T) occupancy lives for one call,
        so callers pass blocks of at most a week."""
        occ = torch.minimum(
            torch.clamp(d[:, None, :] - levels[:, :, None], min=0.0),
            dg[:, None, None],
        )
        return od * occ.sum(-1)

    def setup(self, ctx: PolicyContext):
        num_p, num_k, g = ctx.num_pools, ctx.num_options, self.grid_size
        dev = ctx.demand.device
        hist = ctx.demand[:, : ctx.start_weeks * HOURS_PER_WEEK]
        top = torch.clamp(hist.amax(-1), min=1e-6) * self.top_multiplier
        dg = top / g                                             # (P,)
        levels = dg[:, None] * torch.arange(g, dtype=torch.float32,
                                            device=dev)[None, :]
        # One designated SKU per pool: the cheapest rate sold on its cloud.
        rate_eff = torch.where(ctx.avail, ctx.rates[None, :], torch.inf)
        kstar = torch.argmin(rate_eff, dim=-1)                   # (P,)
        onehot = torch.nn.functional.one_hot(kstar, num_k).to(torch.float32)
        # A stranded tranche bills at most min(term, window) weeks inside
        # the replay, so the ski rental prices the buy at that.
        eff_term = torch.clamp(ctx.term_weeks[kstar],
                               max=ctx.total_weeks - ctx.start_weeks
                               ).to(torch.float32)
        buy_unit = ctx.rates[kstar] * eff_term * HOURS_PER_WEEK  # (P,)
        band_price = buy_unit * dg                               # (P,)
        blocks = ctx.path_blocks
        z = self._thresholds(num_p // blocks).repeat(blocks, 1).to(dev)
        price = z * band_price[:, None]                          # (P, G)
        # Pre-accrue the uncommitted history [0, start-1) week by week: the
        # first decision's Observation carries week start-1.
        a0 = torch.zeros((num_p, g), dtype=torch.float32, device=dev)
        for wk in range(max(ctx.start_weeks - 1, 0)):
            a0 = a0 + self._band_spend(
                hist[:, wk * HOURS_PER_WEEK:(wk + 1) * HOURS_PER_WEEK],
                levels, dg, ctx.od)

        def decide(pstate, obs: Observation):
            accrued = pstate
            stack_top = obs.active.sum(-1)                       # (P,)
            covered = levels + dg[:, None] <= stack_top[:, None] + 1e-6
            spend = self._band_spend(obs.d_prev, levels, dg, ctx.od)
            accrued = torch.where(covered, accrued, accrued + spend)
            commit = ~covered & (accrued >= price)
            accrued = torch.where(commit, 0.0, accrued)
            width = dg * commit.sum(-1)                          # (P,)
            targets = (stack_top + width)[:, None] * onehot      # (P, K)
            return accrued, Decision(targets, None, None, True)

        return a0, decide


class RandomizedHedgePolicy(DeterministicHedgePolicy):
    """The randomized variant: each band draws its own threshold ``z`` from
    the density e^z/(e-1) on (0, 1] at setup, lowering the expected
    competitive ratio from 2 to e/(e-1) against an oblivious adversary.
    The uniforms come from a CPU ``torch.Generator`` seeded ``seed``, so
    the card and the CPU draw the same thresholds."""

    name = "randomized_hedge"

    def __init__(
        self,
        grid_size: int = 32,
        top_multiplier: float = 1.5,
        seed: int = 0,
    ):
        super().__init__(grid_size=grid_size, top_multiplier=top_multiplier)
        self.seed = int(seed)

    def _thresholds(self, num_pools: int) -> torch.Tensor:
        gen = torch.Generator().manual_seed(self.seed)
        u = torch.rand((num_pools, self.grid_size), generator=gen)
        return _hedge_threshold(u)


POLICIES: dict[str, Callable[[], Policy]] = {
    "rolling_portfolio": RollingPortfolioPolicy,
    "one_shot": OneShotPolicy,
    "hindsight": HindsightPolicy,
    "deterministic_hedge": DeterministicHedgePolicy,
    "randomized_hedge": RandomizedHedgePolicy,
}


def get_policy(policy: "Policy | str | None") -> Policy:
    """Resolve the ``policy=`` planner kwarg: None -> the paper's rolling
    loop, a registry name -> a fresh instance, an instance -> itself."""
    if policy is None:
        return RollingPortfolioPolicy()
    if isinstance(policy, Policy):
        return policy
    if isinstance(policy, str):
        try:
            return POLICIES[policy]()
        except KeyError:
            raise ValueError(
                f"unknown policy {policy!r}; known: {sorted(POLICIES)}"
            ) from None
    raise TypeError(f"policy must be a Policy, name or None, got {policy!r}")


def make_context(
    demand: torch.Tensor,
    options: list | None = None,
    *,
    clouds: tuple[str, ...],
    od_rate: float,
    term_weighting: float = 0.0,
    cfg: fc.ForecastConfig = fc.ForecastConfig(),
    start_weeks: int,
    cadence_weeks: int = 1,
    horizon_weeks: int = 8,
    solve_fn: Callable | None = None,
    path_blocks: int = 1,
) -> PolicyContext:
    """The lean context the tournament runs policies against: the quantile
    solver only (no spot band, no migration, no grid sweep), on the device
    of ``demand`` (R, T).  ``clouds`` names each row's cloud; the rows may
    hold ``path_blocks`` demand paths stacked path-major."""
    options = options if options is not None else pf.options_from_pricing()
    demand = torch.as_tensor(demand, dtype=torch.float32)
    dev = demand.device
    total_weeks = demand.shape[-1] // HOURS_PER_WEEK
    demand = demand[:, : total_weeks * HOURS_PER_WEEK]
    horizon_hours = horizon_weeks * HOURS_PER_WEEK
    al, be, avail = pf.pool_option_lines(
        options, clouds, term_weighting=term_weighting, od_rate=od_rate,
        device=dev,
    )
    qs = pf.handover_fractiles(al, be, od_rate=od_rate)
    term_weeks = torch.tensor([o.term_weeks for o in options],
                              dtype=torch.int64, device=dev)
    w_hours = torch.arange(1, horizon_weeks + 1, device=dev) * HOURS_PER_WEEK
    state = fc.prefix_fit_state(
        demand, cfg, horizon_hours=horizon_hours,
        min_prefix_hours=start_weeks * HOURS_PER_WEEK,
    )

    def targets_for(yhat):
        per_h = _prefix_weighted_quantiles(yhat, w_hours, qs)
        widths, _ = _monotone_stack(per_h, qs, term_weeks, horizon_weeks)
        return widths, None

    return PolicyContext(
        demand=demand, options=options, clouds=tuple(clouds), od=od_rate,
        rates=torch.tensor([o.rate for o in options], dtype=torch.float32,
                           device=dev),
        term_weeks=term_weeks, avail=torch.as_tensor(avail, device=dev),
        qs=qs, w_hours=w_hours, start_weeks=start_weeks,
        cadence_weeks=cadence_weeks, horizon_weeks=horizon_weeks,
        total_weeks=total_weeks, state=state,
        solve_fn=solve_fn if solve_fn is not None else fc.solve_prefix,
        targets_for=targets_for, path_blocks=path_blocks,
    )
