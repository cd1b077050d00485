"""Commitment laddering (paper §3.3.4): staggered tranches with fixed terms.

The cumulative committed level at time t is the sum of all active tranches.
Increments can be bought any period; reductions happen only by letting
tranches expire.  Host-side numpy, as in the reference: the replay hands
its per-week targets over once, after the loop over weeks.
:func:`ladder_vs_flat` (Fig 9) costs its scenarios on a device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import commitment as cm
from repro_torch.core.demand import HOURS_PER_WEEK
from repro_torch.device import resolve_device

# Increments below this are numerical dust, not purchases: both the host
# ladder planners and the rolling replay apply the same threshold so their
# tranche books agree.
PURCHASE_EPS = 1e-9


@dataclasses.dataclass(frozen=True)
class Ladder:
    """Tranches: arrays of (start_hour, term_hours, amount[, option]).

    ``option`` tags each tranche with the index of the purchasing option it
    was bought under (-1 = untagged/single-option ladders)."""

    start: np.ndarray   # (K,) int
    term: np.ndarray    # (K,) int
    amount: np.ndarray  # (K,) float
    option: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0,), int) - 1
    )                   # (K,) int, -1 = untagged

    def __post_init__(self):
        if self.option.shape != self.start.shape:
            if self.option.size:  # caller passed tags but mis-sized them
                raise ValueError(
                    f"option tags shape {self.option.shape} != tranche "
                    f"shape {self.start.shape}"
                )
            object.__setattr__(
                self, "option",
                np.full(self.start.shape, -1, int),
            )

    def active_level(self, num_hours: int, option: int | None = None):
        """Cumulative committed level for hours [0, num_hours); restricted
        to one option's tranches when ``option`` is given."""
        t = np.arange(num_hours)[:, None]
        active = (t >= self.start[None, :]) & (
            t < (self.start + self.term)[None, :]
        )
        if option is not None:
            active = active & (self.option[None, :] == option)
        return (active * self.amount[None, :]).sum(-1)

    def active_width(self, hour: int, option: int | None = None) -> float:
        """Committed width active at one hour.  A tranche (start, term) is
        live for hours [start, start+term)."""
        live = (hour >= self.start) & (hour < self.start + self.term)
        if option is not None:
            live = live & (self.option == option)
        return float((live * self.amount).sum())

    def option_widths(self, hour: int, num_options: int) -> np.ndarray:
        """(K,) active width per purchasing option at ``hour`` (untagged
        option=-1 tranches are excluded)."""
        live = (
            (hour >= self.start) & (hour < self.start + self.term)
            & (self.option >= 0)
        )
        out = np.zeros(num_options)
        np.add.at(out, self.option[live], self.amount[live])
        return out

    def extended(
        self, start: int, term: int, amount: float, option: int = -1
    ) -> "Ladder":
        return Ladder(
            start=np.append(self.start, start),
            term=np.append(self.term, term),
            amount=np.append(self.amount, amount),
            option=np.append(self.option, option),
        )


def empty_ladder() -> Ladder:
    z = np.zeros((0,))
    return Ladder(start=z.astype(int), term=z.astype(int), amount=z)


def plan_purchases(
    target_levels: np.ndarray,
    *,
    period_hours: int = HOURS_PER_WEEK,
    term_hours: int = 52 * HOURS_PER_WEEK,
    existing: Ladder | None = None,
) -> Ladder:
    """Buy, at the start of each period, the increment needed to lift the
    active ladder level up to that period's target (never selling).  Where
    the target is below the active level nothing is bought and the surplus
    persists until tranches expire (§3.3.4: "simply stop purchasing new
    commitments")."""
    ladder = existing or empty_ladder()
    for p in range(len(target_levels)):
        t0 = p * period_hours
        gap = float(target_levels[p]) - ladder.active_width(t0)
        if gap > PURCHASE_EPS:
            ladder = ladder.extended(t0, term_hours, gap)
    return ladder


def plan_portfolio_purchases(
    target_levels: np.ndarray,
    term_hours: np.ndarray,
    *,
    period_hours: int = HOURS_PER_WEEK,
    existing: Ladder | None = None,
) -> Ladder:
    """Portfolio laddering: per period, per option, buy the increment that
    lifts that option's active tranches up to its target band width.

    target_levels (W, K): per-period target width of each option's band.
    term_hours (K,): each option's own commitment term."""
    ladder = existing or empty_ladder()
    target_levels = np.asarray(target_levels)
    num_periods, num_options = target_levels.shape

    for p in range(num_periods):
        t0 = p * period_hours
        for k in range(num_options):
            # Single-hour active sample, O(tranches): an increment tops up
            # exactly the live width, never double-counting a tranche.
            gap = float(target_levels[p, k]) - ladder.active_width(t0, k)
            if gap > PURCHASE_EPS:
                ladder = ladder.extended(t0, int(term_hours[k]), gap, k)
    return ladder


@dataclasses.dataclass(frozen=True)
class PoolLadderBook:
    """Per-pool tranche stacks: one :class:`Ladder` per (cloud, region,
    machine-family) pool, aligned with ``keys``."""

    keys: tuple
    ladders: tuple[Ladder, ...]

    def __post_init__(self):
        if len(self.keys) != len(self.ladders):
            raise ValueError(
                f"{len(self.keys)} keys for {len(self.ladders)} ladders"
            )
        object.__setattr__(self, "keys", tuple(self.keys))
        object.__setattr__(self, "ladders", tuple(self.ladders))

    def ladder(self, key) -> Ladder:
        return self.ladders[self.keys.index(tuple(key))]

    def active_level(
        self, num_hours: int, option: int | None = None
    ) -> np.ndarray:
        """(P, T) committed level per pool (optionally one option's band)."""
        return np.stack([
            lad.active_level(num_hours, option=option)
            for lad in self.ladders
        ])

    def fleet_level(self, num_hours: int) -> np.ndarray:
        """(T,) fleet-total committed level."""
        return self.active_level(num_hours).sum(0)

    def option_widths(self, hour: int, num_options: int) -> np.ndarray:
        """(P, K) active width per pool per option at ``hour`` — the
        committed-stack snapshot the rolling replay carries; the two views
        must agree at every decision hour."""
        return np.stack([
            lad.option_widths(hour, num_options) for lad in self.ladders
        ])


def plan_pool_portfolio_purchases(
    pool_targets: np.ndarray,
    term_hours: np.ndarray,
    keys,
    *,
    period_hours: int = HOURS_PER_WEEK,
) -> PoolLadderBook:
    """Portfolio laddering across a fleet of pools, from empty books.

    pool_targets (P, W, K): per pool, per period, the target band width of
    each purchasing option.  Each pool buys exactly what
    :func:`plan_portfolio_purchases` would buy for it alone, but the
    periods step over all pools and options at once: an option's tranches
    share one term, so its live width at period p is the sum of its buys
    in the periods whose tranches still run at p.  (The per-pool loop
    costs ~40 s of host time on a 1024-pool, 3-year fleet.)"""
    targets = np.asarray(pool_targets, np.float64)
    keys = tuple(tuple(k) for k in keys)
    if targets.shape[0] != len(keys):
        raise ValueError(
            f"{len(keys)} keys for {targets.shape[0]} target rows"
        )
    num_pools, num_periods, num_options = targets.shape
    term_hours = np.asarray(term_hours, int)
    buys = np.zeros_like(targets)
    for p in range(num_periods):
        # tranche bought in period q < p is live at hour p * period_hours
        # while (p - q) * period_hours < its term
        lag = (p - np.arange(p)) * period_hours                  # (p,)
        live = lag[:, None] < term_hours[None, :]                # (p, K)
        active = (buys[:, :p, :] * live[None]).sum(1)            # (P, K)
        gap = targets[:, p] - active
        buys[:, p] = np.where(gap > PURCHASE_EPS, gap, 0.0)
    ladders = []
    for i in range(num_pools):
        q, k = np.nonzero(buys[i] > 0.0)      # (period, option) order
        ladders.append(Ladder(
            start=q * period_hours, term=term_hours[k],
            amount=buys[i, q, k], option=k,
        ))
    return PoolLadderBook(keys=keys, ladders=tuple(ladders))


def ladder_vs_flat(
    demand: np.ndarray,
    weekly_targets: np.ndarray,
    *,
    a: float = cm.DEFAULT_A,
    device: "torch.device | str | None" = None,
) -> dict:
    """Paper Fig 9 on ``device`` (``None`` = the card): Scenario A holds one
    flat optimal level over the whole window; Scenario B assumes perfect
    laddering (each week steps to its own target as tranches expire).
    Both are costed with Eq. (1), the objective the optimizer minimizes;
    the weekly costs are one evaluation over (W, 168) rows, summed on the
    host in week order.  The paper reports ~1.1% savings for its year-end
    window."""
    dev = resolve_device(device)
    num_weeks = len(weekly_targets)
    window = torch.as_tensor(
        np.asarray(demand)[: num_weeks * HOURS_PER_WEEK], dtype=torch.float32
    ).to(dev)
    flat_level = float(cm.optimal_commitment_quantile(window, a))
    flat_spend = float(cm.commitment_cost(window, flat_level, a))
    targets = torch.as_tensor(
        np.asarray(weekly_targets), dtype=torch.float32
    ).to(dev)
    weekly = cm.commitment_cost(
        window.reshape(num_weeks, HOURS_PER_WEEK), targets, a
    ).cpu().numpy()
    laddered_spend = 0.0
    for cost in weekly:
        laddered_spend += float(cost)
    return {
        "flat_level": flat_level,
        "flat_spend": flat_spend,
        "laddered_spend": laddered_spend,
        "savings_frac": 1.0 - laddered_spend / flat_spend,
    }


def expiration_profile(ladder: Ladder, num_hours: int) -> np.ndarray:
    """Capacity expiring per hour: the 'rolling downward expiration' that
    tells the planner how far the level decays on its own before new
    purchases are needed."""
    out = np.zeros(num_hours)
    ends = ladder.start + ladder.term
    for e, amt in zip(ends, ladder.amount):
        if 0 <= e < num_hours:
            out[e] += amt
    return out
