"""Time shifting of deferrable workloads into commitment troughs (paper §4).

Given a demand series and a commitment level, the *trough capacity*
u(t) = max(c - f(t), 0) is already paid for.  Deferrable and
interruptible internal workloads (eval jobs, checkpoint-replay regression
suites, compile farms) can move into those troughs instead of riding the
peak at on-demand rates.

A job j has arrival a_j, total work w_j (chip-hours), deadline d_j, and
may be interruptible (run in disjoint hourly slices).  Shiftable jobs are
packed into trough capacity earliest-deadline-first; demand that cannot
shift is untouched.

:func:`schedule_jobs` is the host-side numpy scheduler of the capacity
layer, the reference's loop as it stands, so its placements are the
reference's bit for bit.  :func:`shift_demand` is the vectorized "fluid"
approximation (a fraction of the demand above the line is shiftable) the
fleet planner uses for what-if sweeps: a bisection water-fill on the
demand tensor's device with no host sync inside its loop.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import commitment as cm

#: bisection steps of the fluid water-fill (the reference's fori_loop)
FILL_ITERS = 40


@dataclasses.dataclass(frozen=True)
class Job:
    arrival: int        # hour index
    work: float         # chip-hours of work
    deadline: int       # must finish by this hour (exclusive)
    interruptible: bool = True
    deferrable: bool = True


def trough_capacity(f: np.ndarray, c: float) -> np.ndarray:
    return np.maximum(c - f, 0.0)


def schedule_jobs(
    base_demand: np.ndarray, c: float, jobs: list[Job]
) -> dict:
    """EDF-pack deferrable jobs into trough capacity (host numpy).

    Returns the new total demand series, the per-job placements, and the
    on-demand chip-hours avoided against running every job at its arrival
    hour."""
    t_len = len(base_demand)
    free = trough_capacity(base_demand, c).copy()
    placed = np.zeros(t_len)

    # Cost if jobs ran at arrival (work stacked on top of base at arrival).
    naive = base_demand.copy()
    for j in jobs:
        h = min(j.arrival, t_len - 1)
        naive[h] += j.work

    placements: list[tuple[Job, list[tuple[int, float]]]] = []
    for j in sorted(jobs, key=lambda j: j.deadline):
        slices: list[tuple[int, float]] = []
        remaining = j.work
        if j.deferrable:
            lo, hi = j.arrival, min(j.deadline, t_len)
            order = np.argsort(-free[lo:hi]) + lo  # fill deepest troughs first
            for h in order:
                if remaining <= 1e-12:
                    break
                take = min(free[h], remaining)
                if take <= 0:
                    continue
                free[h] -= take
                placed[h] += take
                slices.append((int(h), float(take)))
                remaining -= take
                if not j.interruptible and len(slices) > 1:
                    # a non-interruptible job must be one contiguous
                    # slice: fall back to arrival placement
                    for hh, tk in slices:
                        free[hh] += tk
                        placed[hh] -= tk
                    slices = []
                    remaining = j.work
                    break
        if remaining > 1e-12:
            h = min(j.arrival, t_len - 1)
            placed[h] += remaining
            slices.append((h, float(remaining)))
        placements.append((j, slices))

    shifted = base_demand + placed
    od_rate = cm.DEFAULT_A
    naive_over = np.maximum(naive - c, 0.0).sum() * od_rate
    shifted_over = np.maximum(shifted - c, 0.0).sum() * od_rate
    return {
        "demand": shifted,
        "placements": placements,
        "on_demand_cost_naive": float(naive_over),
        "on_demand_cost_shifted": float(shifted_over),
        "on_demand_savings": float(naive_over - shifted_over),
    }


def shift_demand(
    f: torch.Tensor, c: float, shiftable_frac: float
) -> torch.Tensor:
    """Fluid approximation on ``f``'s device: remove ``shiftable_frac`` of
    the demand *above* the commitment line and pour it into the troughs,
    deepest first, conserving total work.  Used by the fleet planner to
    estimate how much time shifting flattens the optimal commitment.

    The fill level comes from :data:`FILL_ITERS` bisection steps kept on
    the device (``torch.where`` on 0-d tensors), so the loop waits on
    nothing."""
    over = torch.clamp(f - c, min=0.0)
    movable = shiftable_frac * over
    f_cut = f - movable
    budget = movable.sum()
    # Trough room per hour; hours still above the line contribute none.
    # Without the clip negative "room" poisons the fill sums and the
    # conservation rescale divides by ~0, blowing demand up by ~1e12 when
    # the commitment sits low and the troughs cannot absorb the budget.
    room = torch.clamp(c - f_cut, min=0.0)
    placeable = torch.minimum(budget, room.sum())

    def fill_amount(level):
        return torch.minimum(torch.clamp(level - f_cut, min=0.0), room).sum()

    # Water-fill: the level L <= c whose clipped fill equals placeable.
    lo = f_cut.min()
    hi = torch.full_like(lo, c)
    for _ in range(FILL_ITERS):
        mid = 0.5 * (lo + hi)
        too_much = fill_amount(mid) > placeable
        lo, hi = torch.where(too_much, lo, mid), torch.where(too_much, mid, hi)
    level = 0.5 * (lo + hi)
    add = torch.minimum(torch.clamp(level - f_cut, min=0.0), room)
    # Exact conservation: scale the fill to the placeable budget; work the
    # troughs cannot absorb stays on the timeline, spread uniformly.
    add = add * (placeable / torch.clamp(add.sum(), min=1e-12))
    excess = (budget - placeable) / f.shape[-1]
    return f_cut + add + excess


def shiftable_supply_stats(f: np.ndarray, c: float) -> dict:
    """Paper §4: the optimal commitment leaves ~4.3% of committed capacity
    unused, concentrated on weekends and nights; report that supply."""
    unused = trough_capacity(f, c)
    total_commit = c * len(f)
    hours = np.arange(len(f))
    dow = (hours // 24) % 7
    weekend = unused[(dow >= 5)].sum()
    return {
        "unused_frac": float(unused.sum() / total_commit),
        "weekend_share": float(weekend / max(unused.sum(), 1e-12)),
        "unused_chip_hours": float(unused.sum()),
    }
