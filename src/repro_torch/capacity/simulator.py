"""A spot-enabled plan replayed against sampled revocation paths.

The planners price the spot band at an expected effective rate
(``core.spot``).  :func:`replay_spot_plan` is the realized counterpart: it
samples revocation paths for the plan's pools (``capacity.preemption``)
and bills each draw, all on the device the plan ran on.  Only the spot
replay of the reference's ``capacity/simulator.py`` is ported; the fleet
simulation entry points come with ROADMAP Queue 1, item 15.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.capacity import preemption as pe
from repro_torch.capacity.pricing import on_demand_premium
from repro_torch.core import demand as dm


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

    Scenario batches are not ported (ROADMAP Queue 1, item 12), so the
    realized trace, ``scenario=0``, is the only index."""
    if report.spot_floor is None:
        raise ValueError("report has no spot band; re-plan with spot=...")
    if scenario != 0:
        raise ValueError(
            f"scenario index {scenario} out of range for a report with "
            "1 scenario(s)"
        )
    cfg, lines = report.spot_config, report.spot_lines
    dev = lines.rate.device
    demand, spot_dem = _spot_demand(pools.demand, report.spot_floor,
                                    report.start_weeks, dev)

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    paths = pe.simulate_revocations(lines.params, demand.shape[1],
                                    num_draws=num_draws, generator=gen)
    # The committed and mid-band on-demand bill is path independent: read
    # it off the report.
    base = float(report.committed_cost.sum() + report.on_demand_cost.sum())
    return _bill_paths(paths, demand, spot_dem, lines.market_rate,
                       cfg.requeue_hours, cfg.availability_target, base,
                       report.total_cost)


def _spot_demand(demand, spot_floor, start_weeks, device):
    """(demand, spot demand), (P, T) float32 on ``device``: the replayed
    weeks' hourly demand from ``start_weeks`` on, and what of it lies above
    the week's spot floor ``spot_floor`` (S, P), broadcast to its hours."""
    wk = dm.HOURS_PER_WEEK
    floor = torch.from_numpy(np.array(spot_floor, np.float32)).to(device)
    s = floor.shape[0]
    t0 = start_weeks * wk
    demand = torch.as_tensor(
        np.ascontiguousarray(demand[:, t0:t0 + s * wk]),
        dtype=torch.float32).to(device)
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
