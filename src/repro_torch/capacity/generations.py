"""Hardware-generation turnover: the demand driver that breaks per-pool
planning (paper §2.3).

Fleet demand is user workload growth x hardware generational turnover x
software efficiency.  A generation launch moves demand *volume* between
pools: the old family's trace decays and the successor's grows along a
logistic S-curve, scaled by the generational perf-per-dollar uplift (the
same work needs fewer successor VMs).  To a per-pool forecaster a
migration looks like organic decay, and commitments pinned to the dying
family strand.

This module is the generative side (the inference side is
``repro_torch.core.migration``):

* per-cloud successor edges from ``pricing.GENERATIONS`` matched onto a
  fleet's (cloud, region, machine-family) pool keys
  (:func:`migration_edges`);
* cumulative adoption as a logistic S-curve (the reference's explicit
  exp/add/divide sigmoid, ``sigmoid_ref``, which the pass, its loop
  oracle and the kernel all round alike) and the multiplicative software
  deflator (1 + rate)^(-t/year) (§2.4);
* :func:`migrate_demand`, the turnover of a (P, T) base matrix: one launch
  of the hand-written turnover kernel on the card
  (``kernels/generation_turnover``), its plain version on the CPU.  The
  reference walks it as a ``lax.scan`` over hours whose carry is the
  closed-form share, so every hour stands alone;
  :func:`migrate_demand_loop` replays the reference's step hour by hour,
  the independent oracle the pass is held to bit for bit;
* :func:`migrate_pool_set`, the PoolSet-level transform
  ``data.traces.synthetic_pool_set(migration=...)`` routes through.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch

from repro_torch.capacity import pricing
from repro_torch.core import demand as dm
from repro_torch.core.demand import DAYS_PER_YEAR, HOURS_PER_DAY, HOURS_PER_WEEK
from repro_torch.device import resolve_device
from repro_torch.kernels.generation_turnover import ops as turnover_ops
from repro_torch.kernels.generation_turnover.ref import sigmoid_ref

pricing.validate_tables()

HOURS_PER_YEAR = HOURS_PER_DAY * DAYS_PER_YEAR

# Logistic 10%->90% span in units of 1/rate: s(mid +/- ln(9)/k) = 0.9/0.1.
_LOGISTIC_1090 = 2.0 * math.log(9.0)


@dataclasses.dataclass(frozen=True)
class MigrationConfig:
    """Knobs of the generation-turnover model.

    ``generations`` is the successor table (default: the
    ``pricing.GENERATIONS`` rows); ``software_efficiency_per_year`` the
    multiplicative deflator rate (§2.4); ``share_prior_weight`` the weight,
    in hours of observations, of the table's announced launch epochs as a
    prior on the rolling logit-share fits (0 fits the data alone)."""

    generations: tuple[pricing.Generation, ...] = tuple(pricing.GENERATIONS)
    software_efficiency_per_year: float = pricing.SOFTWARE_EFFICIENCY_PER_YEAR
    share_prior_weight: float = 100.0

    def __post_init__(self):
        # Planted rows satisfy the static table's structural invariants: a
        # duplicate source would move more than 100% of a pool's volume
        # (negative demand), a chained edge is not modelled, and
        # non-positive spans or uplifts make the logistic degenerate.
        seen_src: set[tuple[str, str]] = set()
        for g in self.generations:
            if g.span_weeks <= 0 or g.perf_uplift <= 0 or g.launch_week < 0:
                raise ValueError(
                    f"generation epochs/uplift must be positive: {g}"
                )
            if g.old_family == g.new_family:
                raise ValueError(f"generation must change family: {g}")
            src = (g.cloud, g.old_family)
            if src in seen_src:
                raise ValueError(
                    f"duplicate generation source {src}: two edges would "
                    "migrate more than 100% of the pool's volume"
                )
            seen_src.add(src)
        seen_dst: set[tuple[str, str]] = set()
        for g in self.generations:
            dst = (g.cloud, g.new_family)
            if dst in seen_dst:
                raise ValueError(
                    f"duplicate generation successor {dst}: the share "
                    "decomposition attributes a successor pool to exactly "
                    "one pair"
                )
            seen_dst.add(dst)
        new_fams = {(g.cloud, g.new_family) for g in self.generations}
        for g in self.generations:
            if (g.cloud, g.old_family) in new_fams:
                raise ValueError(
                    "chained generations are not modelled (a source is "
                    f"another edge's successor): {g}"
                )
        if self.share_prior_weight < 0:
            raise ValueError(
                f"share_prior_weight must be >= 0: {self.share_prior_weight}"
            )
        if not 0.0 <= self.software_efficiency_per_year < 1.0:
            raise ValueError(
                "software_efficiency_per_year must be in [0, 1): "
                f"{self.software_efficiency_per_year}"
            )


def resolve_migration(migration) -> MigrationConfig | None:
    """Normalize the planner-facing ``migration=`` argument: None/False
    disables, True takes the default :class:`MigrationConfig`, a
    MigrationConfig passes through."""
    if migration is None or migration is False:
        return None
    if migration is True:
        return MigrationConfig()
    if isinstance(migration, MigrationConfig):
        return migration
    raise TypeError(
        f"migration must be None/bool/MigrationConfig, got {migration!r}"
    )


@dataclasses.dataclass(frozen=True)
class MigrationEdges:
    """Generation edges matched onto one fleet's pool axis, as (G,) tensors
    on one device: edge g moves demand from pool ``src[g]`` to pool
    ``dst[g]`` (same cloud and region) along a logistic with midpoint
    ``midpoint_hours[g]`` and rate ``rate_per_hour[g]``; one unit of
    old-family demand becomes ``inv_gain[g]`` = 1 / (1 + ``uplift[g]``)
    units on the successor (precomputed, as in the reference, so every
    consumer multiplies by the same rounded value)."""

    src: torch.Tensor             # (G,) int64 pool index of the old family
    dst: torch.Tensor             # (G,) int64 pool index of the successor
    uplift: torch.Tensor          # (G,) float32 perf-per-dollar uplift
    inv_gain: torch.Tensor        # (G,) float32 1 / (1 + uplift)
    midpoint_hours: torch.Tensor  # (G,) float32 logistic midpoint, hours
    rate_per_hour: torch.Tensor   # (G,) float32 logistic rate, 1/hours

    @property
    def num_edges(self) -> int:
        return self.src.shape[0]

    @property
    def device(self) -> torch.device:
        return self.src.device


def migration_edges(
    keys: Sequence[dm.PoolKey],
    cfg: MigrationConfig = MigrationConfig(),
    *,
    device: "torch.device | str | None" = None,
) -> MigrationEdges:
    """Match the successor table onto a fleet, on ``device`` (``None`` =
    the card): an edge exists wherever both the old-family and the
    new-family pool of one (cloud, region) are present.  Pools without a
    matched edge do not migrate."""
    dev = resolve_device(device)
    index = {tuple(k): i for i, k in enumerate(keys)}
    src, dst, up, mid, rate = [], [], [], [], []
    for g in cfg.generations:
        regions = {k[1] for k in index if k[0] == g.cloud}
        for r in sorted(regions):
            old = index.get((g.cloud, r, g.old_family))
            new = index.get((g.cloud, r, g.new_family))
            if old is None or new is None:
                continue
            src.append(old)
            dst.append(new)
            up.append(g.perf_uplift)
            mid.append(g.midpoint_week * HOURS_PER_WEEK)
            rate.append(_LOGISTIC_1090 / (g.span_weeks * HOURS_PER_WEEK))

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=dev)

    up_t = f32(up)
    return MigrationEdges(
        src=torch.tensor(src, dtype=torch.int64, device=dev),
        dst=torch.tensor(dst, dtype=torch.int64, device=dev),
        uplift=up_t,
        inv_gain=1.0 / (1.0 + up_t),
        midpoint_hours=f32(mid),
        rate_per_hour=f32(rate),
    )


def adoption_shares(edges: MigrationEdges, t_hours) -> torch.Tensor:
    """(G, T) closed-form cumulative adoption s_g(t): the share of edge g's
    base volume migrated to the successor by hour t."""
    t = torch.as_tensor(t_hours, dtype=torch.float32, device=edges.device)
    return sigmoid_ref(
        edges.rate_per_hour[:, None]
        * (t[None, :] - edges.midpoint_hours[:, None])
    )


def software_deflator(t_hours, rate_per_year: float) -> torch.Tensor:
    """(T,) multiplicative software-efficiency deflator: the same user work
    needs (1 + rate)^(-t/year) VMs as engine improvements land (§2.4).
    Float32, as in the reference: log1p of the rate in float32, divided by
    the hours of a year, times t."""
    t = torch.as_tensor(t_hours, dtype=torch.float32)
    rate = torch.tensor(rate_per_year, dtype=torch.float32, device=t.device)
    return torch.exp(-torch.log1p(rate) / HOURS_PER_YEAR * t)


def _sw_log(sw_rate: float) -> float:
    """The hourly log drift as the reference's Python float64 scalar (used
    as float32 by every consumer)."""
    return math.log1p(sw_rate) / HOURS_PER_YEAR


def migrate_demand(
    base: torch.Tensor,
    edges: MigrationEdges,
    *,
    sw_rate: float = pricing.SOFTWARE_EFFICIENCY_PER_YEAR,
) -> torch.Tensor:
    """Generation turnover and the software deflator applied to a (P, T)
    base demand matrix on ``edges``' device: one launch of the turnover
    kernel on the card, the plain version on the CPU
    (``kernels/generation_turnover/ops.py``)."""
    base = torch.as_tensor(base, dtype=torch.float32).to(edges.device)
    return turnover_ops.turnover(
        base, edges.src, edges.dst, edges.inv_gain, edges.midpoint_hours,
        edges.rate_per_hour, _sw_log(sw_rate),
    )


def _mig_step(edges: MigrationEdges, sw_log: float, m, b, tf):
    """One hour of the reference's scan (``_mig_step``): place the column
    b (P,) by the carried migrated shares ``m`` (G,) at hour ``tf`` (a 0-d
    float32 tensor), then advance the carry to the next hour's closed-form
    share.  Returns (m_next, column (P,))."""
    moved = b[edges.src] * m
    col = b.clone()
    col[edges.src] = b[edges.src] + (-moved)
    col[edges.dst] = col[edges.dst] + moved * edges.inv_gain
    eff = torch.exp(-sw_log * tf)
    m_next = sigmoid_ref(
        edges.rate_per_hour * (tf + 1.0 - edges.midpoint_hours)
    )
    return m_next, col * eff


def migrate_demand_loop(
    base: torch.Tensor,
    edges: MigrationEdges,
    *,
    sw_rate: float = pricing.SOFTWARE_EFFICIENCY_PER_YEAR,
) -> torch.Tensor:
    """The same turnover replayed hour by hour, the reference's scan step
    dispatched once per hour with its carried share: the independent
    oracle :func:`migrate_demand` is held to bit for bit."""
    base = torch.as_tensor(base, dtype=torch.float32).to(edges.device)
    m = adoption_shares(edges, torch.zeros(1))[:, 0]
    sw_log = _sw_log(sw_rate)
    hours = torch.arange(base.shape[1], dtype=torch.float32,
                         device=base.device)
    out = torch.empty_like(base)
    for t in range(base.shape[1]):
        m, out[:, t] = _mig_step(edges, sw_log, m, base[:, t], hours[t])
    return out


def migrate_pool_set(
    pools: dm.PoolSet,
    cfg: MigrationConfig = MigrationConfig(),
    *,
    device: "torch.device | str | None" = None,
) -> dm.PoolSet:
    """PoolSet-level turnover on ``device`` (``None`` = the card): same
    keys and configs, demand run through :func:`migrate_demand` on the
    edges the successor table matches onto this fleet, back on the host."""
    edges = migration_edges(pools.keys, cfg, device=device)
    demand = migrate_demand(
        torch.from_numpy(pools.demand), edges,
        sw_rate=cfg.software_efficiency_per_year,
    )
    return dm.PoolSet(
        keys=pools.keys, demand=demand.cpu().numpy(), configs=pools.configs
    )
