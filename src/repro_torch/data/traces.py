"""Loader for the released Shaved Ice dataset schema (paper §6) and the
calibrated synthetic fleet, with or without generation turnover.

The artifact publishes normalized hourly VM demand as CSV with columns
``timestamp, cloud, region, machine_type, normalized_count``;
:func:`load_dataset_csv` reads it onto one aligned hourly grid.  Without
it, the synthetic fleet stands in: 12 machine-type keys per cycle across 3
clouds and 4 regions, varying scale, growth and seasonality the way the
paper's §2 per-pool statistics do.  Pool ``i`` draws its noise from a CPU
``torch.Generator`` seeded with ``seed + i``.  The turnover fleet
(``migration=``) pairs old-family pools with their successors and moves
demand between them through ``capacity.generations`` (on the card by
default: one launch of the turnover kernel).

Two API levels, as in the reference: ``{(cloud, region, machine_type):
hourly ndarray}`` (:func:`load_dataset_csv`, :func:`synthetic_pools`,
:func:`load_pools`) and the aligned (P, T) :class:`~repro_torch.core.
demand.PoolSet` (:func:`synthetic_pool_set`, :func:`load_pool_set`).  All
host numpy; the planner moves demand onto its device.
"""

from __future__ import annotations

import csv
import os
from collections import defaultdict
from datetime import datetime

import numpy as np
import torch

from repro_torch.capacity import generations as gn
from repro_torch.core import demand as dm

DATASET_ENV = "SHAVEDICE_DATASET"


def _time_index(timestamps: set[str]) -> tuple[dict[str, int], int]:
    """(timestamp -> row index, grid length) for the alignment grid.

    ISO-8601 stamps get a contiguous hourly grid from the earliest to the
    latest observed stamp, so hours missing from every pool at once still
    occupy a slot (downstream code does hour arithmetic on indices).  Rare
    sub-hourly stamps snap to their nearest hour slot (snapped collisions
    are summed by the loader, like duplicate rows).  Unparseable stamps,
    or a systematically sub-hourly cadence, where snap-and-sum would
    inflate every pool's demand, fall back to the sorted union of observed
    stamps."""
    if not timestamps:
        raise ValueError(
            "dataset has no rows: an empty CSV defines no timestamp grid"
        )
    try:
        parsed = {ts: datetime.fromisoformat(ts) for ts in timestamps}
        # Anchor the grid on the earliest stamp's whole hour: anchoring on
        # a sub-hourly glitch verbatim would shift every whole-hour stamp
        # to a half-open offset and the rounding would merge hours.
        lo = min(parsed.values()).replace(minute=0, second=0, microsecond=0)
        offsets = {
            ts: (dt - lo).total_seconds() / 3600.0
            for ts, dt in parsed.items()
        }
    except (ValueError, TypeError):      # non-ISO stamps / mixed tz-ness
        grid = sorted(timestamps)
        return {ts: i for i, ts in enumerate(grid)}, len(grid)
    off_hour = sum(
        1 for o in offsets.values() if abs(o - round(o)) > 1e-9
    )
    if off_hour > max(1, len(offsets) // 20):
        # Systematically sub-hourly (e.g. a 30-minute export): keep each
        # sample in its own slot on the sorted-union grid instead.
        grid = sorted(timestamps)
        return {ts: i for i, ts in enumerate(grid)}, len(grid)
    index = {ts: int(round(o)) for ts, o in offsets.items()}
    return index, max(index.values()) + 1


def load_dataset_csv(path: str) -> dict[tuple[str, str, str], np.ndarray]:
    """{(cloud, region, machine_type): hourly float32 ndarray}, aligned.

    Every series lies on one shared grid (:func:`_time_index`); a pool
    contributes its ``normalized_count`` at the stamps it has rows for and
    0.0 at grid hours it is missing (no row means no recorded demand).
    Duplicate (timestamp, pool) rows are summed, as are distinct stamps
    that snap to the same hour slot.  Every array has the same length, so
    the mapping stacks into a (P, T) matrix (``PoolSet.from_dict``); an
    empty CSV raises."""
    series: dict[tuple[str, str, str], dict[str, float]] = defaultdict(
        lambda: defaultdict(float)
    )
    timestamps: set[str] = set()
    with open(path) as f:
        for row in csv.DictReader(f):
            key = (row["cloud"], row["region"], row["machine_type"])
            ts = row["timestamp"]
            series[key][ts] += float(row["normalized_count"])
            timestamps.add(ts)
    index, n = _time_index(timestamps)
    out = {}
    for key, by_ts in series.items():
        arr = np.zeros(n, np.float32)
        for ts, v in by_ts.items():
            arr[index[ts]] += v       # += : snapped stamps may share a slot
        out[key] = arr
    return out


def _pool_configs(num_pools: int) -> dict[tuple[str, str, str], dm.DemandConfig]:
    """Per-pool synthetic configs keyed like the released dataset.  Clouds
    are the paper's real three so pool keys line up with the Table-2
    purchase options."""
    clouds = ["aws", "azure", "gcp"]
    out = {}
    for i in range(num_pools):
        key = (clouds[i % 3], f"region_{i % 4}", f"type_{i:02d}")
        out[key] = dm.DemandConfig(
            base_level=40.0 * (1.5 ** (i % 4)),
            annual_growth=0.35 + 0.1 * (i % 5),
            diurnal_amplitude=0.10 + 0.02 * (i % 3),
            weekly_amplitude=0.12 + 0.02 * (i % 4),
        )
    return out


def synthetic_pools(
    num_pools: int = 12, num_hours: int = 24 * 365 * 3, seed: int = 0
) -> dict[tuple[str, str, str], np.ndarray]:
    """{key: hourly float32 trace} for ``num_pools`` synthetic pools."""
    cfgs = _pool_configs(num_pools)
    return {
        key: dm.synth_demand(
            num_hours, cfg,
            generator=torch.Generator().manual_seed(seed + i),
        ).numpy()
        for i, (key, cfg) in enumerate(cfgs.items())
    }


def _turnover_pool_configs(
    num_pools: int, cfg: gn.MigrationConfig
) -> dict[tuple[str, str, str], dm.DemandConfig]:
    """Per-pool configs of a fleet in generation turnover: (old family,
    successor family) pool pairs keyed by the successor table, replicated
    across regions until ``num_pools`` is reached.  The old-family pool
    carries the pair's base demand; the successor starts empty and
    receives volume only through migration."""
    gens = list(cfg.generations)
    if not gens:
        raise ValueError("migration config has no generations to plant")
    if num_pools < 2 or num_pools % 2:
        raise ValueError(
            "a turnover fleet is built from (old family, successor) pool "
            f"pairs; num_pools must be even and >= 2, got {num_pools}"
        )
    out: dict[tuple[str, str, str], dm.DemandConfig] = {}
    for i in range(num_pools // 2):
        g = gens[i % len(gens)]
        region = f"region_{i // len(gens)}"
        out[(g.cloud, region, g.old_family)] = dm.DemandConfig(
            base_level=60.0 * (1.5 ** (i % 3)),
            annual_growth=0.35 + 0.1 * (i % 4),
            diurnal_amplitude=0.10 + 0.02 * (i % 3),
            weekly_amplitude=0.12 + 0.02 * (i % 4),
        )
        out[(g.cloud, region, g.new_family)] = dm.DemandConfig(
            base_level=0.0
        )
    return out


def synthetic_base_pool_set(
    num_pools: int = 12,
    num_hours: int = 24 * 365 * 3,
    seed: int = 0,
    migration=True,
) -> dm.PoolSet:
    """The *pre-turnover* fleet a migration scenario starts from (host
    numpy): demand on the old-family pools, successor pools present and
    exactly zero.  Pool ``i`` of the pair order draws its noise from a
    generator seeded with ``seed + i``."""
    cfg = gn.resolve_migration(migration)
    if cfg is None:
        raise ValueError(
            "synthetic_base_pool_set builds a turnover fleet; pass "
            "migration=True or a MigrationConfig (use synthetic_pool_set "
            "for the fleet without turnover)"
        )
    cfgs = _turnover_pool_configs(num_pools, cfg)
    pools = {
        key: dm.synth_demand(
            num_hours, c,
            generator=torch.Generator().manual_seed(seed + i),
        ).numpy() if c.base_level > 0 else np.zeros(num_hours, np.float32)
        for i, (key, c) in enumerate(cfgs.items())
    }
    return dm.PoolSet.from_dict(pools, configs=cfgs)


def synthetic_pool_set(
    num_pools: int = 12,
    num_hours: int = 24 * 365 * 3,
    seed: int = 0,
    migration=None,
    *,
    device: "torch.device | str | None" = None,
) -> dm.PoolSet:
    """The synthetic fleet as an aligned PoolSet (keys sorted), carrying
    each pool's generating ``DemandConfig``.

    ``migration`` (True or a ``generations.MigrationConfig``) switches to
    the turnover fleet: the base fleet of :func:`synthetic_base_pool_set`
    turned over by ``generations.migrate_pool_set`` on ``device``
    (``None`` = the card; ``device="cpu"`` runs the plain version).
    Without ``migration`` the fleet is built on the host and ``device`` is
    not used."""
    mig = gn.resolve_migration(migration)
    if mig is not None:
        base = synthetic_base_pool_set(num_pools, num_hours, seed, mig)
        return gn.migrate_pool_set(base, mig, device=device)
    return dm.PoolSet.from_dict(
        synthetic_pools(num_pools, num_hours, seed),
        configs=_pool_configs(num_pools),
    )


def load_pools(**synth_kw) -> dict[tuple[str, str, str], np.ndarray]:
    """The artifact if ``SHAVEDICE_DATASET`` names a CSV on disk, else the
    calibrated synthetic pools."""
    path = os.environ.get(DATASET_ENV, "")
    if path and os.path.exists(path):
        return load_dataset_csv(path)
    return synthetic_pools(**synth_kw)


def load_pool_set(**synth_kw) -> dm.PoolSet:
    """PoolSet from the artifact when present (aligned by
    :func:`load_dataset_csv`, so stacking never fails on ragged pools),
    else the synthetic fleet."""
    path = os.environ.get(DATASET_ENV, "")
    if path and os.path.exists(path):
        return dm.PoolSet.from_dict(load_dataset_csv(path))
    return synthetic_pool_set(**synth_kw)
