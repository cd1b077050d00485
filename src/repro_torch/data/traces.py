"""Loader for the released Shaved Ice dataset schema (paper §6) and the
calibrated synthetic fleet.

The artifact publishes normalized hourly VM demand as CSV with columns
``timestamp, cloud, region, machine_type, normalized_count``;
:func:`load_dataset_csv` reads it onto one aligned hourly grid.  Without
it, the synthetic fleet stands in: 12 machine-type keys per cycle across 3
clouds and 4 regions, varying scale, growth and seasonality the way the
paper's §2 per-pool statistics do.  Pool ``i`` draws its noise from a CPU
``torch.Generator`` seeded with ``seed + i``.

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


def synthetic_pool_set(
    num_pools: int = 12,
    num_hours: int = 24 * 365 * 3,
    seed: int = 0,
    migration=None,
) -> dm.PoolSet:
    """The synthetic fleet as an aligned PoolSet (keys sorted), carrying
    each pool's generating ``DemandConfig``.  The hardware-turnover fleet
    (``migration=``) belongs to the migration slice (ROADMAP Queue 1,
    item 11) and raises ``NotImplementedError`` here."""
    if migration is not None and migration is not False:
        raise NotImplementedError(
            "synthetic_pool_set(migration=...) is not ported yet "
            "(ROADMAP Queue 1, item 11: generation turnover)"
        )
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
