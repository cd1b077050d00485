"""The calibrated synthetic fleet as a :class:`~repro_torch.core.demand.
PoolSet`: 12 machine-type keys per cycle across 3 clouds and 4 regions,
varying scale, growth and seasonality the way the paper's §2 per-pool
statistics do.  Pool ``i`` draws its noise from a CPU ``torch.Generator``
seeded with ``seed + i``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import demand as dm


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
