"""Carry a fleet and its purchase options across from the JAX package.

Both functions are duck-typed: they read plain fields (``keys``,
``demand``, ``configs`` of a pool set; ``name``, ``cloud``, ``rate``,
``term_weeks``, ``convertible`` of a purchase option) as numpy arrays and
Python values, so they need no import of the reference package.  The
parity tests use them so that both packages plan the very same fleet.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import demand as dm
from repro_torch.core import portfolio as pf


def pool_set_from_reference(ref) -> dm.PoolSet:
    """The port's PoolSet holding ``ref``'s keys, demand and configs."""
    configs = None
    if getattr(ref, "configs", None) is not None:
        names = [f.name for f in dataclasses.fields(dm.DemandConfig)]
        configs = tuple(
            dm.DemandConfig(**{n: getattr(c, n) for n in names})
            for c in ref.configs
        )
    return dm.PoolSet(
        keys=tuple(tuple(k) for k in ref.keys),
        demand=np.array(ref.demand, dtype=np.float32),
        configs=configs,
    )


def options_from_reference(ref_opts) -> list[pf.PurchaseOption]:
    """The port's PurchaseOptions with ``ref_opts``' fields."""
    return [
        pf.PurchaseOption(
            name=str(o.name), cloud=str(o.cloud), rate=float(o.rate),
            term_weeks=int(o.term_weeks),
            convertible=bool(getattr(o, "convertible", False)),
        )
        for o in ref_opts
    ]
