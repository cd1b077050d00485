"""Carry a fleet, its purchase options, its spot lines, its successor
table, a model's parameters, gradients and AdamW state across from the JAX
package.

The functions are duck-typed: they read plain fields (``keys``,
``demand``, ``configs`` of a pool set; ``name``, ``cloud``, ``rate``,
``term_weeks``, ``convertible`` of a purchase option; the arrays of spot
lines and revocation parameters; the rows of a migration config) as numpy
arrays and Python values, so
they need no import of the reference package.  The
parity tests use them so that both packages plan the very same fleet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.capacity import generations as gn
from repro_torch.capacity import preemption as pe
from repro_torch.capacity import pricing
from repro_torch.core import demand as dm
from repro_torch.core import portfolio as pf
from repro_torch.core import spot as sp


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


def migration_config_from_reference(ref) -> gn.MigrationConfig:
    """The port's MigrationConfig holding ``ref``'s successor rows,
    software-efficiency rate and share-prior weight, so both packages can
    plant the same table."""
    names = [f.name for f in dataclasses.fields(pricing.Generation)]
    return gn.MigrationConfig(
        generations=tuple(
            pricing.Generation(**{n: getattr(g, n) for n in names})
            for g in ref.generations),
        software_efficiency_per_year=float(ref.software_efficiency_per_year),
        share_prior_weight=float(ref.share_prior_weight),
    )


def _f32(x, device) -> torch.Tensor:
    return torch.tensor(np.asarray(x, np.float32), device=device)


def preemption_params_from_reference(ref, device=None) -> pe.PreemptionParams:
    """The port's PreemptionParams holding ``ref``'s (P,) arrays."""
    return pe.PreemptionParams(*(
        _f32(getattr(ref, f.name), device)
        for f in dataclasses.fields(pe.PreemptionParams)))


def spot_lines_from_reference(ref, device=None) -> sp.SpotLines:
    """The port's SpotLines holding ``ref``'s (P,) arrays and parameters,
    so both packages can plan on identical lines (simulated ones too)."""
    return sp.SpotLines(
        rate=_f32(ref.rate, device), cap=_f32(ref.cap, device),
        market_rate=_f32(ref.market_rate, device),
        availability=_f32(ref.availability, device),
        params=preemption_params_from_reference(ref.params, device),
    )


def _flatten(node, prefix=""):
    """(dotted name, leaf) pairs of a tree of dicts and lists."""
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _flatten(v, f"{prefix}{k}.")
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            yield from _flatten(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], node


def _tensor(x) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":  # numpy's bfloat16 extension type
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _unstack(out: dict, tree, prefix: str, count: int, start: int = 0,
             step: int = 1) -> None:
    """Split each leaf of the stacked subtree ``tree`` (leading axis of
    ``count``) into ``{prefix}{start + step * j}.<name>`` entries of
    ``out``."""
    for name, stacked in _flatten(tree):
        arr = np.asarray(stacked)
        if arr.shape[0] != count:
            raise ValueError(f"{prefix}{name} stacks {arr.shape[0]}, the "
                             f"config has {count}")
        for j in range(count):
            out[f"{prefix}{start + step * j}.{name}"] = arr[j]


def model_params_from_reference(cfg, tree) -> dict[str, torch.Tensor]:
    """The port model's ``state_dict`` holding the JAX model's parameters.

    ``tree`` is the reference's parameter pytree (nested dicts and lists of
    arrays, any array type numpy can read).  The port keeps every layer in
    one list, where the reference stacks layers on a leading axis and
    scans them:
    - the transformer families (dense, MoE, vlm): the
      ``first_dense_layers`` unstacked ``prefix`` layers become
      ``layers.<i>.<name>``, the leaves of the stacked ``layers`` subtree
      ``layers.<first_dense_layers + j>.<name>`` (RWKV's ``layers`` too);
    - whisper (audio): the stacked ``enc_layers`` and ``dec_layers``
      become ``enc_layers.<j>.<name>`` and ``dec_layers.<j>.<name>``;
    - jamba (hybrid): ``blocks.l<i>.<name>`` of block ``b`` becomes
      ``layers.<8 b + i>.<name>``.
    bfloat16 leaves pass through float32, which holds them exactly;
    ``load_state_dict`` casts each tensor to its parameter's dtype.  A
    gradient tree of the JAX model has the parameters' layout and carries
    across the same way."""
    stacked = {"audio": ("enc_layers", "dec_layers"),
               "hybrid": ("blocks",)}.get(cfg.family, ("layers", "prefix"))
    out = dict(_flatten({k: v for k, v in tree.items()
                         if k not in stacked}))
    if cfg.family == "audio":
        _unstack(out, tree["enc_layers"], "enc_layers.", cfg.encoder_layers)
        _unstack(out, tree["dec_layers"], "dec_layers.", cfg.num_layers)
    elif cfg.family == "hybrid":
        period = len(tree["blocks"])
        blocks = cfg.num_layers // period
        for slot in range(period):
            _unstack(out, tree["blocks"][f"l{slot}"], "layers.", blocks,
                     start=slot, step=period)
    else:
        first = cfg.first_dense_layers
        prefix = tree.get("prefix", [])
        if len(prefix) != first:
            raise ValueError(f"the tree has {len(prefix)} prefix layers, "
                             f"the config {first}")
        for i, layer in enumerate(prefix):
            for name, leaf in _flatten(layer):
                out[f"layers.{i}.{name}"] = leaf
        _unstack(out, tree["layers"], "layers.", cfg.num_layers - first,
                 start=first)
    return {k: _tensor(v) for k, v in out.items()}


def opt_state_from_reference(cfg, state) -> dict:
    """The port's AdamW state (``repro_torch.train.optimizer``) holding the
    JAX state's float32 ``master``, ``m`` and ``v`` (each in the layout of
    :func:`model_params_from_reference`) and its ``step``."""
    out = {key: {n: t.float() for n, t in
                 model_params_from_reference(cfg, state[key]).items()}
           for key in ("master", "m", "v")}
    out["step"] = torch.tensor(int(np.asarray(state["step"])),
                               dtype=torch.int32)
    return out
