"""Parameter specs: one declaration drives a parameter's shape, dtype and
initialization, as in the JAX package's ``params``.

The init rule is the reference's: zeros, ones, or a normal draw times
``1 / sqrt(fan_in)`` (``fan_in`` defaults to the second-to-last dim, or the
last of a vector), drawn in float32 and cast to the parameter's dtype; a
Spec's ``dtype`` overrides the model's (float32 norms, ``w0``, ``u``,
``ln_x``).  The draws come from a ``torch.Generator`` the caller seeds, so
they are not the reference's ``jax.random`` numbers: parity tests carry the
reference's parameters across instead (``repro_torch.convert``).  The
logical axes map to mesh axes through a ruleset
(:mod:`repro_torch.sharding.rules`): :func:`partition_spec` and
:func:`sanitize_partition_spec` give a tensor's spec on a mesh shape
(``{axis: size}``, no device needed), which sizes its per-device bytes;
placing tensors on several cards is not ported.

A family's whole parameter table is a tree of Specs (nested dicts and
lists, layers stacked on a leading ``"layers"`` dim as in the reference),
so :func:`count_params` sizes a full published model without allocating
anything.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class Spec:
    """Declaration of one parameter (or cache) tensor."""

    shape: tuple[int, ...]
    axes: tuple[str | None, ...]       # logical axis name per dim
    init: str = "normal"               # normal | zeros | ones
    fan_in: int | None = None          # normal: std = 1/sqrt(fan_in)
    dtype: torch.dtype | None = None   # override (e.g. float32 for norms)

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def add_parameters(module: nn.Module, specs: dict[str, Spec], dtype,
                   device) -> None:
    """Register one uninitialized ``nn.Parameter`` per spec on ``module``
    (in the specs' order) and remember the specs for :func:`init_module`."""
    module._param_specs = {**getattr(module, "_param_specs", {}), **specs}
    for name, spec in specs.items():
        module.register_parameter(name, nn.Parameter(torch.empty(
            spec.shape, dtype=spec.dtype or dtype, device=device)))


@torch.no_grad()
def fill(t: torch.Tensor, spec: Spec, generator: torch.Generator) -> None:
    """Initialize ``t`` in place by ``spec``'s rule."""
    if spec.init == "zeros":
        t.zero_()
    elif spec.init == "ones":
        t.fill_(1.0)
    else:
        shape = spec.shape
        fan = spec.fan_in or (shape[-2] if len(shape) >= 2 else shape[-1])
        std = 1.0 / math.sqrt(max(fan, 1))
        draw = torch.randn(shape, generator=generator, dtype=torch.float32,
                           device=generator.device)
        t.copy_(draw.mul_(std))


def init_module(module: nn.Module, generator: torch.Generator) -> None:
    """Initialize every spec'd parameter of ``module`` and its submodules,
    in registration order, from ``generator`` (on the parameters'
    device)."""
    for sub in module.modules():
        for name, spec in getattr(sub, "_param_specs", {}).items():
            fill(getattr(sub, name), spec, generator)



def _spec_leaves(specs) -> list[Spec]:
    """The Specs of a tree of nested dicts and lists, in order."""
    if isinstance(specs, Spec):
        return [specs]
    if isinstance(specs, dict):
        specs = specs.values()
    return [leaf for sub in specs for leaf in _spec_leaves(sub)]


def count_params(specs) -> int:
    """Parameters declared by a tree of Specs."""
    return sum(math.prod(s.shape) for s in _spec_leaves(specs))


def stack_spec_tree(specs, num_layers: int):
    """The tree with a leading stacked-layers dim on every Spec (the
    reference's scanned-layer layout)."""
    if isinstance(specs, Spec):
        return dataclasses.replace(specs, shape=(num_layers, *specs.shape),
                                   axes=("layers", *specs.axes))
    if isinstance(specs, dict):
        return {k: stack_spec_tree(v, num_layers) for k, v in specs.items()}
    return [stack_spec_tree(v, num_layers) for v in specs]


def partition_spec(spec: Spec, rules: dict) -> tuple:
    """The spec's partition spec under ``rules``: per dim, the mesh axis
    (or tuple of axes, or ``None``) its logical axis maps to."""
    return tuple(rules.get(a) if a else None for a in spec.axes)


def _axis_size(mesh_shape: dict, part) -> int:
    if part is None:
        return 1
    if isinstance(part, (tuple, list)):
        return math.prod(mesh_shape[p] for p in part)
    return mesh_shape[part]


def sanitize_partition_spec(spec: Spec, rules: dict,
                            mesh_shape: dict) -> tuple:
    """Partition spec with divisibility repair ("axis spill"), the
    reference's rule on a ``{axis: size}`` mesh shape.

    GQA head counts (4..48), some vocab sizes, and whisper's 1500-frame
    cross cache don't divide a 16-way mesh axis.  A mesh axis whose target
    dim is indivisible moves to the first other dim of the same tensor
    that divides it and is not yet sharded on that axis; if none exists
    the axis is dropped (replicated).  A mesh axis appears at most once
    per spec."""
    parts = list(partition_spec(spec, rules))

    def mesh_axes_of(part):
        if part is None:
            return []
        return list(part) if isinstance(part, (tuple, list)) else [part]

    # Pass 1: strip mesh axes that don't divide their dim, or that an
    # earlier dim of this tensor already uses.
    homeless: list[str] = []
    used: set[str] = set()
    for i, part in enumerate(parts):
        kept = []
        for ax in mesh_axes_of(part):
            if ax in used:
                continue  # duplicate across dims: drop silently
            combined = mesh_shape[ax] * math.prod(mesh_shape[k]
                                                  for k in kept)
            if spec.shape[i] % combined == 0:
                kept.append(ax)
                used.add(ax)
            else:
                homeless.append(ax)
        parts[i] = (tuple(kept) if len(kept) > 1
                    else (kept[0] if kept else None))

    # Pass 2: re-home stripped axes on other dims (never duplicating a mesh
    # axis already used by this tensor).
    for ax in homeless:
        if ax in used:
            continue
        for i, part in enumerate(parts):
            current = _axis_size(mesh_shape, part)
            if spec.shape[i] % (current * mesh_shape[ax]) == 0:
                axes = mesh_axes_of(part) + [ax]
                parts[i] = tuple(axes) if len(axes) > 1 else axes[0]
                used.add(ax)
                break
        # not placeable -> replicated on that axis (dropped)
    return tuple(parts)


def shards(pspec: tuple, mesh_shape: dict) -> int:
    """How many ways a partition spec splits its tensor on the mesh."""
    return math.prod(_axis_size(mesh_shape, part) for part in pspec)


def named_specs(module: nn.Module) -> dict[str, Spec]:
    """The Spec of every spec'd parameter of ``module`` and its submodules,
    by the parameter's dotted name (as ``named_parameters`` gives it)."""
    return {(f"{prefix}.{name}" if prefix else name): spec
            for prefix, sub in module.named_modules()
            for name, spec in getattr(sub, "_param_specs", {}).items()}
