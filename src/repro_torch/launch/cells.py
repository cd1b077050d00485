"""The shape cells: every (architecture x input shape) of the assignment
matrix as a full-size model on the meta device, the port of the intent of
``repro.launch.cells``.

The reference builds each cell's step function, abstract inputs and
shardings for XLA to compile.  The port compiles nothing: a
:class:`Cell` holds the config, the :class:`ShapeCell` and a
``Model(cfg, device="meta")`` (shapes, no storage), whose parameter and
cache Specs size what one device holds under a ruleset and a
``{axis: size}`` mesh shape (:meth:`Cell.device_bytes`).  The optimizer
state is the port's AdamW's: float32 master, m and v, 12 bytes a
parameter sharded as the parameter (the reference's master + m + v f32
too), its step counter a host scalar.  The reference's
``delta_configs`` (the L1/L2 extrapolation around XLA's cost analysis,
which counts a ``while`` body once) has no counterpart: nothing here is
compiled.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import configs
from repro_torch.launch.roofline import _local_bytes
from repro_torch.models.config import SHAPES, ModelConfig, ShapeCell, cells_for
from repro_torch.models.model import Model, build
from repro_torch.models.params import Spec, named_specs
from repro_torch.sharding.rules import RULESETS, Rules

#: the port's AdamW state per parameter: float32 master, m and v
OPT_STATE_COPIES = 3


def default_microbatches(cfg: ModelConfig, cell: ShapeCell,
                         mesh_shape: dict) -> int:
    """Gradient-accumulation factor for train cells, sized so the per-layer
    remat-residual stack (L x B_loc x S x d bf16) stays under 8 GiB a
    device beside params and optimizer state (the reference's rule)."""
    if cell.kind != "train":
        return 1
    n_batch = mesh_shape.get("data", 1) * mesh_shape.get("pod", 1)
    b_loc = max(cell.global_batch // n_batch, 1)
    resid = cfg.num_layers * b_loc * cell.seq_len * cfg.d_model * 2
    budget = 8 * 1024**3  # headroom for params/opt/transients
    micro = 1
    while resid / micro > budget and micro < b_loc:
        micro *= 2
    return micro


def resolve_rules(rules: Rules, mesh_shape: dict, global_batch: int) -> Rules:
    """Adapt a ruleset to a mesh shape: drop mesh axes that don't exist
    (single-pod has no "pod"), and shrink the batch axes to a prefix whose
    product divides the global batch (long_500k has batch 1)."""
    out = dict(rules)

    def filter_part(part):
        if part is None:
            return None
        parts = part if isinstance(part, (tuple, list)) else (part,)
        kept = tuple(p for p in parts if p in mesh_shape)
        return kept if kept else None

    for k, v in out.items():
        out[k] = filter_part(v)

    batch_axes = out.get("batch") or ()
    if not isinstance(batch_axes, tuple):
        batch_axes = (batch_axes,)
    kept: list[str] = []
    prod = 1
    for ax in batch_axes:
        if global_batch % (prod * mesh_shape[ax]) == 0:
            kept.append(ax)
            prod *= mesh_shape[ax]
    out["batch"] = tuple(kept) if kept else None
    return out


def stacked_cache_specs(model: Model, batch: int, seq: int) -> list[Spec]:
    """The cache's Specs as the port allocates them: each kind stacked over
    its layers (:meth:`Model.cache_groups`)."""
    return [dataclasses.replace(s, shape=(layers, *s.shape),
                                axes=("layers", *s.axes))
            for layers, specs in model.cache_groups(batch, seq)
            for s in specs.values()]


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    cfg: ModelConfig
    cell: ShapeCell
    model: Model                      # on the meta device

    @property
    def param_specs(self) -> dict[str, Spec]:
        """name -> Spec of every parameter, one per layer."""
        return named_specs(self.model)

    @property
    def cache_specs(self) -> list[Spec]:
        """The cache of a prefill or decode cell (global batch x sequence);
        empty for a train cell."""
        if self.cell.kind == "train":
            return []
        return stacked_cache_specs(self.model, self.cell.global_batch,
                                   self.cell.seq_len)

    def device_bytes(self, mesh_shape: dict, rules: Rules) -> dict:
        """Per-device resident bytes under ``rules`` (resolved for the
        mesh shape) on ``mesh_shape``: parameters, optimizer state (train
        cells) and cache (prefill and decode cells), each sharded by its
        sanitized partition spec."""
        specs = list(self.param_specs.values())
        opt = 0.0
        if self.cell.kind == "train":
            f32 = [dataclasses.replace(s, dtype=torch.float32) for s in specs]
            opt = OPT_STATE_COPIES * _local_bytes(f32, mesh_shape, rules)
        return {"params": _local_bytes(specs, mesh_shape, rules),
                "opt_state": opt,
                "cache": _local_bytes(self.cache_specs, mesh_shape, rules)}


def make_cell(arch: str, shape: str) -> Cell:
    """The cell of ``arch`` at ``shape``, its model on the meta device."""
    cfg = configs.get(arch)
    return Cell(arch=arch, shape=shape, cfg=cfg, cell=SHAPES[shape],
                model=build(cfg, device="meta"))


def cell_rules(cell: Cell, mesh_shape: dict) -> Rules:
    """The cell's ruleset (by its kind) resolved for ``mesh_shape``."""
    return resolve_rules(dict(RULESETS[cell.cell.kind]), mesh_shape,
                         cell.cell.global_batch)


def all_cells() -> list[tuple[str, str]]:
    """Every (arch, shape) cell: 10 architectures x 3 shapes, plus
    long_500k for the two sub-quadratic ones."""
    out = []
    for arch in sorted(configs.ARCHS):
        for shape in cells_for(configs.get(arch)):
            out.append((arch, shape))
    return out
