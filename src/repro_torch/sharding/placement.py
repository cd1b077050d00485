"""Tensors placed on a mesh of ranks by partition specs, the port of the
reference's ``NamedSharding`` placement (``jax.device_put`` of a host
array onto a mesh).

A partition spec (:mod:`repro_torch.sharding.rules`: one entry per
dimension, ``None``, a mesh-axis name or a tuple of names) becomes DTensor
placements on a ``DeviceMesh``, one per mesh dimension: ``Shard(d)`` where
the mesh axis splits tensor dimension ``d``, ``Replicate()`` where it
splits none (:func:`placements_for`).  A dimension split over several mesh
axes is split by them in the spec's order, the first the outermost, which
is the reference's layout; DTensor's ``Shard`` splits a dimension by its
mesh axes in the mesh's order, so a spec that names them in another order
cannot be expressed and raises (``sanitize_partition_spec``'s spill can
append an earlier mesh axis after a later one; no registry config under
the port's rulesets does on the meshes tested).

Placing communicates nothing: each rank keeps its own slice of the full
tensor it holds (:func:`distribute`), as the reference's placement of a
host array does.  A placed tensor's full value comes back on the host by a
gather over the gloo ``launch.mesh.host_group`` (:func:`gather_to_host`):
gloo gathers no CUDA tensors.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.launch.mesh import host_group


def _axes(part) -> tuple[str, ...]:
    if part is None:
        return ()
    return tuple(part) if isinstance(part, (tuple, list)) else (part,)


def placements_for(pspec: tuple, mesh, name: str = "tensor") -> tuple:
    """The DTensor placements of partition spec ``pspec`` on ``mesh`` (a
    ``DeviceMesh`` with named dimensions).  Raises ``ValueError`` for a
    spec naming an axis the mesh lacks, or splitting one dimension over
    mesh axes out of the mesh's order (not expressible by ``Shard``)."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names or ())
    out = [Replicate()] * len(names)
    for d, part in enumerate(pspec):
        order = []
        for ax in _axes(part):
            if ax not in names:
                raise ValueError(f"{name}: spec {pspec} names mesh axis "
                                 f"{ax!r}, the mesh has {names}")
            order.append(names.index(ax))
            out[names.index(ax)] = Shard(d)
        if order != sorted(order):
            raise ValueError(
                f"{name}: spec {pspec} splits dim {d} over {part}, out of "
                f"the mesh's order {names}: DTensor's Shard cannot express "
                "it")
    return tuple(out)


def _pieces(ndim: int, mesh, placements, coord) -> list[tuple[int, int]]:
    """(index, count) of the piece the mesh position ``coord`` holds along
    each of ``ndim`` tensor dims."""
    from torch.distributed.tensor import Shard

    out = [(0, 1)] * ndim
    for m, p in enumerate(placements):
        if isinstance(p, Shard):
            idx, cnt = out[p.dim]
            out[p.dim] = (idx * mesh.size(m) + int(coord[m]),
                          cnt * mesh.size(m))
    return out


def _cut(full: torch.Tensor, pieces) -> torch.Tensor:
    """The view of ``full`` that ``pieces`` (from :func:`_pieces`) name:
    each dimension cut into equal pieces."""
    out = full
    for d, (idx, cnt) in enumerate(pieces):
        if cnt > 1:
            if full.shape[d] % cnt:
                raise ValueError(f"dim {d} of {tuple(full.shape)} does not "
                                 f"split into {cnt} equal pieces")
            step = full.shape[d] // cnt
            out = out.narrow(d, idx * step, step)
    return out


def local_slice(full: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's slice of ``full`` under ``placements`` (a view), the
    mesh's outer axes outermost along a dimension split by several."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not in the mesh")
    return _cut(full, _pieces(full.dim(), mesh, placements, coord))


def _contiguous_stride(shape) -> tuple[int, ...]:
    return tuple(math.prod(shape[d + 1:]) for d in range(len(shape)))


def distribute(full: torch.Tensor, mesh, placements):
    """A DTensor holding this rank's slice of ``full`` (copied onto the
    mesh's device, contiguous), with ``full``'s global shape.  Nothing is
    communicated: every rank must hold the same ``full``."""
    from torch.distributed.tensor import DTensor

    local = local_slice(full, mesh, placements).to(
        mesh.device_type, copy=True).contiguous()
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=full.shape,
                              stride=_contiguous_stride(tuple(full.shape)))


def is_sharding(x) -> bool:
    """Whether ``x`` is one leaf's ``(mesh, placements)``."""
    from torch.distributed.device_mesh import DeviceMesh

    return (isinstance(x, tuple) and len(x) == 2
            and isinstance(x[0], DeviceMesh))


def is_placed(x) -> bool:
    """Whether ``x`` is a placed tensor (a DTensor)."""
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def place(tree, shardings):
    """``tree`` (nested dicts and lists of tensors) with every leaf whose
    sharding (a tree of the same structure, each leaf ``(mesh,
    placements)`` or ``None``) is given placed by :func:`distribute`; the
    others as they are."""
    if isinstance(tree, dict):
        return {k: place(v, None if shardings is None else shardings[k])
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [place(v, None if shardings is None else s)
                for v, s in zip(tree, shardings or [None] * len(tree))]
    return tree if shardings is None else distribute(tree, *shardings)


def gather_to_host(dt, *, dst: int = 0) -> torch.Tensor | None:
    """The full value of placed tensor ``dt`` on rank ``dst``'s host (None
    on the other ranks): every rank's local slice gathered over the gloo
    ``launch.mesh.host_group`` and copied into its place.  A collective:
    every rank calls it.  The mesh must hold the whole world."""
    mesh = dt.device_mesh
    world, rank = dist.get_world_size(), dist.get_rank()
    if sorted(mesh.mesh.reshape(-1).tolist()) != list(range(world)):
        raise ValueError(f"a mesh over ranks {mesh.mesh.tolist()} is not "
                         f"the world of {world}")
    local = dt.to_local().detach().to("cpu").contiguous()
    parts = ([torch.empty_like(local) for _ in range(world)]
             if rank == dst else None)
    dist.gather(local, parts, dst=dst, group=host_group())
    if rank != dst:
        return None
    full = torch.empty(tuple(dt.shape), dtype=local.dtype)
    for coord in np.ndindex(*mesh.mesh.shape):
        pieces = _pieces(full.dim(), mesh, dt.placements, coord)
        _cut(full, pieces).copy_(parts[int(mesh.mesh[coord])])
    return full
