"""Meshes: the production mesh shapes, process-group meshes and the rows
of a batch sharded over ranks, the port of ``repro.launch.mesh``.

FUNCTIONS, not module-level constants: importing this module builds no
mesh and starts no process group.  The production meshes (256 and 512
TPU chips) exist here as shapes only, ``{axis: size}``, which is what the
dry run and the sharding rules read; a mesh of ranks is built over a
process group the caller has initialized (``torch.distributed
.init_process_group`` with its own address, world size and rank): NCCL on
the card, gloo for ``device="cpu"``.  :func:`make_mesh` builds every
mesh; one for placing tensors (:mod:`repro_torch.sharding.placement`)
moves nothing on the card, so any backend serves it.  Host bytes (the
row exchange, checkpoint gathers) move over one gloo group,
:func:`host_group`, whatever the default backend.

:func:`shard_rows` is the reference's ``shard_rows``: the scenario replay
(``core.replan``) and the tournament (``core.tournament``) split their
rows over the ranks of the default process group.  The reference places
the flattened row axis on a 1-D ``"data"`` mesh and lets XLA shard the
program; the port splits by whole rows (scenarios, or paths), each rank
replaying one contiguous block, and :func:`gather_rows` exchanges the
blocks' host results over :func:`host_group`.  Without a process group,
or at world 1, the block is every row: the identity, as the reference's
is on one device.  The blocks' sizes differ by at most one: of ``n`` rows over ``W`` ranks, the
first ``n mod W`` ranks take ``ceil(n / W)`` and the rest ``floor(n /
W)`` (the reference leaves rows whole when ``W`` does not divide them).
A world larger than ``n`` raises ``ValueError``: a rank would replay
nothing.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import resolve_device


def production_mesh_shape(*, multi_pod: bool = False) -> dict[str, int]:
    """Single-pod: 256 chips as ("data", "model") = (16, 16).
    Multi-pod: 2 pods x 256 chips as ("pod", "data", "model") =
    (2, 16, 16).  Axis order is the dict's order."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def make_mesh(shape: dict[str, int], device=None, *,
              collective: bool = False):
    """Every rank of the initialized process group as a mesh of
    ``shape`` (``{axis: size}``, axis order the dict's, ranks in row-major
    order: rank ``i * shape[1] + j`` sits at ``(i, j)``) on ``device``
    (``None``: the card).  The world must hold ``prod(shape)`` ranks.
    Placing tensors on it communicates nothing, so any backend serves;
    a ``collective`` mesh, whose tensors are reduced over its group, needs
    NCCL on the card and gloo on the CPU."""
    from torch.distributed.device_mesh import DeviceMesh

    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError(
            f"a mesh of {shape} needs an initialized process group: call "
            "torch.distributed.init_process_group (nccl on the card, gloo "
            "on the CPU) first")
    want = "nccl" if dev.type == "cuda" else "gloo"
    if collective and dist.get_backend() != want:
        raise RuntimeError(f"a {dev.type} mesh needs the {want} backend, "
                           f"not {dist.get_backend()}")
    size = int(np.prod(list(shape.values())))
    if dist.get_world_size() != size:
        raise ValueError(f"a mesh of {shape} needs a world of {size}, not "
                         f"{dist.get_world_size()}")
    return DeviceMesh(dev.type, torch.arange(size).reshape(
        tuple(shape.values())), mesh_dim_names=tuple(shape))


def make_host_mesh(device=None):
    """Every rank of the initialized process group as a 1-D ``"data"``
    mesh (``device=None``: the card)."""
    return make_mesh({"data": dist.get_world_size()
                      if dist.is_initialized() else 0}, device,
                     collective=True)


def make_pod_mesh(n_pod: int, device=None):
    """The ``("pod",)`` mesh of ``n_pod`` ranks that the compressed train
    step syncs its gradients over (``device=None``: the card)."""
    return make_mesh({"pod": n_pod}, device, collective=True)


def mesh_axes(mesh) -> tuple[str, ...]:
    """The axis names of a ``DeviceMesh`` or of a ``{axis: size}`` mesh
    shape."""
    if isinstance(mesh, dict):
        return tuple(mesh)
    return tuple(mesh.mesh_dim_names or ())


def _world() -> tuple[int, int]:
    """(world size, rank) of the default process group; (1, 0) without
    one."""
    if not dist.is_initialized():
        return 1, 0
    return dist.get_world_size(), dist.get_rank()


def row_blocks(n: int, world: int) -> list[tuple[int, int]]:
    """Each rank's block ``[lo, hi)`` of ``n`` rows over ``world`` ranks,
    in rank order: contiguous, sizes differing by at most one, the larger
    blocks first."""
    if world > n:
        raise ValueError(
            f"{n} rows cannot be sharded over a world of {world}: every "
            "rank must take at least one whole row")
    base, extra = divmod(n, world)
    starts = [r * base + min(r, extra) for r in range(world + 1)]
    return list(zip(starts[:-1], starts[1:]))


def shard_rows(n: int) -> tuple[int, int]:
    """This rank's block ``[lo, hi)`` of ``n`` whole rows under the default
    process group (:func:`row_blocks`); ``(0, n)`` without a group or at
    world 1."""
    world, rank = _world()
    if world == 1:
        return 0, n
    return row_blocks(n, world)[rank]


#: (the default process group, its gloo host group) once one is made
_HOST_GROUP: list = []


def host_group():
    """The gloo group over the whole world that moves host bytes (row
    exchanges, checkpoint gathers) on every backend: the default group
    (``None``) under gloo, else one gloo group made on the first call
    under each default group and kept (a collective call the first time:
    every rank makes it)."""
    if dist.get_backend() == "gloo":
        return None
    if not (_HOST_GROUP and _HOST_GROUP[0][0] is dist.group.WORLD):
        _HOST_GROUP[:] = [(dist.group.WORLD,
                           dist.new_group(backend="gloo"))]
    return _HOST_GROUP[0][1]


def gather_rows(local: np.ndarray, n: int, *, axis: int = 0) -> np.ndarray:
    """Every rank's block of an ``n``-row host array, gathered along
    ``axis`` in rank order on every rank: ``local`` holds this rank's
    block (:func:`shard_rows`) along ``axis``.  One ``all_gather`` of the
    blocks' bytes, each padded to the largest block, over the gloo
    :func:`host_group`; the values keep their bits, any dtype.  Without a
    group or at world 1 the block is the whole array, returned as it
    is."""
    world, rank = _world()
    if world == 1:
        return local
    blocks = row_blocks(n, world)
    counts = [hi - lo for lo, hi in blocks]
    rows = np.ascontiguousarray(np.moveaxis(np.asarray(local), axis, 0))
    if rows.shape[0] != counts[rank]:
        raise ValueError(f"rank {rank} holds {rows.shape[0]} rows along "
                         f"axis {axis}, its block of {n} is {counts[rank]}")
    raw = torch.from_numpy(rows.reshape(counts[rank], -1).view(np.uint8))
    buf = torch.zeros((max(counts), raw.shape[1]), dtype=torch.uint8)
    buf[:counts[rank]] = raw
    parts = [torch.empty_like(buf) for _ in range(world)]
    dist.all_gather(parts, buf, group=host_group())
    full = np.concatenate([p[:c].numpy() for p, c in zip(parts, counts)])
    full = full.view(rows.dtype).reshape(n, *rows.shape[1:])
    return np.ascontiguousarray(np.moveaxis(full, 0, axis))
