"""Meshes: the production mesh shapes and process-group meshes, the port of
``repro.launch.mesh``.

FUNCTIONS, not module-level constants: importing this module builds no
mesh and starts no process group.  The production meshes (256 and 512
TPU chips) exist here as shapes only, ``{axis: size}``, which is what the
dry run and the sharding rules read; a mesh of ranks is built over a
process group the caller has initialized (``torch.distributed
.init_process_group`` with its own address, world size and rank): NCCL on
the card, gloo for ``device="cpu"``.

``shard_rows`` is not ported: on one device it is the identity, and
sharding the replay's rows over several ranks needs sharded tensors.
"""

from __future__ import annotations

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


def _world_mesh(name: str, size: int, device):
    """A 1-D mesh named ``name`` over ranks 0..size-1 of the initialized
    process group, whose world must be ``size`` ranks."""
    from torch.distributed.device_mesh import DeviceMesh

    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError(
            f"a {name!r} mesh needs an initialized process group: call "
            "torch.distributed.init_process_group (nccl on the card, gloo "
            "on the CPU) first")
    want = "nccl" if dev.type == "cuda" else "gloo"
    if dist.get_backend() != want:
        raise RuntimeError(f"a {dev.type} mesh needs the {want} backend, "
                           f"not {dist.get_backend()}")
    if dist.get_world_size() != size:
        raise ValueError(f"a {name!r} mesh of {size} ranks needs a world of "
                         f"{size}, not {dist.get_world_size()}")
    return DeviceMesh(dev.type, torch.arange(size), mesh_dim_names=(name,))


def make_host_mesh(device=None):
    """Every rank of the initialized process group as a 1-D ``"data"``
    mesh (``device=None``: the card)."""
    return _world_mesh("data", dist.get_world_size()
                       if dist.is_initialized() else 0, device)


def make_pod_mesh(n_pod: int, device=None):
    """The ``("pod",)`` mesh of ``n_pod`` ranks that the compressed train
    step syncs its gradients over (``device=None``: the card)."""
    return _world_mesh("pod", n_pod, device)


def mesh_axes(mesh) -> tuple[str, ...]:
    """The axis names of a ``DeviceMesh`` or of a ``{axis: size}`` mesh
    shape."""
    if isinstance(mesh, dict):
        return tuple(mesh)
    return tuple(mesh.mesh_dim_names or ())
