"""Checkpoint manager: atomic, keep-k, asynchronous saves of tensor trees.

The port of ``repro.ckpt.manager``.  Layout (one directory per step)::

    <root>/step_00000100.tmp/...     (written first)
    <root>/step_00000100/            (atomic rename on completion)
        manifest.json                (step, leaf names, treedef, shapes,
                                      dtypes, metadata)
        arr_00000.npy ...            (one file per leaf)

A tree is nested dicts and lists whose leaves are tensors (or numpy
arrays); its leaves are taken in order (dicts in insertion order) and
named by their dotted paths, which the manifest keeps beside the
reference's fields.  numpy has no bfloat16, so a bfloat16 leaf is written
as its 16-bit view (int16) and the manifest's dtype, ``"bfloat16"``, turns
it back, bit for bit.

* ``save_async`` copies every leaf to host memory before it returns, so
  the next train step may change the tensors in place; the files are
  written by a background thread, and ``wait`` (or the next save) joins
  it and raises what it raised.
* Writes are atomic (tmp dir + rename), so a crash mid-save never corrupts
  the latest checkpoint; ``keep_last`` prunes old steps after a successful
  rename.
* ``restore(..., device=)``: the leaves go to ``device``, or, without
  it, each to its target leaf's device.
* Elastic re-mesh (the reference's ``restore(..., shardings=)``): a
  checkpoint holds every leaf whole, whatever mesh saved it, so it
  restores onto any mesh, or onto one device.  ``shardings=`` is a tree
  of the target's structure whose leaves are ``(mesh, placements)``
  (``models.model.Model.param_shardings``) or ``None``; each placed leaf
  is read through a memory map and only this rank's slice is copied onto
  the mesh's device, as a DTensor (:mod:`repro_torch.sharding.placement`);
  an unplaced leaf goes where ``device=`` says.
* Saving placed leaves (DTensors) is collective: every rank of the mesh's
  world calls ``save`` with the same tree, the leaves' local slices are
  gathered on rank 0's host over the gloo ``launch.mesh.host_group``, made
  once per process group (gloo gathers no CUDA tensors), rank 0 writes the full tensors once, and the other ranks
  wait for its rename (a barrier in ``save``, or in ``wait`` after
  ``save_async``).  The ranks share the checkpoint directory's file
  system.  The manifest is the same as a one-device save's.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.launch.mesh import host_group
from repro_torch.sharding import placement

_MANIFEST = "manifest.json"
#: the rank that writes a checkpoint of placed leaves
WRITER = 0


def _flatten(tree, prefix="", is_leaf=None):
    """(dotted name, leaf) pairs of nested dicts and lists, in order."""
    if is_leaf is not None and is_leaf(tree):
        yield prefix[:-1], tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}{k}.", is_leaf)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}{i}.", is_leaf)
    else:
        yield prefix[:-1], tree


def _treedef(tree) -> str:
    """The tree's structure with ``*`` for each leaf."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_treedef(v)}"
                               for k, v in tree.items()) + "}"
    if isinstance(tree, (list, tuple)):
        return "[" + ", ".join(_treedef(v) for v in tree) + "]"
    return "*"


def _unflatten(tree, leaves):
    """``tree``'s structure with its leaves replaced, in order."""
    if isinstance(tree, dict):
        return {k: _unflatten(v, leaves) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, leaves) for v in tree)
    return next(leaves)


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _host_copy(leaf) -> torch.Tensor:
    """A host copy of ``leaf`` that later in-place updates cannot reach."""
    if isinstance(leaf, np.ndarray):
        return torch.from_numpy(leaf.copy())
    return torch.as_tensor(leaf).detach().to("cpu", copy=True)


class CheckpointManager:
    def __init__(self, root: str, *, keep_last: int = 3):
        self.root = root
        self.keep_last = keep_last
        os.makedirs(root, exist_ok=True)
        self._pending = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Any, metadata: dict | None = None):
        self.wait()
        snapshot, sync = self._snapshot(tree)
        try:
            if snapshot is not None:
                self._save_sync(step, snapshot, metadata or {})
        finally:
            if sync is not None:
                sync()  # the other ranks wait for the writer's rename

    def save_async(self, step: int, tree: Any, metadata: dict | None = None):
        self.wait()
        # host copies (gathers of placed leaves) before training changes
        # the tensors
        snapshot, sync = self._snapshot(tree)
        errors: list = []
        thread = None
        if snapshot is not None:
            def work():
                try:
                    self._save_sync(step, snapshot, metadata or {})
                except Exception as exc:  # raised again by wait()
                    errors.append(exc)

            thread = threading.Thread(target=work, daemon=True)
            thread.start()
        self._pending = (thread, errors, sync)

    def wait(self):
        """Join the pending asynchronous save (on every rank of a save of
        placed leaves, until the writer's rename); raise what it
        raised."""
        if self._pending is not None:
            thread, errors, sync = self._pending
            self._pending = None
            if thread is not None:
                thread.join()
            if sync is not None:
                sync()
            if errors:
                raise errors[0]

    @staticmethod
    def _snapshot(tree):
        """(((name, host tensor) per leaf, the tree's structure) or None on
        a rank that does not write, and the barrier the ranks pass once the
        writer has renamed, or None for a save without placed leaves)."""
        leaves = list(_flatten(tree))
        if not any(placement.is_placed(leaf) for _, leaf in leaves):
            return ([(name, _host_copy(leaf)) for name, leaf in leaves],
                    _treedef(tree)), None
        group = host_group()
        writes = dist.get_rank() == WRITER
        host = []
        for name, leaf in leaves:
            if placement.is_placed(leaf):
                host.append((name, placement.gather_to_host(leaf,
                                                            dst=WRITER)))
            elif writes:
                host.append((name, _host_copy(leaf)))
        return ((host, _treedef(tree)) if writes else None,
                lambda: dist.barrier(group=group))

    def _save_sync(self, step: int, snapshot, metadata: dict):
        leaves, treedef = snapshot
        name = f"step_{step:08d}"
        tmp = os.path.join(self.root, name + ".tmp")
        final = os.path.join(self.root, name)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        for i, (_, t) in enumerate(leaves):
            arr = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t)
            np.save(os.path.join(tmp, f"arr_{i:05d}.npy"), arr.numpy())
        manifest = {
            "step": step,
            "num_leaves": len(leaves),
            "treedef": treedef,
            "shapes": [list(t.shape) for _, t in leaves],
            "dtypes": [_dtype_name(t) for _, t in leaves],
            "names": [n for n, _ in leaves],
            "metadata": metadata,
        }
        with open(os.path.join(tmp, _MANIFEST), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        self._prune()

    def _prune(self):
        steps = self.all_steps()
        for s in steps[: -self.keep_last] if self.keep_last else []:
            shutil.rmtree(os.path.join(self.root, f"step_{s:08d}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        out = []
        for d in os.listdir(self.root):
            if d.startswith("step_") and not d.endswith(".tmp"):
                try:
                    out.append(int(d.split("_")[1]))
                except ValueError:
                    continue
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(
        self,
        step: int,
        target_tree: Any,
        *,
        device: "torch.device | str | None" = None,
        shardings: Any | None = None,
    ) -> tuple[Any, dict]:
        """Restore into the structure of ``target_tree``: new tensors of
        the target leaves' dtypes, on ``device`` or each on its target
        leaf's device; a leaf whose sharding in ``shardings`` (a tree of
        the target's structure, leaves ``(mesh, placements)`` or ``None``)
        is given becomes a DTensor holding this rank's slice on the
        mesh's device.  The mesh need not be the one that saved.  Raises
        ``ValueError`` when the checkpoint's leaves (count, names, shapes)
        do not match the target's."""
        path = os.path.join(self.root, f"step_{step:08d}")
        with open(os.path.join(path, _MANIFEST)) as f:
            manifest = json.load(f)
        targets = list(_flatten(target_tree))
        if manifest["num_leaves"] != len(targets):
            raise ValueError(
                f"checkpoint has {manifest['num_leaves']} leaves, target "
                f"{len(targets)}: incompatible trees")
        names = [n for n, _ in targets]
        if manifest["names"] != names:
            raise ValueError("checkpoint leaf names differ from the "
                             "target's: incompatible trees")
        places = ([None] * len(targets) if shardings is None else
                  [sh for _, sh in _flatten(
                      shardings, is_leaf=placement.is_sharding)])
        if len(places) != len(targets):
            raise ValueError(f"shardings has {len(places)} leaves, target "
                             f"{len(targets)}")

        def load(i, ref, shape, dtype, sharding):
            # a placed leaf reads only its slice's pages
            a = np.load(os.path.join(path, f"arr_{i:05d}.npy"),
                        mmap_mode=None if sharding is None else "c")
            t = torch.from_numpy(a)
            if dtype == "bfloat16":
                t = t.view(torch.bfloat16)
            ref = torch.as_tensor(ref)
            if list(t.shape) != shape or t.shape != ref.shape:
                raise ValueError(
                    f"shape mismatch at {names[i]}: checkpoint "
                    f"{tuple(t.shape)} vs target {tuple(ref.shape)}")
            if sharding is not None:
                return placement.distribute(t, *sharding).to(ref.dtype)
            return t.to(device=ref.device if device is None else device,
                        dtype=ref.dtype)

        leaves = [load(i, ref, shape, dtype, sh)
                  for i, ((_, ref), shape, dtype, sh) in enumerate(zip(
                      targets, manifest["shapes"], manifest["dtypes"],
                      places))]
        return _unflatten(target_tree, iter(leaves)), manifest["metadata"]

    def restore_latest(self, target_tree: Any, **kw):
        step = self.latest_step()
        if step is None:
            return None
        tree, meta = self.restore(step, target_tree, **kw)
        return step, tree, meta
