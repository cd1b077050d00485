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
* ``restore(..., device=)`` takes the place of the reference's
  ``shardings=``: the leaves go to ``device``, or, without it, each to its
  target leaf's device.  The elastic re-mesh restore needs several cards
  and is not ported (ROADMAP item 12).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch

_MANIFEST = "manifest.json"


def _flatten(tree, prefix=""):
    """(dotted name, leaf) pairs of nested dicts and lists, in order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}{i}.")
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
        self._pending: tuple[threading.Thread, list] | None = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Any, metadata: dict | None = None):
        self.wait()
        self._save_sync(step, self._snapshot(tree), metadata or {})

    def save_async(self, step: int, tree: Any, metadata: dict | None = None):
        self.wait()
        host = self._snapshot(tree)  # before training changes the tensors
        errors: list = []

        def work():
            try:
                self._save_sync(step, host, metadata or {})
            except Exception as exc:  # raised again by wait()
                errors.append(exc)

        thread = threading.Thread(target=work, daemon=True)
        self._pending = (thread, errors)
        thread.start()

    def wait(self):
        """Join the pending asynchronous save; raise what it raised."""
        if self._pending is not None:
            thread, errors = self._pending
            thread.join()
            self._pending = None
            if errors:
                raise errors[0]

    @staticmethod
    def _snapshot(tree):
        """((name, host tensor) per leaf, the tree's structure)."""
        return ([(name, _host_copy(leaf)) for name, leaf in _flatten(tree)],
                _treedef(tree))

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
    ) -> tuple[Any, dict]:
        """Restore into the structure of ``target_tree``: new tensors of
        the target leaves' dtypes, on ``device`` or each on its target
        leaf's device.  Raises ``ValueError`` when the checkpoint's leaves
        (count, names, shapes) do not match the target's."""
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

        def load(i, ref, shape, dtype):
            t = torch.from_numpy(np.load(os.path.join(path,
                                                      f"arr_{i:05d}.npy")))
            if dtype == "bfloat16":
                t = t.view(torch.bfloat16)
            ref = torch.as_tensor(ref)
            if list(t.shape) != shape or t.shape != ref.shape:
                raise ValueError(
                    f"shape mismatch at {names[i]}: checkpoint "
                    f"{tuple(t.shape)} vs target {tuple(ref.shape)}")
            return t.to(device=ref.device if device is None else device,
                        dtype=ref.dtype)

        leaves = [load(i, ref, shape, dtype) for i, ((_, ref), shape, dtype)
                  in enumerate(zip(targets, manifest["shapes"],
                                   manifest["dtypes"]))]
        return _unflatten(target_tree, iter(leaves)), manifest["metadata"]

    def restore_latest(self, target_tree: Any, **kw):
        step = self.latest_step()
        if step is None:
            return None
        tree, meta = self.restore(step, target_tree, **kw)
        return step, tree, meta
