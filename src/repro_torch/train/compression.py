"""Gradient compression for cross-pod sync: int8 error-feedback all-reduce,
the port of ``repro.train.compression``.

At multi-pod scale the "pod" axis rides the slowest links, so the pure-DP
gradient all-reduce over "pod" is the collective to compress.  Classic
EF-SGD: quantize (g + e) to int8 with a per-tensor scale shared across the
group, sum the quantized payload across pods, dequantize, and carry the
quantization residual e into the next step — unbiased in the long run,
bounded staleness.

The arithmetic is the reference's as its compiled program (XLA on the
CPU) evaluates it, so both packages give the same bits: the division of
the max by 127 is a multiplication by float32(1/127) (XLA's simplifier
rewrites division by a constant so), and the residual x - q * scale is
one fused multiply-add, one rounding (here in float64, where it is exact:
q * scale has at most 31 significant bits, and |x| >= scale / 2 wherever
q != 0, then rounded once to float32).  Like the reference's code
(which sums ``q.astype(int32)``), the payload is summed as int32: four
bytes an element on the wire, not one.  A true int8 wire format is later
work.  Collectives go through ``torch.distributed`` on the mesh's
``"pod"`` group; a ``"pod"`` mesh without an initialized process group
raises rather than skipping the sync.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.launch.mesh import mesh_axes

_INV_127 = float(np.float32(1.0) / np.float32(127.0))


def _scale(amax: torch.Tensor) -> torch.Tensor:
    return torch.clamp(amax * _INV_127, min=1e-12)


def _quantized_mean(x: torch.Tensor, scale: torch.Tensor, dtype, group
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(the group's mean of x quantized at ``scale``, in ``dtype``; the
    new float32 error state x - q * scale)."""
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    # accumulate in int32 to avoid overflow (the reference's payload)
    total = q.to(torch.int32)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    n = dist.get_world_size(group)
    # local quantization residual, one rounding
    new_err = (x.double() - q.double() * scale.double()).float()
    g_avg = total.float() * scale / n
    return g_avg.to(dtype), new_err


def ef_int8_allreduce(g: torch.Tensor, err: torch.Tensor, group
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """One tensor's error-feedback compressed all-reduce over ``group``:
    (the group's average gradient in g's dtype, the new float32 error
    state).

    The quantization scale is *shared* across the group (the all-reduced
    max of |g + e|): the summed payload then dequantizes exactly as scale
    * sum(q); per-rank scales would make the sum undecodable."""
    x = g.float() + err
    amax = x.abs().amax()
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    return _quantized_mean(x, _scale(amax), g.dtype, group)


def pod_group(mesh):
    """The ``"pod"`` process group of ``mesh``; raises without an
    initialized process group."""
    if not dist.is_initialized():
        raise RuntimeError(
            "the mesh has a 'pod' axis but no process group is "
            "initialized: the compressed sync cannot run (and is not "
            "skipped)")
    return mesh.get_group("pod")


def compressed_pod_sync(grads: Mapping[str, torch.Tensor],
                        err_state: Mapping[str, torch.Tensor], mesh,
                        scale_groups: Mapping[str, str] | None = None,
                        ) -> tuple[dict, dict]:
    """EF-int8 all-reduce over the mesh's ``"pod"`` axis of a gradient dict
    (name -> tensor); returns (averaged gradients, new error state).  A
    mesh without a ``"pod"`` axis returns both unchanged, as the reference
    does.

    Each tensor is quantized as :func:`ef_int8_allreduce` does, but the
    scales of all tensors are all-reduced at once (one collective of the
    maxima), and the tensors that ``scale_groups`` maps to one key share
    a scale: the max over them all.  The compressed train step maps each
    per-layer parameter to the reference's stacked leaf
    (:func:`repro_torch.models.model.stacked_leaf`), so both packages
    quantize on the same scales; without ``scale_groups`` every tensor
    has its own.  The sync runs under the profiler range
    ``ef_int8_sync``."""
    if "pod" not in mesh_axes(mesh):
        return grads, err_state
    group = pod_group(mesh)
    names = list(grads)
    keys = [scale_groups[n] if scale_groups else n for n in names]
    slot = {k: i for i, k in enumerate(dict.fromkeys(keys))}
    new_g, new_e = {}, {}
    with torch.profiler.record_function("ef_int8_sync"):
        # two passes over g + e (the maxima, then the payloads), so that
        # no float32 copy of every gradient is held at once
        by_key: dict[str, list] = {}
        for n, k in zip(names, keys):
            by_key.setdefault(k, []).append(
                (grads[n].float() + err_state[n]).abs().amax())
        amax = torch.stack([torch.stack(v).amax() for v in by_key.values()])
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
        scales = _scale(amax)
        for n, k in zip(names, keys):
            new_g[n], new_e[n] = _quantized_mean(
                grads[n].float() + err_state[n], scales[slot[k]],
                grads[n].dtype, group)
    return new_g, new_e


@torch.no_grad()
def init_error_state(grads_like: Mapping[str, torch.Tensor]) -> dict:
    """Zero float32 error state, one tensor per gradient, on its
    device."""
    return {n: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for n, g in grads_like.items()}
