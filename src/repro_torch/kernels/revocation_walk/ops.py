"""Entry point of the revocation walk: dispatch by device.

A CUDA tensor goes to the hand-written kernel (``revocation_walk.py``), a
CPU tensor to the plain per-hour loop (``ref.py``), and nothing else is
taken.  There is no fallback between the two: on a CUDA tensor the kernel
launches or the call raises.

Both write their outputs hour-major, (T, N, P), the layout in which a
warp's lanes (neighbouring pools) read and write neighbouring addresses;
:func:`revocation_walk` hands them out as (N, P, T) views, the reference's
layout, without a copy.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.revocation_walk import revocation_walk as _kernel
from repro_torch.kernels.revocation_walk.ref import revocation_walk_ref


def revocation_walk(
    hazard: torch.Tensor,
    recovery: torch.Tensor,
    band: torch.Tensor,
    avail0: torch.Tensor,
    us: torch.Tensor,
    zs: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """hazard, recovery, band (P,); avail0 (N, P); us, zs (T, N, P) ->
    (available, interrupted, price), each (N, P, T) float32, views of
    hour-major storage."""
    args = (hazard, recovery, band, avail0, us, zs)
    devices = {x.device for x in args}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on different devices: {devices}")
    dev = us.device
    if dev.type == "cuda":
        outs = _kernel.revocation_walk_cuda(
            *(x.to(torch.float32).contiguous() for x in args))
    elif dev.type == "cpu":
        outs = revocation_walk_ref(*(x.to(torch.float32) for x in args))
    else:
        raise ValueError(f"no revocation walk for device {dev}")
    return tuple(x.movedim(0, -1) for x in outs)
