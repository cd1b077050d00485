"""Plain PyTorch version of the revocation walk: the spec the CUDA kernel
is held to, and the CPU path.

One hour of the fleet, for every (draw n, pool p) lane (the reference's
``repro.capacity.preemption._step``):

    nxt         = (u >= hazard[p]) if avail > 0.5 else (u < recovery[p])
    interrupted = avail * (1 - nxt)
    price       = clip(0.9 * price + (0.3 * band[p]) * z, -band[p], band[p])
    outputs       nxt, interrupted, 1 + price

from ``avail0`` and a price walk starting at 0.  Every product and sum is
a separate float32 operation, rounded once: no multiply-add is fused, so
the kernel, which rounds the same steps explicitly, equals this version
bit for bit.
"""

from __future__ import annotations

import torch


def revocation_walk_ref(
    hazard: torch.Tensor,
    recovery: torch.Tensor,
    band: torch.Tensor,
    avail0: torch.Tensor,
    us: torch.Tensor,
    zs: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """hazard, recovery, band (P,); avail0 (N, P); us, zs (T, N, P), all
    float32 on one device -> (available, interrupted, price), each
    (T, N, P) float32: a loop over the hours that writes each hour's
    outputs in place."""
    out = [torch.empty_like(us) for _ in range(3)]
    hz, rc, b = hazard[None, :], recovery[None, :], band[None, :]
    b3 = 0.3 * b
    avail = avail0
    price = torch.zeros_like(avail0)
    for t in range(us.shape[0]):
        u = us[t]
        nxt = torch.where(avail > 0.5, u >= hz, u < rc).to(torch.float32)
        out[1][t] = avail * (1.0 - nxt)
        price = torch.clamp(0.9 * price + b3 * zs[t], -b, b)
        out[0][t] = nxt
        out[2][t] = 1.0 + price
        avail = nxt
    return out[0], out[1], out[2]
