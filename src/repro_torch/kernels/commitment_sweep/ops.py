"""Entry point of the commitment sweep: shape handling and dispatch by
device.

A CUDA tensor goes to the hand-written kernel (``commitment_sweep.py``), a
CPU tensor to the plain version (``ref.py``), and nothing else is taken.
There is no fallback between the two: on a CUDA tensor the kernel launches
or the call raises.  The kernel masks ragged P, G and T itself, so unlike
the TPU entry point this one pads nothing.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.commitment_sweep import commitment_sweep as _kernel
from repro_torch.kernels.commitment_sweep.ref import (
    commitment_sweep_over_under_ref,
    commitment_sweep_ref,
)


def _prepare(f, cs, w):
    """(T,)/(G,) squeeze and broadcast cases -> 2-D f, w (P, T), cs (P, G)."""
    squeeze = f.dim() == 1
    if squeeze:
        f = f[None, :]
        if w is not None and w.dim() == 1:
            w = w[None, :]
    p = f.shape[0]
    if cs.dim() == 1:
        cs = cs[None, :].expand(p, cs.shape[0])
    if w is None:
        w = torch.ones_like(f)
    return f, cs, w, squeeze


def commitment_sweep_over_under(
    f: torch.Tensor,
    cs: torch.Tensor,
    w: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Raw over/under integrals for rows f (P, T) [or (T,)] over candidate
    levels cs (P, G) [or a shared (G,)], weighted by w (P, T) [ones when
    None].  Returns (over, under), each (P, G) [or (G,)] float32.

    On CUDA tensors this launches the CUDA kernel (inputs made contiguous,
    the kernel checks float32); on CPU tensors it runs the plain version."""
    f, cs, w, squeeze = _prepare(f, cs, w)
    devices = {f.device, cs.device, w.device}
    if len(devices) != 1:
        raise ValueError(f"f, cs and w lie on different devices: {devices}")
    if f.device.type == "cuda":
        over, under = _kernel.commitment_sweep_cuda(
            f.contiguous(), w.contiguous(), cs.contiguous()
        )
    elif f.device.type == "cpu":
        over, under = commitment_sweep_over_under_ref(f, w, cs)
    else:
        raise ValueError(f"no commitment sweep for device {f.device}")
    if squeeze:
        over, under = over[0], under[0]
    return over, under


def commitment_sweep(
    f: torch.Tensor,
    cs: torch.Tensor,
    w: torch.Tensor | None = None,
    *,
    a: float = 2.1,
    b: float = 1.0,
) -> torch.Tensor:
    """Cost curve C(c) = a*over + b*under for rows f (P, T) [or (T,)] over
    candidates cs, shared (G,) or per-row (P, G)."""
    over, under = commitment_sweep_over_under(f, cs, w)
    return a * over + b * under


def commitment_sweep_oracle(f, cs, w=None, a: float = 2.1, b: float = 1.0):
    """Plain-version cost curve on any device (for tests and comparisons)."""
    f, cs, w, _ = _prepare(f, cs, w)
    return commitment_sweep_ref(f, w, cs, a, b)


def commitment_sweep_over_under_oracle(f, cs, w=None):
    """Plain-version over/under on any device (for tests and comparisons)."""
    f, cs, w, _ = _prepare(f, cs, w)
    return commitment_sweep_over_under_ref(f, w, cs)
