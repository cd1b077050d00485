"""Entry point of the commitment sweep: shape handling and dispatch by
device.

A CUDA tensor goes to the hand-written kernel (``commitment_sweep.py``), a
CPU tensor to the plain version (``ref.py``), and nothing else is taken.
:func:`optimal_commitment_sweep`, the grid+refine solver, is built on it.
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


def _stage_costs_plain(f, cands, a, b):
    """The reference's stage formula: C at per-row candidates (P, n)."""
    diff = f[:, None, :] - cands[:, :, None]
    return torch.where(diff > 0, a * diff, -b * diff).sum(-1)


def _grid_refine(f, a, b, num_coarse, num_fine, stage_costs):
    if f.dim() == 1:
        f = f[None, :]
    lo = f.amin(-1)
    span = f.amax(-1) - lo

    def stage(lo, span, n):
        steps = torch.arange(n, dtype=f.dtype, device=f.device) / (n - 1)
        cands = lo[:, None] + span[:, None] * steps[None, :]     # (P, n)
        best = torch.argmin(stage_costs(f, cands, a, b), dim=-1)
        c_best = torch.gather(cands, 1, best[:, None])[:, 0]
        return (torch.maximum(c_best - span / (n - 1), lo),
                2.0 * span / (n - 1), c_best)

    lo1, span1, _ = stage(lo, span, num_coarse)
    return stage(lo1, span1, num_fine)[2]


def optimal_commitment_sweep(
    f: torch.Tensor,
    *,
    a: float = 2.1,
    b: float = 1.0,
    num_coarse: int = 128,
    num_fine: int = 128,
) -> torch.Tensor:
    """Grid+refine minimizer of C(c) for rows f (P, T) [or (T,)]: a coarse
    grid over each row's [min, max], then a fine grid inside the best
    coarse bracket; within ~range/G^2 of the exact quantile.  Returns (P,).

    On CUDA tensors each stage is one launch of the kernel with per-row
    candidates (P, n); on CPU tensors it is the reference's stage formula.
    ``argmin`` takes the first minimum on both."""
    if f.device.type == "cpu":
        return _grid_refine(f, a, b, num_coarse, num_fine, _stage_costs_plain)
    return _grid_refine(
        f, a, b, num_coarse, num_fine,
        lambda f, cs, a, b: commitment_sweep(f, cs, a=a, b=b),
    )


def optimal_commitment_sweep_oracle(f, *, a: float = 2.1, b: float = 1.0,
                                    num_coarse: int = 128,
                                    num_fine: int = 128):
    """Plain-version grid+refine on any device (for tests and comparisons;
    it materializes (P, n, T), so callers chunk large P)."""
    return _grid_refine(f, a, b, num_coarse, num_fine, _stage_costs_plain)
