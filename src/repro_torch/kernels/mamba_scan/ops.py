"""Entry points of Mamba's selective scan: dispatch by device.

A CUDA tensor goes to the hand-written kernels (``mamba_scan.py``), a CPU
tensor to the plain step loops (``ref.py``), and nothing else is taken.
There is no fallback between the two: on a CUDA tensor the kernel
launches or the call raises.

:func:`mamba_scan_trainable` is the training path's op, a
``torch.autograd.Function``: on a CUDA tensor its forward launches the
forward kernel and keeps the chunk-start states, and its backward launches
the backward kernel on them; on a CPU tensor it runs ``mamba_scan_ref``
and ``mamba_scan_bwd_ref``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.mamba_scan import mamba_scan as _kernel
from repro_torch.kernels.mamba_scan.ref import (
    mamba_scan_bwd_ref,
    mamba_scan_ref,
)


def _device(args) -> torch.device:
    devices = {t.device for t in args}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on different devices: {devices}")
    dev = devices.pop()
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"no Mamba scan for device {dev}")
    return dev


def _f32(args):
    return [t.to(torch.float32).contiguous() for t in args]


def mamba_scan(delta: torch.Tensor, x: torch.Tensor, a: torch.Tensor,
               bm: torch.Tensor, cm: torch.Tensor,
               h0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """delta, x (B, S, D); a (D, N); bm, cm (B, S, N); h0 (B, D, N) ->
    (y (B, S, D), final h (B, D, N)), float32; the inputs are read as
    float32."""
    args = (delta, x, a, bm, cm, h0)
    if _device(args).type == "cuda":
        return _kernel.mamba_scan_cuda(*_f32(args))[:2]
    return mamba_scan_ref(*args)


class _MambaScanTrainable(torch.autograd.Function):
    @staticmethod
    def forward(ctx, delta, x, a, bm, cm, h0):
        args = (delta, x, a, bm, cm, h0)
        ctx.cuda = _device(args).type == "cuda"
        ctx.dtypes = [t.dtype for t in args]
        ctx.set_materialize_grads(False)
        if ctx.cuda:
            ins = _f32(args)
            y, h, states = _kernel.mamba_scan_cuda(*ins)
            ctx.save_for_backward(*ins[:5], states)
        else:
            y, h = mamba_scan_ref(*args)
            ctx.save_for_backward(*args)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        saved = ctx.saved_tensors
        if dy is None and dh is None:
            return (None,) * 6
        if dy is None:
            dy = torch.zeros_like(saved[0], dtype=torch.float32)
        with torch.profiler.record_function("mamba_scan_backward"):
            if ctx.cuda:
                grads = _kernel.mamba_scan_bwd_cuda(
                    *saved[:5], dy.to(torch.float32).contiguous(), saved[5],
                    None if dh is None
                    else dh.to(torch.float32).contiguous())
            else:
                grads = mamba_scan_bwd_ref(*saved, dy, dh)
        return tuple(g.to(dt) for g, dt in zip(grads, ctx.dtypes))


def mamba_scan_trainable(
    delta: torch.Tensor, x: torch.Tensor, a: torch.Tensor, bm: torch.Tensor,
    cm: torch.Tensor, h0: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`mamba_scan` with a backward: returns (y, final h) as it
    does, and gives gradients to every input.  On a CUDA tensor the
    forward kernel keeps its chunk-start states, which the backward kernel
    reads; under ``torch.utils.checkpoint`` the forward runs again in the
    backward pass, so a remat'ed layer launches the forward twice and the
    backward once per step.  The gradients come in float32, cast to each
    input's dtype."""
    return _MambaScanTrainable.apply(delta, x, a, bm, cm, h0)
