"""Entry point of Mamba's selective scan: dispatch by device.

A CUDA tensor goes to the hand-written kernel (``mamba_scan.py``), a CPU
tensor to the plain step loop (``ref.py``), and nothing else is taken.
There is no fallback between the two: on a CUDA tensor the kernel
launches or the call raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.mamba_scan import mamba_scan as _kernel
from repro_torch.kernels.mamba_scan.ref import mamba_scan_ref


def mamba_scan(delta: torch.Tensor, x: torch.Tensor, a: torch.Tensor,
               bm: torch.Tensor, cm: torch.Tensor,
               h0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """delta, x (B, S, D); a (D, N); bm, cm (B, S, N); h0 (B, D, N) ->
    (y (B, S, D), final h (B, D, N)), float32; the inputs are read as
    float32."""
    args = (delta, x, a, bm, cm, h0)
    devices = {t.device for t in args}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on different devices: {devices}")
    dev = delta.device
    if dev.type == "cuda":
        return _kernel.mamba_scan_cuda(
            *(t.to(torch.float32).contiguous() for t in args))
    if dev.type == "cpu":
        return mamba_scan_ref(*args)
    raise ValueError(f"no Mamba scan for device {dev}")
