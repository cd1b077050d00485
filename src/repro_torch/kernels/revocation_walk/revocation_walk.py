"""Build, binding and launch of the CUDA revocation-walk kernel.

The kernel (``csrc/revocation_walk.cu``) takes the place of the compiled
``lax.scan`` over hours in ``repro/capacity/preemption.py::revocation_walk``
(the scan at line 190); it is not a Pallas kernel.  One thread walks one
(draw, pool) lane through every hour with its state and price in
registers.  The walk moves five float32 arrays of T x N x P once (two
read, three written), so it is bound by bytes; the hour-major layout makes
every load and store of a warp one coalesced transaction.  It rounds each
step as the plain version (``ref.py``) does, so the two agree bit for bit.

The source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface and loaded with ``ctypes``, at the first launch,
never at import (:mod:`repro_torch.kernels.build`).

:func:`revocation_walk_cuda` takes CUDA tensors only and raises on
anything else; :mod:`ops` decides between it and the plain version by the
device of the tensors.  ``LAUNCHES`` counts the launches it made.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import build as _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "revocation_walk.cu"
_INT_MAX = 2**31 - 1

#: Kernel launches made by :func:`revocation_walk_cuda` in this process.
LAUNCHES = 0

_SIGNATURES = {
    "revocation_walk_launch": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # hazard, rec, band
        ctypes.c_void_p,                                    # avail0
        ctypes.c_void_p, ctypes.c_void_p,                   # us, zs
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # outputs
        ctypes.c_int, ctypes.c_int, ctypes.c_int,           # lanes, P, T
        ctypes.c_void_p,                                    # stream
    ],
}


def build() -> Path:
    """Compile the kernel if its library is not built yet; returns the
    library's path (its ``nvcc`` output beside it as ``<library>.log``)."""
    return _build.build(SOURCE)[0]


def load() -> ctypes.CDLL:
    """Build (if needed) and load the library; declares the C signature."""
    return _build.load(SOURCE, _SIGNATURES)


def _check(name: str, x, device, shape) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(x)}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if x.device.type != "cuda":
        raise ValueError(
            f"{name} is on {x.device}; the CUDA kernel takes CUDA tensors "
            "(ops.revocation_walk runs CPU tensors through the plain "
            "version)"
        )
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, us is on {device}")


def revocation_walk_cuda(
    hazard: torch.Tensor,
    recovery: torch.Tensor,
    band: torch.Tensor,
    avail0: torch.Tensor,
    us: torch.Tensor,
    zs: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the kernel: hazard, recovery, band (P,), avail0 (N, P), us,
    zs (T, N, P), contiguous float32 on one CUDA device -> (available,
    interrupted, price), each (T, N, P) float32, enqueued on the current
    stream without synchronizing."""
    global LAUNCHES
    if not isinstance(us, torch.Tensor) or us.dim() != 3:
        raise ValueError("us must be a (T, N, P) tensor")
    t, n, p = us.shape
    for name, x, shape in (("us", us, (t, n, p)), ("zs", zs, (t, n, p)),
                           ("avail0", avail0, (n, p)),
                           ("hazard", hazard, (p,)),
                           ("recovery", recovery, (p,)),
                           ("band", band, (p,))):
        _check(name, x, us.device, shape)
    if n * p > _INT_MAX or t > _INT_MAX:
        raise ValueError(
            f"walk of N={n}, P={p}, T={t} exceeds the kernel's index range")
    outs = tuple(torch.empty_like(us) for _ in range(3))
    if us.numel() == 0:
        return outs
    lib = load()
    # Inputs and outputs live in PyTorch's caching allocator, which reuses
    # a freed block only for work queued later on the same stream, so
    # launching on the current stream keeps every buffer valid until the
    # kernel has run.
    with torch.cuda.device(us.device):
        stream = torch.cuda.current_stream(us.device).cuda_stream
        err = lib.revocation_walk_launch(
            hazard.data_ptr(), recovery.data_ptr(), band.data_ptr(),
            avail0.data_ptr(), us.data_ptr(), zs.data_ptr(),
            *(o.data_ptr() for o in outs), n * p, p, t, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"revocation_walk kernel launch failed with CUDA error {err}"
        )
    LAUNCHES += 1
    return outs
