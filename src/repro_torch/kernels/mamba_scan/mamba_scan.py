"""Build, binding and launch of the CUDA selective-scan kernel.

The kernel (``csrc/mamba_scan.cu``) takes the place of the
``jax.lax.associative_scan`` in ``repro/models/mamba.py::_ssm_scan`` (the
scan at line 94); it is not a Pallas kernel.  A few neighbouring lanes of
a warp hold the N states of one (batch, channel) recurrence in registers
(four each) and walk the sequence in order; each step's y is their sum by
warp shuffles.  A block stages tiles of steps through shared memory, the
next tile's loads in flight while it walks the current one.  It moves
delta, x and y once (12 bytes per (step, channel)), so it is bound by
bytes.

The source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface and loaded with ``ctypes``, at the first launch,
never at import (:mod:`repro_torch.kernels.build`).

:func:`mamba_scan_cuda` takes CUDA tensors only and raises on anything
else; :mod:`ops` decides between it and the plain version by the device of
the tensors.  ``LAUNCHES`` counts the launches it made.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import build as _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "mamba_scan.cu"
#: State sizes the kernel is built for: jamba's 16 and the reduced
#: configs' 8 (a new config's size gets its instance in ``mamba_scan.cu``).
STATE_SIZES = (8, 16)
_INT_MAX = 2**31 - 1

#: Kernel launches made by :func:`mamba_scan_cuda` in this process.
LAUNCHES = 0

_SIGNATURES = {
    "mamba_scan_launch": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # delta, x, a
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # bm, cm, h0
        ctypes.c_void_p, ctypes.c_void_p,                   # y, h_out
        ctypes.c_int, ctypes.c_int, ctypes.c_int,           # B, S, D
        ctypes.c_int,                                       # N
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
            "(ops.mamba_scan runs CPU tensors through the plain version)")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, delta is on {device}")


def mamba_scan_cuda(
    delta: torch.Tensor,
    x: torch.Tensor,
    a: torch.Tensor,
    bm: torch.Tensor,
    cm: torch.Tensor,
    h0: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel: delta, x (B, S, D); a (D, N); bm, cm (B, S, N);
    h0 (B, D, N), contiguous float32 on one CUDA device, N in
    ``STATE_SIZES`` -> (y (B, S, D), final h (B, D, N)) float32, enqueued
    on the current stream without synchronizing."""
    global LAUNCHES
    if not isinstance(delta, torch.Tensor) or delta.dim() != 3:
        raise ValueError("delta must be a (B, S, D) tensor")
    if not isinstance(a, torch.Tensor) or a.dim() != 2:
        raise ValueError("a must be a (D, N) tensor")
    b, s, d = delta.shape
    n = a.shape[1]
    for name, t, shape in (("delta", delta, (b, s, d)), ("x", x, (b, s, d)),
                           ("a", a, (d, n)), ("bm", bm, (b, s, n)),
                           ("cm", cm, (b, s, n)), ("h0", h0, (b, d, n))):
        _check(name, t, delta.device, shape)
    if n not in STATE_SIZES:
        raise ValueError(f"the kernel takes state sizes {STATE_SIZES}, "
                         f"got {n}")
    if b * s * d > _INT_MAX or b * d * n > _INT_MAX:
        raise ValueError(f"scan of B={b}, S={s}, D={d}, N={n} exceeds the "
                         "kernel's index range")
    y = torch.empty_like(delta)
    h_out = torch.empty_like(h0)
    if b * d == 0:
        return y, h_out
    if s == 0:
        h_out.copy_(h0)
        return y, h_out
    lib = load()
    # Inputs and outputs live in PyTorch's caching allocator, which reuses
    # a freed block only for work queued later on the same stream, so
    # launching on the current stream keeps every buffer valid until the
    # kernel has run.
    with torch.cuda.device(delta.device):
        stream = torch.cuda.current_stream(delta.device).cuda_stream
        err = lib.mamba_scan_launch(
            delta.data_ptr(), x.data_ptr(), a.data_ptr(), bm.data_ptr(),
            cm.data_ptr(), h0.data_ptr(), y.data_ptr(), h_out.data_ptr(),
            b, s, d, n, stream)
    if err != 0:
        raise RuntimeError(
            f"mamba_scan kernel launch failed with CUDA error {err}")
    LAUNCHES += 1
    return y, h_out
