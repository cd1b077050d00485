"""Build, binding and launch of the CUDA turnover kernel.

The kernel (``csrc/generation_turnover.cu``) takes the place of the
compiled ``lax.scan`` over hours in
``repro/capacity/generations.py::migrate_demand`` (the scan at line 275);
it is not a Pallas kernel.  The scan's carry is the closed form of the
adoption curve at every hour, so the pass is elementwise: one thread per
(unit, hour), hours contiguous, where a unit is an edge's (source,
successor) pair or a pool on no edge.  It moves 2 P T float32 values
(every row read once and written once), so it is bound by bytes.  It rounds each step as the
plain version (``ref.py``) does, so the two agree bit for bit.

The source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface and loaded with ``ctypes``, at the first launch,
never at import (:mod:`repro_torch.kernels.build`).

:func:`generation_turnover_cuda` takes CUDA tensors only and raises on
anything else; :mod:`ops` decides between it and the plain version by the
device of the tensors.  ``LAUNCHES`` counts the launches it made.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import build as _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "generation_turnover.cu"
_INT_MAX = 2**31 - 1

#: Kernel launches made by :func:`generation_turnover_cuda` in this process.
LAUNCHES = 0

_SIGNATURES = {
    "generation_turnover_launch": [
        ctypes.c_void_p,                                    # base
        ctypes.c_void_p, ctypes.c_void_p,                   # unit rows, edge
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # gain, mid, rate
        ctypes.c_float,                                     # -sw_log
        ctypes.c_void_p,                                    # out
        ctypes.c_int, ctypes.c_int,                         # U, T
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


def _check(name: str, x, device, shape, dtype) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(x)}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if x.device.type != "cuda":
        raise ValueError(
            f"{name} is on {x.device}; the CUDA kernel takes CUDA tensors "
            "(ops.turnover runs CPU tensors through the plain version)"
        )
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, base is on {device}")


def generation_turnover_cuda(
    base: torch.Tensor,
    unit_rows: torch.Tensor,
    unit_edge: torch.Tensor,
    inv_gain: torch.Tensor,
    midpoint_hours: torch.Tensor,
    rate_per_hour: torch.Tensor,
    sw_log: float,
) -> torch.Tensor:
    """Launch the kernel: base (P, T) float32; unit_rows (U, 2) int32 (an
    edge's source and successor rows, or a lone pool's row and -1) and
    unit_edge (U,) int32 (the edge index, -1 for a lone pool), covering
    every pool once (``ops.units`` builds them); inv_gain, midpoint_hours,
    rate_per_hour (G,) float32, all contiguous on one CUDA device -> (P, T)
    float32, enqueued on the current stream without synchronizing."""
    global LAUNCHES
    if not isinstance(base, torch.Tensor) or base.dim() != 2:
        raise ValueError("base must be a (P, T) tensor")
    p, t = base.shape
    u = unit_edge.shape[0] if isinstance(unit_edge, torch.Tensor) else -1
    g = inv_gain.shape[0] if isinstance(inv_gain, torch.Tensor) else -1
    for name, x, shape, dtype in (
            ("base", base, (p, t), torch.float32),
            ("unit_rows", unit_rows, (u, 2), torch.int32),
            ("unit_edge", unit_edge, (u,), torch.int32),
            ("inv_gain", inv_gain, (g,), torch.float32),
            ("midpoint_hours", midpoint_hours, (g,), torch.float32),
            ("rate_per_hour", rate_per_hour, (g,), torch.float32)):
        _check(name, x, base.device, shape, dtype)
    if u != p - g:
        raise ValueError(f"{u} units for {p} pools and {g} edges: the units "
                         "must cover every pool once")
    if p > _INT_MAX or t > 2**24:
        raise ValueError(
            f"turnover of P={p}, T={t}: hours must stay below 2^24, where "
            "float32 holds every hour exactly")
    out = torch.empty_like(base)
    if base.numel() == 0:
        return out
    lib = load()
    # Inputs and output live in PyTorch's caching allocator, which reuses a
    # freed block only for work queued later on the same stream, so
    # launching on the current stream keeps every buffer valid until the
    # kernel has run.
    with torch.cuda.device(base.device):
        stream = torch.cuda.current_stream(base.device).cuda_stream
        err = lib.generation_turnover_launch(
            base.data_ptr(), unit_rows.data_ptr(), unit_edge.data_ptr(),
            inv_gain.data_ptr(), midpoint_hours.data_ptr(),
            rate_per_hour.data_ptr(), -float(sw_log), out.data_ptr(), u, t,
            stream,
        )
    if err != 0:
        raise RuntimeError(
            f"generation_turnover kernel launch failed with CUDA error {err}"
        )
    LAUNCHES += 1
    return out
