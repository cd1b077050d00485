"""Build, binding and launch of the CUDA commitment-sweep kernel.

The kernel (``csrc/commitment_sweep.cu``) replaces the Pallas TPU kernel
``repro/kernels/commitment_sweep/commitment_sweep.py::commitment_sweep_kernel``.
It does not compare every hour with every candidate, as the TPU kernel
does: it sorts each row's candidates, drops each hour with a nonzero
weight into the bucket between two neighbouring candidates by binary
search, and takes over and under from per-bucket sums in one scan, so it
is bound by reading ``f`` and ``w`` once.  Its sums are int64 fixed point,
exact in any order: a rerun, a batched launch and a launch per row block
agree bit for bit, and ``ref.commitment_sweep_bucketed_ref`` is the same
algebra in plain PyTorch, bit for bit.  The source's header
note gives the algebra.

The source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface and loaded with ``ctypes``, at the first launch,
never at import (:mod:`repro_torch.kernels.build`).

:func:`commitment_sweep_cuda` takes CUDA tensors only and raises on
anything else; :mod:`ops` decides between it and the plain version by the
device of the tensors.  ``LAUNCHES`` counts the launches it made.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels.commitment_sweep.ref import CANDIDATE_TILE

SOURCE = Path(__file__).resolve().parent / "csrc" / "commitment_sweep.cu"
_INT_MAX = 2**31 - 1
# Candidate tiles of 128 run on grid.y, which CUDA caps at 65535 blocks.
_MAX_CANDIDATES = 65535 * CANDIDATE_TILE
#: The launch as the source sets it (kThreads, kTile): one block of
#: THREADS threads per (row, tile of CANDIDATE_TILE candidates), each with
#: SHARED_BYTES of static shared memory: the tile's float32 candidates and
#: their uint8 order, three int64 bucket sums of tile + 1 entries, and five
#: float32 partial sums per warp.
THREADS = 128
SHARED_BYTES = (5 * CANDIDATE_TILE + 3 * 8 * (CANDIDATE_TILE + 1)
                + 5 * 4 * (THREADS // 32))

#: Kernel launches made by :func:`commitment_sweep_cuda` in this process.
LAUNCHES = 0

_SIGNATURES = {
    "commitment_sweep_launch": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # f, w, cs
        ctypes.c_void_p, ctypes.c_void_p,                    # over, under
        ctypes.c_int, ctypes.c_int, ctypes.c_int,            # P, G, T
        ctypes.c_void_p,                                     # stream
    ],
}


def build() -> Path:
    """Compile the kernel if its library is not built yet; returns the
    library's path (its ``nvcc`` output beside it as ``<library>.log``)."""
    return _build.build(SOURCE)[0]


def load() -> ctypes.CDLL:
    """Build (if needed) and load the library; declares the C signature."""
    return _build.load(SOURCE, _SIGNATURES)


def _check(name: str, x, device, ndim: int) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(x)}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {x.dtype}")
    if x.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if x.device.type != "cuda":
        raise ValueError(
            f"{name} is on {x.device}; the CUDA kernel takes CUDA tensors "
            "(ops.commitment_sweep_over_under runs CPU tensors through the "
            "plain version)"
        )
    if device is not None and x.device != device:
        raise ValueError(f"{name} is on {x.device}, f is on {device}")


def commitment_sweep_cuda(
    f: torch.Tensor, w: torch.Tensor, cs: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel: f, w (P, T) and cs (P, G), contiguous float32 on
    one CUDA device -> (over, under), each (P, G) float32, enqueued on the
    current stream without synchronizing."""
    global LAUNCHES
    _check("f", f, None, 2)
    _check("w", w, f.device, 2)
    _check("cs", cs, f.device, 2)
    p, t = f.shape
    g = cs.shape[1]
    if tuple(w.shape) != (p, t):
        raise ValueError(f"w shape {tuple(w.shape)} != f shape {(p, t)}")
    if cs.shape[0] != p:
        raise ValueError(f"cs has {cs.shape[0]} rows, f has {p}")
    if p * max(t, g) > _INT_MAX or g > _MAX_CANDIDATES:
        raise ValueError(
            f"sweep of shape P={p}, G={g}, T={t} exceeds the kernel's "
            "index range"
        )
    over = torch.empty((p, g), dtype=torch.float32, device=f.device)
    under = torch.empty((p, g), dtype=torch.float32, device=f.device)
    if p == 0 or g == 0:
        return over, under
    lib = load()
    # The kernel runs after this call returns.  Inputs and outputs live in
    # PyTorch's caching allocator, which reuses a freed block only for work
    # queued later on the same stream, so launching on the current stream
    # keeps every buffer valid until the kernel has run.
    with torch.cuda.device(f.device):
        stream = torch.cuda.current_stream(f.device).cuda_stream
        err = lib.commitment_sweep_launch(
            f.data_ptr(), w.data_ptr(), cs.data_ptr(),
            over.data_ptr(), under.data_ptr(), p, g, t, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"commitment_sweep kernel launch failed with CUDA error {err}"
        )
    LAUNCHES += 1
    return over, under
