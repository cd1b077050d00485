"""Build, binding and launch of the CUDA commitment-sweep kernel.

The kernel (``csrc/commitment_sweep.cu``) replaces the Pallas TPU kernel
``repro/kernels/commitment_sweep/commitment_sweep.py::commitment_sweep_kernel``.
It is FP32 work on the CUDA cores (about 6 flops per row x candidate x hour
triple), so it is bound by operations rather than by the bytes of ``f`` and
``w``; the source's header note says how its design answers that and why
its T sums do not depend on the row tiling.

The source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface and loaded with ``ctypes``, at the first launch,
never at import.  The library lands in ``build/repro_torch_kernels/`` at
the repository root (override with ``REPRO_TORCH_BUILD_DIR``), named by a
hash of the source and the flags, so an edited source rebuilds.

:func:`commitment_sweep_cuda` takes CUDA tensors only and raises on
anything else; :mod:`ops` decides between it and the plain version by the
device of the tensors.  ``LAUNCHES`` counts the launches it made.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "commitment_sweep.cu"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_INT_MAX = 2**31 - 1
# Candidate tiles run on grid.y, which CUDA caps at 65535 blocks of 128.
_MAX_CANDIDATES = 65535 * 128

#: Kernel launches made by :func:`commitment_sweep_cuda` in this process.
LAUNCHES = 0

_LIB = None


def build_dir() -> Path:
    """Where the shared library is built (created on demand)."""
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    # src/repro_torch/kernels/commitment_sweep/ -> repository root
    return Path(__file__).resolve().parents[4] / "build" / "repro_torch_kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "commitment-sweep kernel is built from source at first use"
    )


def library_path() -> Path:
    """The shared library's path for the current source and flags."""
    digest = hashlib.sha256(
        SOURCE.read_bytes() + "\0".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return build_dir() / f"libcommitment_sweep_{digest}.so"


def build() -> Path:
    """Compile the kernel if its library is not built yet; returns the
    library's path.  The compiler's output (``-Xptxas -v``: registers,
    shared memory, spills) is kept beside it as ``<library>.log``.  The
    library is written under a temporary name and renamed into place, so
    concurrent builds never load a half-written file."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
            capture_output=True, text=True,
        )
        log = proc.stdout + proc.stderr
        Path(str(out) + ".log").write_text(log)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) building {SOURCE}:\n{log}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load() -> ctypes.CDLL:
    """Build (if needed) and load the library; declares the C signature."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.commitment_sweep_launch
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # f, w, cs
            ctypes.c_void_p, ctypes.c_void_p,                    # over, under
            ctypes.c_int, ctypes.c_int, ctypes.c_int,            # P, G, T
            ctypes.c_void_p,                                     # stream
        ]
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


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
