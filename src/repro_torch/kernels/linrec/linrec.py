"""Build, binding and launch of the CUDA RWKV6 recurrence kernels.

Three kernels (``csrc/linrec.cu``), launched in turn by one
:func:`rwkv6_cuda` call, replace the Pallas TPU kernel
``repro/kernels/linrec/linrec.py::rwkv6_kernel`` in the chunk-parallel
form of its algebra (chunks of L = 32): ``rwkv6_chunk_kernel`` (one block
per chunk: its own output, state increment and total decay),
``rwkv6_state_scan_kernel`` (the states entering the chunks, sequential
over chunks only) and ``rwkv6_inter_kernel`` (each chunk's output from its
entering state).  Every decay is a product of exp(logw) factors, each in
[0, 1], over a stretch of steps; the source's header note says what bounds
the kernels and what the design does about it.  Built at first launch by
:mod:`repro_torch.kernels.build`.

:func:`rwkv6_cuda` takes CUDA tensors only and raises on anything else;
:mod:`ops` decides between it and the plain version by the device of the
tensors.  ``LAUNCHES`` counts its calls (the three kernels of one call
count once).
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import build as _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "linrec.cu"
CHUNK = 32
MAX_DK = 64
MAX_DV = 64

#: Launches made by :func:`rwkv6_cuda` in this process (one per call).
LAUNCHES = 0

_SIGNATURES = {
    "rwkv6_launch": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # r, k, v
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # logw, u, s0
        ctypes.c_void_p, ctypes.c_void_p,                    # y, s_out
        ctypes.c_void_p, ctypes.c_void_p,                    # d_state, decay
        ctypes.c_int, ctypes.c_int, ctypes.c_int,            # B, H, T
        ctypes.c_int, ctypes.c_int,                          # dk, dv
        ctypes.c_void_p, ctypes.c_void_p,                    # strides, stream
    ],
}


def build() -> Path:
    """Compile the kernel if its library is not built yet; returns the
    library's path (its ``nvcc`` output beside it as ``<library>.log``)."""
    return _build.build(SOURCE)[0]


def load() -> ctypes.CDLL:
    """Build (if needed) and load the library; declares the C signature."""
    return _build.load(SOURCE, _SIGNATURES)


def rwkv6_cuda(r, k, v, logw, u, s0, *, time_dim: int = 2,
               entering: bool = False):
    """Launch the three kernels.  r, k, logw (B, H, T, dk) and v
    (B, H, T, dv) (``time_dim=2``), or (B, T, H, .) (``time_dim=1``),
    float32 CUDA tensors with the channel dim contiguous; u (H, dk) and s0
    (B, H, dk, dv) contiguous float32, s0 16-byte aligned; dk <= 64, dv <=
    64 and a multiple of 4 (the scan moves 4 floats at a time).  Returns
    (y in v's layout, contiguous, and the final state (B, H, dk, dv)), both
    float32, enqueued on the current stream without synchronizing.  With
    ``entering``, also the states entering the chunks, (B, H, C, dk, dv):
    the scratch the scan leaves them in."""
    global LAUNCHES
    if time_dim not in (1, 2):
        raise ValueError(f"time_dim must be 1 or 2, got {time_dim}")
    head_dim = 3 - time_dim
    for name, x in (("r", r), ("k", k), ("v", v), ("logw", logw), ("u", u),
                    ("s0", s0)):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(x)}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if x.device.type != "cuda" or x.device != r.device:
            raise ValueError(
                f"{name} is on {x.device}; the CUDA kernel takes CUDA tensors "
                "on one device (ops runs CPU tensors through the plain "
                "version)")
        if x.stride(-1) != 1:
            raise ValueError(f"{name}'s last dim must be contiguous")
    b, t, h, dk = r.shape[0], r.shape[time_dim], r.shape[head_dim], r.shape[3]
    dv = v.shape[3]
    for name, x in (("k", k), ("logw", logw)):
        if tuple(x.shape) != tuple(r.shape):
            raise ValueError(f"{name} shape {tuple(x.shape)} != r's "
                             f"{tuple(r.shape)}")
    if (v.dim() != 4 or v.shape[0] != b or v.shape[time_dim] != t
            or v.shape[head_dim] != h):
        raise ValueError(f"v shape {tuple(v.shape)} does not match r's")
    if tuple(u.shape) != (h, dk) or not u.is_contiguous():
        raise ValueError(f"u must be a contiguous ({h}, {dk}) tensor")
    if tuple(s0.shape) != (b, h, dk, dv) or not s0.is_contiguous():
        raise ValueError(f"s0 must be a contiguous ({b}, {h}, {dk}, {dv}) "
                         "tensor")
    if not 0 < dk <= MAX_DK:
        raise ValueError(f"dk {dk} outside the kernel's 1..{MAX_DK}")
    if dv > MAX_DV or dv % 4:
        raise ValueError(f"dv {dv} is not a multiple of 4 up to {MAX_DV}")
    if s0.data_ptr() % 16:
        raise ValueError("s0 must be 16-byte aligned (make it a fresh tensor)")
    if b > 65535 or h > 65535 or b * h * dk * dv >= 2**31 or t * max(
            x.stride(time_dim) for x in (r, k, v, logw)) >= 2**31:
        raise ValueError("recurrence shape exceeds the kernel's index range")
    y = torch.empty(v.shape, dtype=torch.float32, device=r.device)
    s_out = torch.empty((b, h, dk, dv), dtype=torch.float32, device=r.device)
    chunks = -(-t // CHUNK)
    # Scratch: each chunk's state increment, which the scan overwrites with
    # the state entering the chunk, then each chunk's total decay.
    scratch = torch.empty(b * h * chunks * (dk * dv + dk),
                          dtype=torch.float32, device=r.device)
    states = scratch[:b * h * chunks * dk * dv].view(b, h, chunks, dk, dv)
    if b == 0 or h == 0 or dv == 0:
        return (y, s_out, states) if entering else (y, s_out)

    def bht(x):
        return x.stride(0), x.stride(head_dim), x.stride(time_dim)

    strides = (ctypes.c_longlong * 15)(
        *bht(r), *bht(k), *bht(v), *bht(logw), *bht(y))
    lib = load()
    # Launched on the current stream: see flash_attention_cuda on why every
    # buffer (the scratch too) stays valid until the kernels have run.
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = lib.rwkv6_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
            u.data_ptr(), s0.data_ptr(), y.data_ptr(), s_out.data_ptr(),
            scratch.data_ptr(), scratch[states.numel():].data_ptr(),
            b, h, t, dk, dv, strides, stream,
        )
    if err != 0:
        raise RuntimeError(f"rwkv6 kernel launch failed with CUDA error {err}")
    LAUNCHES += 1
    return (y, s_out, states) if entering else (y, s_out)
