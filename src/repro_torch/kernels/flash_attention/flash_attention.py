"""Build, binding and launch of the CUDA flash-attention kernel.

The kernel (``csrc/flash_attention.cu``) replaces the Pallas TPU kernel
``repro/kernels/flash_attention/flash_attention.py::flash_attention_kernel``.
It keeps (m, l, acc) in registers and loops over KV tiles inside the block
in place of the TPU's sequential KV grid axis; the source's header note says
what bounds it on the card and what the design does about that.  Built at
first launch by :mod:`repro_torch.kernels.build`.

:func:`flash_attention_cuda` takes CUDA tensors only and raises on anything
else; :mod:`ops` decides between it and the plain version by the device of
the tensors.  ``LAUNCHES`` counts the launches it made.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import build as _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
HEAD_DIMS = (32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: Kernel launches made by :func:`flash_attention_cuda` in this process.
LAUNCHES = 0

_SIGNATURES = {
    "flash_attention_launch": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # q, k, v
        ctypes.c_void_p, ctypes.c_void_p,                    # o, kv_len
        ctypes.c_int, ctypes.c_int, ctypes.c_int,            # B, Hq, Hkv
        ctypes.c_int, ctypes.c_int, ctypes.c_int,            # Sq, Skv, D
        ctypes.c_void_p,                                     # strides
        ctypes.c_float, ctypes.c_int, ctypes.c_int,          # scale, causal, dtype
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


def _bhs_strides(x: torch.Tensor, seq_dim: int) -> tuple[int, int, int]:
    """Element strides (batch, head, seq) of a 4-D tensor whose seq axis is
    ``seq_dim`` (2 for (B, H, S, D), 1 for (B, S, H, D))."""
    head_dim = 3 - seq_dim
    return x.stride(0), x.stride(head_dim), x.stride(seq_dim)


def flash_attention_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_len: torch.Tensor,
    *,
    causal: bool,
    scale: float,
    seq_dim: int = 2,
) -> torch.Tensor:
    """Launch the kernel.  q, k, v are 4-D CUDA tensors of one dtype
    (float32 or bfloat16) laid out (B, H, S, D) (``seq_dim=2``) or
    (B, S, H, D) (``seq_dim=1``), any strides with the head dim contiguous;
    kv_len is a (B,) int32 CUDA tensor.  Returns a new contiguous tensor of
    q's shape and dtype, enqueued on the current stream without
    synchronizing."""
    global LAUNCHES
    if seq_dim not in (1, 2):
        raise ValueError(f"seq_dim must be 1 or 2, got {seq_dim}")
    head_dim = 3 - seq_dim
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(x)}")
        if x.device.type != "cuda" or x.device != q.device:
            raise ValueError(
                f"{name} is on {x.device}; the CUDA kernel takes CUDA tensors "
                "on one device (ops.flash_attention runs CPU tensors through "
                "the plain version)")
        if x.dim() != 4 or x.dtype != q.dtype:
            raise ValueError(
                f"{name} must be 4-D of q's dtype, got {tuple(x.shape)} "
                f"{x.dtype}")
        if x.stride(3) != 1:
            raise ValueError(f"{name}'s head dim must be contiguous")
    if q.dtype not in _DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    b, sq, hq, d = (q.shape[0], q.shape[seq_dim], q.shape[head_dim],
                    q.shape[3])
    skv, hkv = k.shape[seq_dim], k.shape[head_dim]
    if tuple(v.shape) != tuple(k.shape) or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(
            f"k {tuple(k.shape)} and v {tuple(v.shape)} do not match q "
            f"{tuple(q.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if hq % hkv:
        raise ValueError(f"{hq} query heads do not group over {hkv} kv heads")
    if (kv_len.dtype != torch.int32 or tuple(kv_len.shape) != (b,)
            or kv_len.device != q.device or not kv_len.is_contiguous()):
        raise ValueError("kv_len must be a contiguous (B,) int32 tensor on "
                         "q's device")
    if b > 65535 or hq > 65535 or max(sq, skv) * max(
            q.stride(seq_dim), k.stride(seq_dim)) >= 2**31:
        raise ValueError("attention shape exceeds the kernel's index range")
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if b == 0 or sq == 0 or hq == 0:
        return out
    strides = (ctypes.c_longlong * 12)(
        *_bhs_strides(q, seq_dim), *_bhs_strides(k, seq_dim),
        *_bhs_strides(v, seq_dim), *_bhs_strides(out, seq_dim))
    lib = load()
    # The kernel runs after this call returns; every buffer lives in
    # PyTorch's caching allocator, which reuses a freed block only for work
    # queued later on the same stream, so launching on the current stream
    # keeps them valid until it has run.
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            kv_len.data_ptr(), b, hq, hkv, sq, skv, d, strides,
            float(scale), int(bool(causal)), _DTYPES[q.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed with CUDA error {err}")
    LAUNCHES += 1
    return out
