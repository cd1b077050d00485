"""Build, binding, routing and launch of the CUDA flash-attention kernels.

Three hand-written kernels replace the Pallas TPU kernel
``repro/kernels/flash_attention/flash_attention.py::flash_attention_kernel``;
each keeps (m, l, acc) in registers and loops over KV tiles inside the
block in place of the TPU's sequential KV grid axis.  Each source's header
note says what bounds it on the card and what its design does about that:

``prefill_tc`` (``csrc/flash_prefill_tc.cu``)
    bf16, head dims (Dqk, Dv) of ``KERNEL_DIMS["prefill_tc"]``, ``Sq > 1``
    or Dqk != Dv: both products on ``wgmma``, Q/K/V tiles through TMA into
    a 3-stage mbarrier ring fed by a producer warp.
``decode_split`` (``csrc/flash_decode_split.cu``)
    ``Sq == 1`` with Dqk == Dv (the engine's batched decode), float32 or
    bf16, any GQA group: split-KV flash decoding, a split kernel writing
    float32 partials and a combine kernel (one launch of the pair).  Its
    int8 instance reads the quantized KV cache (int8 K and V, one bf16
    scale per position and kv head) with a kernel of its own: a split's
    rows staged in shared memory by ``cp.async``, each scale loaded once,
    the values dequantized without a conversion instruction (``prmt``
    into 2^23's mantissa, bf16 rounded two at a time), only the live
    query heads in registers, then the bf16/f32 instance's arithmetic in
    its order, so the two give the same bits on the same dequantized
    cache.  Both are bound by instructions, not bytes.
``simt`` (``csrc/flash_attention.cu``)
    everything else, on the CUDA cores: float32 prefill (whose 2e-5
    tolerance bf16 tensor cores cannot meet) and bf16 with head dim 32.

The value head dim may differ from the query/key head dim: MLA's prefill
attends with (Dqk, Dv) = (192, 128) (deepseek-v2-lite) or (96, 64)
(minicpm3); the output is (..., Dv).
    A register-tiled SGEMM inside the online softmax: 64 query rows per
    block, K/V tiles of 64 keys through a 2-stage cp.async ring, a 4 x 8
    score and output micro-tile per thread.

:func:`route` is the rule, by dtype, head dim and query length alone.  It
is not a fallback: a CUDA tensor launches the routed kernel or the call
raises (for example when a tensor is not 16-byte aligned for TMA or the
vector loads).  All three are built at first launch by
:mod:`repro_torch.kernels.build`, one ``nvcc`` per source, in parallel.

:func:`flash_attention_cuda` takes CUDA tensors only and raises on anything
else; :mod:`ops` decides between it and the plain version by the device of
the tensors.  ``LAUNCHES`` counts its launches, ``LAUNCHES_BY_KERNEL`` the
same launches by kernel, and ``LAUNCHES_INT8`` those of the decode's int8
instance (counted under ``"decode_split"`` too).
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import build as _build

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {
    "prefill_tc": _CSRC / "flash_prefill_tc.cu",
    "decode_split": _CSRC / "flash_decode_split.cu",
    "simt": _CSRC / "flash_attention.cu",
}
#: The (Dqk, Dv) head-dim pairs each kernel is built for.
KERNEL_DIMS = {
    "prefill_tc": ((64, 64), (128, 128), (192, 128), (96, 64)),
    "decode_split": ((32, 32), (64, 64), (128, 128)),
    "simt": ((32, 32), (64, 64), (128, 128), (192, 128), (96, 64)),
}
#: Keys per block of the split-KV decode: ceil(Skv / DECODE_SPLIT) splits.
DECODE_SPLIT = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: Kernel launches made by :func:`flash_attention_cuda` in this process.
LAUNCHES = 0
#: The same launches by kernel (a decode split + combine pair counts once).
LAUNCHES_BY_KERNEL = {name: 0 for name in SOURCES}
#: Launches of decode_split's int8 instance (an int8 KV cache), a part of
#: ``LAUNCHES_BY_KERNEL["decode_split"]``.
LAUNCHES_INT8 = 0

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "prefill_tc": {"flash_prefill_tc_launch": [
        _P, _P, _P, _P, _P,            # q, k, v, o, kv_len
        _I, _I, _I, _I, _I, _I, _I,    # B, Hq, Hkv, Sq, Skv, Dqk, Dv
        _P, _F, _I, _P,                # strides, scale, causal, stream
    ]},
    "decode_split": {"flash_decode_split_launch": [
        _P, _P, _P, _P, _P, _P, _P,    # q, k, v, o, kv_len, ml, acc
        _I, _I, _I, _I, _I, _I,        # B, Hq, Hkv, Skv, D, split
        _P, _F, _I, _P,                # strides, scale, dtype, stream
    ], "flash_decode_split_int8_launch": [
        _P, _P, _P, _P, _P,            # q, k, v, k_scale, v_scale
        _P, _P, _P, _P,                # o, kv_len, ml, acc
        _I, _I, _I, _I, _I, _I,        # B, Hq, Hkv, Skv, D, split
        _P, _F, _I, _P,                # strides, scale, dtype, stream
    ]},
    "simt": {"flash_attention_launch": [
        _P, _P, _P, _P, _P,            # q, k, v, o, kv_len
        _I, _I, _I, _I, _I, _I, _I,    # B, Hq, Hkv, Sq, Skv, Dqk, Dv
        _P, _F, _I, _I, _P,            # strides, scale, causal, dtype, stream
    ]},
}


def route(dtype: torch.dtype, d: int, sq: int, *,
          dv: int | None = None) -> str:
    """The kernel that serves a call with query/key head dim ``d`` and
    value head dim ``dv`` (default ``d``): ``"decode_split"`` for one query
    row with ``dv == d``, ``"prefill_tc"`` for bf16 at a head-dim pair it
    is built for, else ``"simt"``.  A pair the routed kernel is not built
    for is refused by :func:`flash_attention_cuda`."""
    dv = d if dv is None else dv
    if sq == 1 and dv == d:
        return "decode_split"
    if dtype == torch.bfloat16 and (d, dv) in KERNEL_DIMS["prefill_tc"]:
        return "prefill_tc"
    return "simt"


def build() -> list[Path]:
    """Compile the kernels whose libraries are not built yet, one ``nvcc``
    each, at once; returns the libraries' paths in ``SOURCES`` order (each
    ``nvcc`` output beside it as ``<library>.log``)."""
    return _build.build(*SOURCES.values())


def load(kernel: str | None = None):
    """Build (if needed) and load one kernel's library, declaring its C
    signature; without ``kernel``, build all three at once and return the
    libraries by name."""
    if kernel is None:
        build()
        return {name: load(name) for name in SOURCES}
    return _build.load(SOURCES[kernel], _SIGNATURES[kernel])


def _bhs_strides(x: torch.Tensor, seq_dim: int) -> tuple[int, int, int]:
    """Element strides (batch, head, seq) of a 4-D tensor whose seq axis is
    ``seq_dim`` (2 for (B, H, S, D), 1 for (B, S, H, D))."""
    head_dim = 3 - seq_dim
    return x.stride(0), x.stride(head_dim), x.stride(seq_dim)


def _check_16b(name: str, x: torch.Tensor, seq_dim: int, why: str) -> None:
    """Raise unless ``x``'s base and the strides of its batch, head and seq
    dims (those of extent > 1) are multiples of 16 bytes."""
    head_dim = 3 - seq_dim
    bad = x.data_ptr() % 16 != 0 or any(
        x.shape[dim] > 1 and x.stride(dim) * x.element_size() % 16
        for dim in (0, head_dim, seq_dim))
    if bad:
        raise ValueError(
            f"{name} is not 16-byte aligned ({why}): base {x.data_ptr()}, "
            f"strides {tuple(x.stride())}; make it contiguous")


def flash_attention_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_len: torch.Tensor,
    *,
    causal: bool,
    scale: float,
    seq_dim: int = 2,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Launch the kernel :func:`route` picks.  q, k, v are 4-D CUDA tensors of
    one dtype (float32 or bfloat16) laid out (B, H, S, D) (``seq_dim=2``)
    or (B, S, H, D) (``seq_dim=1``), any strides with the head dim
    contiguous; q and k share the head dim Dqk, v has its own Dv; kv_len
    is a (B,) int32 CUDA tensor that the host never reads.  With
    ``k_scale`` and ``v_scale`` (bf16, k's shape with head dim 1), k and v
    are an int8 cache, which only decode_split's int8 instance reads (one
    query row).  Returns a new contiguous tensor of q's shape with v's
    head dim and q's dtype, enqueued on the current stream without
    synchronizing."""
    global LAUNCHES, LAUNCHES_INT8
    if seq_dim not in (1, 2):
        raise ValueError(f"seq_dim must be 1 or 2, got {seq_dim}")
    head_dim = 3 - seq_dim
    int8 = k_scale is not None or v_scale is not None
    kv_dtype = torch.int8 if int8 else q.dtype
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(x)}")
        if x.device.type != "cuda" or x.device != q.device:
            raise ValueError(
                f"{name} is on {x.device}; the CUDA kernels take CUDA tensors "
                "on one device (ops.flash_attention runs CPU tensors through "
                "the plain version)")
        want = q.dtype if name == "q" else kv_dtype
        if x.dim() != 4 or x.dtype != want:
            raise ValueError(
                f"{name} must be 4-D of dtype {want}, got {tuple(x.shape)} "
                f"{x.dtype}")
        if x.stride(3) != 1:
            raise ValueError(f"{name}'s head dim must be contiguous")
    if q.dtype not in _DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    b, sq, hq, d = (q.shape[0], q.shape[seq_dim], q.shape[head_dim],
                    q.shape[3])
    skv, hkv, dv = k.shape[seq_dim], k.shape[head_dim], v.shape[3]
    if (tuple(v.shape[:3]) != tuple(k.shape[:3]) or k.shape[0] != b
            or k.shape[3] != d):
        raise ValueError(
            f"k {tuple(k.shape)} and v {tuple(v.shape)} do not match q "
            f"{tuple(q.shape)}")
    if hq % hkv:
        raise ValueError(f"{hq} query heads do not group over {hkv} kv heads")
    if (kv_len.dtype != torch.int32 or tuple(kv_len.shape) != (b,)
            or kv_len.device != q.device or not kv_len.is_contiguous()):
        raise ValueError("kv_len must be a contiguous (B,) int32 tensor on "
                         "q's device")
    if b > 65535 or hq > 65535 or max(sq, skv) * max(
            q.stride(seq_dim), k.stride(seq_dim)) >= 2**31:
        raise ValueError("attention shape exceeds the kernel's index range")
    name = route(q.dtype, d, sq, dv=dv)
    if (d, dv) not in KERNEL_DIMS[name]:
        raise ValueError(f"{name} takes head dims (Dqk, Dv) in "
                         f"{KERNEL_DIMS[name]}, got {(d, dv)}")
    if int8:
        if name != "decode_split":
            raise ValueError(f"an int8 cache is read by decode_split (one "
                             f"query row) only, not {name}")
        for label, x in (("k_scale", k_scale), ("v_scale", v_scale)):
            if (not isinstance(x, torch.Tensor) or x.device != q.device
                    or x.dtype != torch.bfloat16
                    or tuple(x.shape) != (*k.shape[:3], 1)):
                raise ValueError(
                    f"{label} must be a bf16 tensor of shape "
                    f"{(*k.shape[:3], 1)} on q's device")
    if name == "prefill_tc":
        for label, x in (("q", q), ("k", k), ("v", v)):
            _check_16b(label, x, seq_dim, "TMA loads its tiles")
    elif name == "decode_split":
        for label, x in (("k", k), ("v", v)):
            _check_16b(label, x, seq_dim, "the decode loads 16-byte vectors")
    else:
        for label, x in (("q", q), ("k", k), ("v", v)):
            _check_16b(label, x, seq_dim, "simt loads 16-byte vectors")
    out = torch.empty((*q.shape[:3], dv), dtype=q.dtype, device=q.device)
    if b == 0 or sq == 0 or hq == 0:
        return out
    strides = (ctypes.c_longlong * 12)(
        *_bhs_strides(q, seq_dim), *_bhs_strides(k, seq_dim),
        *_bhs_strides(v, seq_dim), *_bhs_strides(out, seq_dim))
    lib = load(name)
    # The kernels run after this call returns; every buffer (the decode's
    # scratch too) lives in PyTorch's caching allocator, which reuses a
    # freed block only for work queued later on the same stream, so
    # launching on the current stream keeps them valid until they have run.
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                kv_len.data_ptr())
        if name == "prefill_tc":
            err = lib.flash_prefill_tc_launch(
                *ptrs, b, hq, hkv, sq, skv, d, dv, strides, float(scale),
                int(bool(causal)), stream)
        elif name == "decode_split":
            splits = -(-skv // DECODE_SPLIT)
            scratch = torch.empty(b * hq * splits * (d + 2),
                                  dtype=torch.float32, device=q.device)
            ml_n = b * hq * splits * 2
            sizes = (b, hq, hkv, skv, d, DECODE_SPLIT)
            if int8:
                strides = (ctypes.c_longlong * 18)(
                    *strides, *_bhs_strides(k_scale, seq_dim),
                    *_bhs_strides(v_scale, seq_dim))
                err = lib.flash_decode_split_int8_launch(
                    *ptrs[:3], k_scale.data_ptr(), v_scale.data_ptr(),
                    *ptrs[3:], scratch.data_ptr(), scratch[ml_n:].data_ptr(),
                    *sizes, strides, float(scale), _DTYPES[q.dtype], stream)
            else:
                err = lib.flash_decode_split_launch(
                    *ptrs, scratch.data_ptr(), scratch[ml_n:].data_ptr(),
                    *sizes, strides, float(scale), _DTYPES[q.dtype], stream)
        else:
            err = lib.flash_attention_launch(
                *ptrs, b, hq, hkv, sq, skv, d, dv, strides, float(scale),
                int(bool(causal)), _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention {name} kernel launch failed with CUDA error "
            f"{err}")
    LAUNCHES += 1
    LAUNCHES_BY_KERNEL[name] += 1
    LAUNCHES_INT8 += int8
    return out
