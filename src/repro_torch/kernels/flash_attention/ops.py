"""Entry point of flash attention: layouts, ``kv_len`` and dispatch by
device.

A CUDA tensor goes to the hand-written kernel that
``flash_attention.route`` names for its dtype, head dims and query rows
(tensor-core bf16 prefill, split-KV decode, or the SIMT kernel), a CPU
tensor to the plain version (``ref.py``), and nothing else is taken.
There is no fallback: on a CUDA tensor the routed kernel launches or the
call raises.  The kernels mask ragged ``Sq`` and ``Skv`` themselves, so
unlike the TPU entry point this one pads nothing.

An int8 KV cache comes with its bf16 scales (``k_scale=``, ``v_scale=``).
One query row over it launches decode_split's int8 instance, which
dequantizes in registers; several query rows (a multi-token decode, which
no main path runs) are dequantized first by the same formula
(``ref.dequantize_kv``) and go to the kernel their shape routes to; a CPU
tensor runs the plain version on the dequantized cache.

:func:`flash_attention_trainable` is the training path's op, a
``torch.autograd.Function``: its forward is :func:`flash_attention` (the
routed kernel on the card), its backward the reference's, the VJP of
attention recomputed from q, k and v (:func:`attention_vjp`), causal or
not, with ``kv_len``, in query chunks of ``TRAIN_CHUNK`` with
``torch.matmul``.  The backward never calls ``ref.py``, so the plain
version stays off the card's path.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention as _kernel
from repro_torch.kernels.flash_attention.ref import (
    attention_ref,
    dequantize_kv,
)

_SEQ_DIM = {"bhsd": 2, "bshd": 1}
#: Query rows per block of the backward (the reference model's train chunk).
TRAIN_CHUNK = 1024


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    kv_len: "int | torch.Tensor | None" = None,
    scale: float | None = None,
    layout: str = "bhsd",
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Attention of q over k, v; returns q's shape with v's head dim, in
    q's dtype.

    ``layout="bhsd"``: q (B, Hq, Sq, Dqk), k (B, Hkv, Skv, Dqk), v
    (B, Hkv, Skv, Dv), the reference's layout.  ``layout="bshd"``: q
    (B, Sq, Hq, Dqk), k/v (B, Skv, Hkv, D), the model's projections and KV
    cache, read in place.  Dv may differ from Dqk (MLA's prefill); the
    default scale is Dqk ** -0.5.
    ``kv_len`` (default Skv) is an int or a (B,) integer tensor: the
    queries are the last Sq positions of each row's ``kv_len``-token
    context, and keys at or past ``kv_len`` are masked.
    ``k_scale``/``v_scale``: with an int8 k and v (the quantized KV
    cache), their bf16 scales, k's shape with head dim 1; each value
    counts as ``dequantize_kv`` makes it, in q's dtype."""
    if layout not in _SEQ_DIM:
        raise ValueError(f"layout must be one of {sorted(_SEQ_DIM)}")
    seq_dim = _SEQ_DIM[layout]
    devices = {q.device, k.device, v.device}
    if len(devices) != 1:
        raise ValueError(f"q, k and v lie on different devices: {devices}")
    int8 = k.dtype == torch.int8
    if not (int8 == (v.dtype == torch.int8) == (k_scale is not None)
            == (v_scale is not None)):
        raise ValueError("an int8 k and v take both k_scale and v_scale, "
                         "and only they do")
    b, d, skv = q.shape[0], q.shape[3], k.shape[seq_dim]
    scale = d ** -0.5 if scale is None else scale
    if kv_len is None:
        kv_len = skv
    if int8 and (q.device.type != "cuda" or _kernel.route(
            q.dtype, d, q.shape[seq_dim], dv=v.shape[3]) != "decode_split"):
        # dispatch by shape: only the one-row decode reads int8 in a kernel
        k, v = (dequantize_kv(k, k_scale, q.dtype),
                dequantize_kv(v, v_scale, q.dtype))
        k_scale = v_scale = None
    if q.device.type == "cuda":
        lens = torch.as_tensor(kv_len, device=q.device).reshape(-1)
        lens = lens.expand(b).to(torch.int32).contiguous()
        return _kernel.flash_attention_cuda(
            q, k, v, lens, causal=causal, scale=scale, seq_dim=seq_dim,
            k_scale=k_scale, v_scale=v_scale)
    if q.device.type != "cpu":
        raise ValueError(f"no flash attention for device {q.device}")
    if seq_dim == 1:
        out = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=causal, kv_len=kv_len,
                            scale=scale)
        return out.transpose(1, 2).contiguous()
    return attention_ref(q, k, v, causal=causal, kv_len=kv_len, scale=scale)



def attention_vjp(q, k, v, g, *, scale: float, layout: str = "bhsd",
                  chunk: int = TRAIN_CHUNK, causal: bool = True,
                  kv_len: "int | torch.Tensor | None" = None):
    """Gradients (dq, dk, dv) of attention at (q, k, v) for the output
    gradient ``g``, in the inputs' layout and dtypes.  v and g may have a
    head dim of their own (Dv, MLA's); dv takes v's shape.

    The mask is :func:`flash_attention`'s: keys at or past ``kv_len`` (an
    int or a (B,) integer tensor, default Skv) are masked and, when
    ``causal``, the queries are the last Sq of each row's ``kv_len``
    positions.  Query rows go in chunks of ``chunk``; each chunk
    recomputes, in float32, P = softmax(scale q k^T) over the keys it can
    see, then dV += P^T dO, dP = dO V^T, dS = P (dP - rowsum(dO O)) with
    O = P V, dQ = scale dS K and dK += scale dS^T Q.  The query heads of a
    GQA group ride one matmul against their kv head, so dK and dV come out
    summed over the group.  At most two (B, Hkv, G x chunk, keys) float32
    blocks are live: P and dP, which turns into dS in place.  Causal
    attention without ``kv_len`` reads only the keys a chunk can see (Sq
    <= Skv); otherwise every chunk reads all Skv keys under a per-row
    mask, Sq and Skv in any proportion, and a row with no key left gets
    zero gradients."""
    if layout not in _SEQ_DIM:
        raise ValueError(f"layout must be one of {sorted(_SEQ_DIM)}")
    if layout == "bshd":
        q, k, v, g = (x.transpose(1, 2) for x in (q, k, v, g))
    b, hq, sq, d = q.shape
    hkv, skv, d_v = k.shape[1], k.shape[2], v.shape[3]
    if hq % hkv:
        raise ValueError(f"{hq} query heads do not group over {hkv} kv heads")
    prefix = causal and kv_len is None
    if prefix and sq > skv:
        raise ValueError(f"{sq} queries over {skv} keys: causal attention "
                         "needs Sq <= Skv")
    grp, off = hq // hkv, skv - sq
    lens = None
    if not prefix:
        lens = torch.as_tensor(skv if kv_len is None else kv_len,
                               device=q.device).reshape(-1)
        lens = lens.expand(b).to(torch.int64)
    kf, vf = k.float(), v.float()
    dq = torch.empty((b, hq, sq, d), dtype=torch.float32, device=q.device)
    dk = torch.zeros((b, hkv, skv, d), dtype=torch.float32, device=q.device)
    dv = torch.zeros((b, hkv, skv, d_v), dtype=torch.float32, device=q.device)
    for a in range(0, sq, chunk):
        e = min(a + chunk, sq)
        n = e - a
        keys = off + e if prefix else skv
        qc = q[:, :, a:e].float().reshape(b, hkv, grp * n, d)
        gc = g[:, :, a:e].float().reshape(b, hkv, grp * n, d_v)
        kc, vc = kf[:, :, :keys], vf[:, :, :keys]
        p = torch.matmul(qc, kc.transpose(-1, -2)).mul_(scale)
        col = torch.arange(keys, device=q.device)
        if prefix:
            row = torch.arange(off + a, off + e, device=q.device)
            masked = (col[None, :] > row[:, None]).repeat(grp, 1)
        else:
            masked = (col[None, None, :] >= lens[:, None, None]).expand(
                b, n, keys)
            if causal:
                row = (torch.arange(a, e, device=q.device)[None, :]
                       + (lens[:, None] - sq))                  # (B, n)
                masked = masked | (col[None, None, :] > row[:, :, None])
            masked = masked.repeat(1, grp, 1)[:, None]
        p.masked_fill_(masked, float("-inf"))
        if prefix:
            p.sub_(p.amax(-1, keepdim=True)).exp_()
            p.div_(p.sum(-1, keepdim=True))
        else:
            top = p.amax(-1, keepdim=True)
            p.sub_(torch.where(torch.isfinite(top), top, 0.0)).exp_()
            den = p.sum(-1, keepdim=True)
            p.div_(torch.where(den > 0, den, 1.0))
        dv[:, :, :keys] += torch.matmul(p.transpose(-1, -2), gc)
        delta = (gc * torch.matmul(p, vc)).sum(-1, keepdim=True)
        ds = torch.matmul(gc, vc.transpose(-1, -2)).sub_(delta).mul_(p)
        del p
        ds.mul_(scale)
        dq[:, :, a:e] = torch.matmul(ds, kc).view(b, hq, n, d)
        dk[:, :, :keys] += torch.matmul(ds.transpose(-1, -2), qc)
        del ds
    grads = (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))
    if layout == "bshd":
        return tuple(x.transpose(1, 2) for x in grads)
    return grads


class _FlashTrainable(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale, layout, causal, kv_len):
        ctx.save_for_backward(q, k, v)
        ctx.scale, ctx.layout = scale, layout
        ctx.causal, ctx.kv_len = causal, kv_len
        return flash_attention(q, k, v, causal=causal, kv_len=kv_len,
                               scale=scale, layout=layout)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        # profiler ranges: the causal backward, and the non-causal one
        # (whisper's encoder and cross-attention) apart
        label = ("flash_attention_backward" if ctx.causal
                 else "flash_attention_backward_noncausal")
        with torch.profiler.record_function(label):
            dq, dk, dv = attention_vjp(q, k, v, g, scale=ctx.scale,
                                       layout=ctx.layout, causal=ctx.causal,
                                       kv_len=ctx.kv_len)
        return dq, dk, dv, None, None, None, None


def flash_attention_trainable(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: float | None = None,
    layout: str = "bhsd",
    causal: bool = True,
    kv_len: "int | torch.Tensor | None" = None,
) -> torch.Tensor:
    """:func:`flash_attention` with a backward, its mask included: causal
    (the queries the last Sq of each row's ``kv_len`` positions) or not
    (whisper's encoder and cross-attention, Sq and Skv in any
    proportion), keys at or past ``kv_len`` (default Skv) masked.  The
    forward launches the routed kernel on a CUDA tensor (``prefill_tc``
    for bf16 at the head-dim pairs it is built for, (64, 64), (128, 128)
    and MLA's (192, 128) and (96, 64); ``simt`` for float32) and runs the
    plain version on a CPU tensor; a pair the routed kernel is not built
    for is refused by the kernel's wrapper.  The backward is
    :func:`attention_vjp` on either, at v's own head dim, with the same
    mask.  Under ``torch.utils.checkpoint`` the forward runs again in the
    backward pass, so a remat'ed layer launches the kernel twice per
    step."""
    if layout not in _SEQ_DIM:
        raise ValueError(f"layout must be one of {sorted(_SEQ_DIM)}")
    scale = q.shape[3] ** -0.5 if scale is None else scale
    return _FlashTrainable.apply(q, k, v, scale, layout, causal, kv_len)
