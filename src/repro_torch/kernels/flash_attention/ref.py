"""Plain PyTorch version of flash attention — the spec the CUDA kernel is
held to.

``q (B, Hq, Sq, Dqk)``, ``k (B, Hkv, Skv, Dqk)``, ``v (B, Hkv, Skv, Dv)``
-> ``(B, Hq, Sq, Dv)`` in ``q``'s dtype, computed in float32; the default
scale is ``Dqk ** -0.5``.  Query head ``h`` reads kv head
``h // (Hq // Hkv)``.  Key column ``j`` is masked when ``j >= kv_len`` and,
when causal, when ``j > kv_len - Sq + i``: the queries are the last ``Sq``
positions of a context of ``kv_len`` tokens.  ``kv_len`` is an int (the
reference's scalar) or a ``(B,)`` integer tensor, one fill level per batch
row, as a batched decode over slots of different lengths needs.  It
materializes the (B, Hq, Sq, Skv) scores, so callers at long lengths run it
over query chunks.

An int8 KV cache (values and one bf16 scale per position and kv head) is
read through :func:`dequantize_kv`, the model reference's formula, then
attended as above (:func:`attention_int8_ref`).
"""

from __future__ import annotations

import torch


def attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    kv_len: "int | torch.Tensor | None" = None,
    scale: float | None = None,
) -> torch.Tensor:
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    if hq % hkv:
        raise ValueError(f"{hq} query heads do not group over {hkv} kv heads")
    group = hq // hkv
    scale = d ** -0.5 if scale is None else scale
    if kv_len is None:
        kv_len = skv
    lens = torch.as_tensor(kv_len, device=q.device).reshape(-1)
    lens = lens.expand(b).to(torch.int64)                         # (B,)

    kr = k.float().repeat_interleave(group, dim=1)
    vr = v.float().repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr) * scale
    col = torch.arange(skv, device=q.device)
    mask = col[None, None, :] >= lens[:, None, None]              # (B,1,Skv)
    if causal:
        row = torch.arange(sq, device=q.device)[None, :] + (lens[:, None] - sq)
        mask = mask | (col[None, None, :] > row[:, :, None])      # (B,Sq,Skv)
    s = s.masked_fill(mask[:, None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vr).to(q.dtype)


def attention_split_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_len: "int | torch.Tensor",
    split: int,
    *,
    scale: float | None = None,
) -> torch.Tensor:
    """The split-KV decode's algebra in plain PyTorch, for one query row:
    ``q (B, Hq, 1, D)``, ``k, v (B, Hkv, Skv, D)``.  Keys are cut into
    splits of ``split``; each split keeps its own max ``m``, sum ``l`` and
    unnormalised ``acc`` over its keys below ``kv_len`` (an empty split has
    m = -inf, l = 0), and the combine rescales the splits to their common
    max.  Equals :func:`attention_ref` with ``Sq = 1``; a row with no key
    gets zeros.  Used by the tests and the smoke run, never by the port."""
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    if sq != 1:
        raise ValueError(f"the split decode takes one query row, got {sq}")
    group = hq // hkv
    scale = d ** -0.5 if scale is None else scale
    lens = torch.as_tensor(kv_len, device=q.device).reshape(-1)
    lens = lens.expand(b).to(torch.int64)
    splits = -(-skv // split)
    pad = splits * split - skv
    kr = k.float().repeat_interleave(group, dim=1)
    vr = v.float().repeat_interleave(group, dim=1)
    s = torch.einsum("bhd,bhkd->bhk", q[:, :, 0].float(), kr) * scale
    col = torch.arange(splits * split, device=q.device)
    s = torch.nn.functional.pad(s, (0, pad))
    s = s.masked_fill(col[None, None] >= lens[:, None, None], float("-inf"))
    s = s.view(b, hq, splits, split)
    vr = torch.nn.functional.pad(vr, (0, 0, 0, pad)).view(
        b, hq, splits, split, d)
    m = s.amax(-1)                                             # (B,Hq,n)
    p = torch.exp(s - torch.where(m == float("-inf"), 0.0, m)[..., None])
    l = p.sum(-1)
    acc = torch.einsum("bhnk,bhnkd->bhnd", p, vr)
    mx = m.amax(-1, keepdim=True)
    w = torch.exp(m - torch.where(mx == float("-inf"), 0.0, mx))
    den = (w * l).sum(-1)[..., None]
    num = (w[..., None] * acc).sum(-2)
    out = torch.where(den > 0, num / torch.where(den > 0, den, 1.0), 0.0)
    return out[:, :, None].to(q.dtype)


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """int8 values ``q`` times their bf16 ``scale`` (broadcast over the
    head dim), in float32, cast to ``dtype``: the reference's
    ``_dequantize_kv``, and what decode_split's int8 instance computes in
    registers."""
    return (q.to(torch.float32) * scale.to(torch.float32)).to(dtype)


def attention_int8_ref(q, k, v, k_scale, v_scale, **kw) -> torch.Tensor:
    """:func:`attention_ref` over an int8 cache ``k``, ``v`` (the layout of
    :func:`attention_ref`) with bf16 scales ``k_scale``, ``v_scale`` (k's
    shape, head dim 1), dequantized to q's dtype first."""
    return attention_ref(q, dequantize_kv(k, k_scale, q.dtype),
                         dequantize_kv(v, v_scale, q.dtype), **kw)
