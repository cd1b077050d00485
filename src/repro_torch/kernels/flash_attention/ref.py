"""Plain PyTorch version of flash attention — the spec the CUDA kernel is
held to.

``q (B, Hq, Sq, D)``, ``k, v (B, Hkv, Skv, D)`` -> ``(B, Hq, Sq, D)`` in
``q``'s dtype, computed in float32.  Query head ``h`` reads kv head
``h // (Hq // Hkv)``.  Key column ``j`` is masked when ``j >= kv_len`` and,
when causal, when ``j > kv_len - Sq + i``: the queries are the last ``Sq``
positions of a context of ``kv_len`` tokens.  ``kv_len`` is an int (the
reference's scalar) or a ``(B,)`` integer tensor, one fill level per batch
row, as a batched decode over slots of different lengths needs.  It
materializes the (B, Hq, Sq, Skv) scores, so callers at long lengths run it
over query chunks.
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
