"""Entry point of flash attention: layouts, ``kv_len`` and dispatch by
device.

A CUDA tensor goes to the hand-written kernel that
``flash_attention.route`` names for its dtype, head dim and query rows
(tensor-core bf16 prefill, split-KV decode, or the SIMT kernel), a CPU
tensor to the plain version (``ref.py``), and nothing else is taken.
There is no fallback: on a CUDA tensor the routed kernel launches or the
call raises.  The kernels mask ragged ``Sq`` and ``Skv`` themselves, so
unlike the TPU entry point this one pads nothing.

The training path's ``flash_attention_trainable`` (a backward that
recomputes the reference) is not ported yet (ROADMAP Queue 1, item 16).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention as _kernel
from repro_torch.kernels.flash_attention.ref import attention_ref

_SEQ_DIM = {"bhsd": 2, "bshd": 1}


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    kv_len: "int | torch.Tensor | None" = None,
    scale: float | None = None,
    layout: str = "bhsd",
) -> torch.Tensor:
    """Attention of q over k, v; returns q's shape and dtype.

    ``layout="bhsd"``: q (B, Hq, Sq, D), k/v (B, Hkv, Skv, D), the
    reference's layout.  ``layout="bshd"``: q (B, Sq, Hq, D), k/v
    (B, Skv, Hkv, D), the model's projections and KV cache, read in place.
    ``kv_len`` (default Skv) is an int or a (B,) integer tensor: the
    queries are the last Sq positions of each row's ``kv_len``-token
    context, and keys at or past ``kv_len`` are masked."""
    if layout not in _SEQ_DIM:
        raise ValueError(f"layout must be one of {sorted(_SEQ_DIM)}")
    seq_dim = _SEQ_DIM[layout]
    devices = {q.device, k.device, v.device}
    if len(devices) != 1:
        raise ValueError(f"q, k and v lie on different devices: {devices}")
    b, d, skv = q.shape[0], q.shape[3], k.shape[seq_dim]
    scale = d ** -0.5 if scale is None else scale
    if kv_len is None:
        kv_len = skv
    if q.device.type == "cuda":
        lens = torch.as_tensor(kv_len, device=q.device).reshape(-1)
        lens = lens.expand(b).to(torch.int32).contiguous()
        return _kernel.flash_attention_cuda(
            q, k, v, lens, causal=causal, scale=scale, seq_dim=seq_dim)
    if q.device.type != "cpu":
        raise ValueError(f"no flash attention for device {q.device}")
    if seq_dim == 1:
        out = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=causal, kv_len=kv_len,
                            scale=scale)
        return out.transpose(1, 2).contiguous()
    return attention_ref(q, k, v, causal=causal, kv_len=kv_len, scale=scale)

