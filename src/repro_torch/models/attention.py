"""Attention layers: GQA with (partial) rotary embeddings, and MLA
(DeepSeek/MiniCPM multi-head latent attention with the absorbed decode).

Three execution modes share one set of weights:
  * train    — full self-attention (causal unless ``causal=False``, as
               whisper's encoder asks), no cache;
  * prefill  — the same attention over the prompt, which also writes the
               KV cache;
  * decode   — the new token(s) against the cache at fill level ``pos``,
               a scalar or one level per batch row (per slot).

Every mode goes through the flash-attention ops
(``repro_torch.kernels.flash_attention.ops``): on the card the CUDA kernel
reads q and the cache in their (B, S, H, D) layout in place, with per-row
``kv_len``; on the CPU the plain version.  Train mode takes the
trainable op (``flash_attention_trainable``), whose backward recomputes
attention from q, k and v, causal or not (:func:`noncausal_attention`:
whisper's encoder and cross-attention, with ``kv_len``).  Caches are
laid out (B, S, Hkv, D), as the reference's, and are written in place.

With ``kv_cache_dtype="int8"`` a GQA cache holds int8 ``k``/``v`` and one
bf16 scale per position and kv head (``k_scale``/``v_scale``, (B, S, Hkv,
1)), the reference's absmax quantization (:func:`_quantize_kv`): prefill
writes the quantized cache and attends over the fresh k, v; decode writes
the new token quantized, then attends over the whole cache, which
decode_split's int8 instance dequantizes in registers
(``ref.dequantize_kv``'s formula).  MLA and RWKV caches ignore the field,
as in the reference.

MLA's cache holds the rank-``kv_lora_rank`` latent ``c_kv (B, S, r)`` and
the one-head rope key ``k_rope (B, S, rd)``.  Its prefill and train mode
expand them to per-head keys of width ``qk_nope + qk_rope`` and values of
width ``v_head_dim`` and attend through the flash kernels with Dqk != Dv
(train mode through the trainable op); its decode is the reference's
absorbed form, float32 einsums over the whole latent cache in plain torch
(the reference computes it outside any Pallas kernel; profiler range
``"mla_absorbed_decode"``).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.kernels.flash_attention.ops import (
    flash_attention,
    flash_attention_trainable,
)
from repro_torch.models.common import rms_norm, rms_norm_spec, rope_for
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import Spec, add_parameters


NEG_INF = -1e30


def gqa_specs(cfg: ModelConfig) -> dict[str, Spec]:
    d, h, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "wq": Spec((d, h, hd), ("embed", "heads", "head_dim"), fan_in=d),
        "wk": Spec((d, hkv, hd), ("embed", "kv_heads", "head_dim"), fan_in=d),
        "wv": Spec((d, hkv, hd), ("embed", "kv_heads", "head_dim"), fan_in=d),
        "wo": Spec((h, hd, d), ("heads", "head_dim", "embed"), fan_in=h * hd),
    }


def mla_specs(cfg: ModelConfig) -> dict[str, Spec]:
    """Multi-head latent attention's parameters (DeepSeek/MiniCPM): the
    reference's shape table."""
    d, h = cfg.d_model, cfg.num_heads
    qk = cfg.qk_nope_dim + cfg.qk_rope_dim
    s: dict[str, Spec] = {}
    if cfg.q_lora_rank:
        s["wq_a"] = Spec((d, cfg.q_lora_rank), ("embed", "lora"), fan_in=d)
        s["q_norm"] = rms_norm_spec(cfg.q_lora_rank)
        s["wq_b"] = Spec(
            (cfg.q_lora_rank, h, qk), ("lora", "heads", "head_dim"),
            fan_in=cfg.q_lora_rank,
        )
    else:
        s["wq"] = Spec((d, h, qk), ("embed", "heads", "head_dim"), fan_in=d)
    s["wkv_a"] = Spec((d, cfg.kv_lora_rank), ("embed", "lora"), fan_in=d)
    s["kv_norm"] = rms_norm_spec(cfg.kv_lora_rank)
    s["wk_rope"] = Spec((d, cfg.qk_rope_dim), ("embed", "head_dim"), fan_in=d)
    s["wk_b"] = Spec(
        (cfg.kv_lora_rank, h, cfg.qk_nope_dim),
        ("lora", "heads", "head_dim"), fan_in=cfg.kv_lora_rank,
    )
    s["wv_b"] = Spec(
        (cfg.kv_lora_rank, h, cfg.v_head_dim),
        ("lora", "heads", "head_dim"), fan_in=cfg.kv_lora_rank,
    )
    s["wo"] = Spec(
        (h, cfg.v_head_dim, d), ("heads", "head_dim", "embed"),
        fan_in=h * cfg.v_head_dim,
    )
    return s


def attn_specs(cfg: ModelConfig) -> dict[str, Spec]:
    """The attention parameters of ``cfg``'s layers (MLA or GQA)."""
    return mla_specs(cfg) if cfg.attention == "mla" else gqa_specs(cfg)


def mla_cache_specs(cfg: ModelConfig, batch: int,
                    seq: int) -> dict[str, Spec]:
    """One MLA layer's cache: the latent and the shared rope key."""
    return {
        "c_kv": Spec((batch, seq, cfg.kv_lora_rank),
                     ("batch", "cache_seq", "lora"), init="zeros"),
        "k_rope": Spec((batch, seq, cfg.qk_rope_dim),
                       ("batch", "cache_seq", "head_dim"), init="zeros"),
    }


def cache_specs(cfg: ModelConfig, batch: int, seq: int) -> dict[str, Spec]:
    """One layer's KV cache: MLA's latent cache, or k and v (B, S, Hkv, D)
    each, int8 with bf16 scales (B, S, Hkv, 1) under
    ``kv_cache_dtype="int8"``."""
    if cfg.attention == "mla":
        return mla_cache_specs(cfg, batch, seq)
    hkv, hd = cfg.num_kv_heads, cfg.head_dim
    axes = ("batch", "cache_seq", "kv_heads", "head_dim")
    if cfg.kv_cache_dtype == "int8":
        saxes = ("batch", "cache_seq", "kv_heads", None)
        return {
            "k": Spec((batch, seq, hkv, hd), axes, init="zeros",
                      dtype=torch.int8),
            "v": Spec((batch, seq, hkv, hd), axes, init="zeros",
                      dtype=torch.int8),
            "k_scale": Spec((batch, seq, hkv, 1), saxes, init="zeros",
                            dtype=torch.bfloat16),
            "v_scale": Spec((batch, seq, hkv, 1), saxes, init="zeros",
                            dtype=torch.bfloat16),
        }
    return {
        "k": Spec((batch, seq, hkv, hd), axes, init="zeros"),
        "v": Spec((batch, seq, hkv, hd), axes, init="zeros"),
    }


def _quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, S, H, D) -> int8 values and (B, S, H, 1) bf16 scales: the
    reference's absmax / 127 in float32 with a floor of 1e-8, values
    rounded half to even and clipped to +-127; the values are divided by
    the float32 scale, the stored scale is its bf16 rounding."""
    xf = x.to(torch.float32)
    scale = (xf.abs().amax(-1, keepdim=True) / 127.0).clamp_min(1e-8)
    q = torch.round(xf / scale).clamp(-127, 127)
    return q.to(torch.int8), scale.to(torch.bfloat16)


def update_cache(cache: torch.Tensor, new: torch.Tensor, pos) -> None:
    """Write ``new`` (B, S_new, ...) into ``cache`` (B, S, ...) at offset
    ``pos``, in place: an int, or a (B,) integer tensor of per-slot offsets.
    As the reference's ``dynamic_update_slice``, an offset is clamped to
    [0, S - S_new], so the write always fits."""
    s_new, s = new.shape[1], cache.shape[1]
    if isinstance(pos, torch.Tensor) and pos.dim() == 1:
        start = pos.to(torch.int64).clamp(0, s - s_new)
        rows = torch.arange(cache.shape[0], device=cache.device)[:, None]
        cols = start[:, None] + torch.arange(s_new, device=cache.device)
        cache[rows, cols] = new.to(cache.dtype)
        return
    start = min(max(int(pos), 0), s - s_new)
    cache[:, start:start + s_new] = new.to(cache.dtype)


class GQAAttention(nn.Module):
    """Grouped-query attention; parameters ``wq, wk, wv (d, H, D)`` and
    ``wo (H, D, d)``, the reference's layouts."""

    def __init__(self, cfg: ModelConfig, *, dtype, device):
        super().__init__()
        self.cfg = cfg
        add_parameters(self, gqa_specs(cfg), dtype, device)

    def forward(self, x, *, mode: str, cache, pos, positions,
                causal: bool = True):
        """x (B, S, d) -> y (B, S, d).  ``cache`` is this layer's
        {"k", "v"} (B, S_cache, Hkv, D) (and, int8, {"k_scale",
        "v_scale"}), written in place in prefill and decode; ``pos`` is
        the write offset (prefill) or fill level (decode), an int or a
        (B,) tensor; ``positions`` (B, S) are the rotary positions.
        ``causal=False`` (whisper's encoder) attends over every key, in
        train mode through the trainable op as well."""
        cfg = self.cfg
        b, s, d = x.shape
        h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        q = (x @ self.wq.reshape(d, h * hd)).view(b, s, h, hd)
        k = (x @ self.wk.reshape(d, hkv * hd)).view(b, s, hkv, hd)
        v = (x @ self.wv.reshape(d, hkv * hd)).view(b, s, hkv, hd)

        rot = int(hd * cfg.rotary_pct)
        if rot:
            q = torch.cat([rope_for(cfg, q[..., :rot], positions),
                           q[..., rot:]], -1)
            k = torch.cat([rope_for(cfg, k[..., :rot], positions),
                           k[..., rot:]], -1)

        scale = 1.0 / math.sqrt(hd)
        if mode == "train" and causal:
            out = flash_attention_trainable(q, k, v, scale=scale,
                                            layout="bshd")
        elif mode == "train":
            out = noncausal_attention(q, k, v, kv_len=s, scale=scale)
        elif mode == "prefill":
            self._write_cache(cache, k, v, pos)
            out = flash_attention(q, k, v, causal=causal, kv_len=s,
                                  scale=scale, layout="bshd")
        elif mode == "decode":
            self._write_cache(cache, k, v, pos)
            s_cache = cache["k"].shape[1]
            if isinstance(pos, torch.Tensor):
                kv_len = (pos + s).clamp(max=s_cache)
            else:
                kv_len = min(int(pos) + s, s_cache)
            out = flash_attention(q, cache["k"], cache["v"], causal=causal,
                                  kv_len=kv_len, scale=scale, layout="bshd",
                                  k_scale=cache.get("k_scale"),
                                  v_scale=cache.get("v_scale"))
        else:
            raise ValueError(f"unknown mode {mode!r}")
        return out.reshape(b, s, h * hd) @ self.wo.reshape(h * hd, d)

    def _write_cache(self, cache, k, v, pos) -> None:
        """k, v (B, S_new, Hkv, D) into the cache at ``pos``, quantized
        with their scales under ``kv_cache_dtype="int8"``."""
        if self.cfg.kv_cache_dtype == "int8":
            for name, x in (("k", k), ("v", v)):
                vals, scales = _quantize_kv(x)
                update_cache(cache[name], vals, pos)
                update_cache(cache[f"{name}_scale"], scales, pos)
            return
        update_cache(cache["k"], k, pos)
        update_cache(cache["v"], v, pos)


def noncausal_attention(q, k, v, *, kv_len, scale: float) -> torch.Tensor:
    """Bidirectional attention of q (B, Sq, H, D) over k, v (B, Skv, Hkv,
    D), keys at or past ``kv_len`` masked, through the flash op: whisper's
    encoder and cross-attention.  Under autograd it goes through the
    trainable op, whose backward is ``ops.attention_vjp``'s non-causal
    branch; the forward launches the same routed kernel either way."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return flash_attention_trainable(q, k, v, causal=False,
                                         kv_len=kv_len, scale=scale,
                                         layout="bshd")
    return flash_attention(q, k, v, causal=False, kv_len=kv_len, scale=scale,
                           layout="bshd")


def _decode_mask(b: int, sq: int, skv: int, pos, device) -> torch.Tensor:
    """(B, Sq, Skv) bool, True where masked: the reference's ``_mask`` for
    the causal decode, queries at ``pos`` (an int or a (B,) tensor) and
    ``kv_len = pos + Sq``."""
    pos = torch.as_tensor(pos, device=device).reshape(-1).expand(b)
    cols = torch.arange(skv, device=device)
    rows = pos[:, None] + torch.arange(sq, device=device)[None, :]
    return ((cols[None, None, :] >= (pos + sq)[:, None, None])
            | (cols[None, None, :] > rows[:, :, None]))


class MLAAttention(nn.Module):
    """Multi-head latent attention; parameters ``wq (d, H, qk)`` or the
    q-LoRA pair ``wq_a (d, q_lora)``, ``q_norm``, ``wq_b (q_lora, H, qk)``;
    ``wkv_a (d, r)``, ``kv_norm``, ``wk_rope (d, rd)``, ``wk_b (r, H,
    nope)``, ``wv_b (r, H, dv)`` and ``wo (H, dv, d)``, the reference's
    layouts (qk = nope + rd)."""

    def __init__(self, cfg: ModelConfig, *, dtype, device):
        super().__init__()
        self.cfg = cfg
        add_parameters(self, mla_specs(cfg), dtype, device)

    def forward(self, x, *, mode: str, cache, pos, positions):
        """x (B, S, d) -> y (B, S, d).  ``cache`` is this layer's
        {"c_kv" (B, S_cache, r), "k_rope" (B, S_cache, rd)}, written in
        place in prefill and decode; ``pos`` and ``positions`` as for
        :class:`GQAAttention`."""
        cfg = self.cfg
        b, s, d = x.shape
        h, nope, rd = cfg.num_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
        qk, dv, r = nope + rd, cfg.v_head_dim, cfg.kv_lora_rank
        if cfg.q_lora_rank:
            cq = rms_norm(x @ self.wq_a, self.q_norm, cfg.norm_eps)
            q = cq @ self.wq_b.reshape(cfg.q_lora_rank, h * qk)
        else:
            q = x @ self.wq.reshape(d, h * qk)
        q = q.view(b, s, h, qk)
        q_nope, q_rope = q[..., :nope], rope_for(cfg, q[..., nope:],
                                                 positions)
        c_kv = rms_norm(x @ self.wkv_a, self.kv_norm, cfg.norm_eps)
        k_rope = rope_for(cfg, (x @ self.wk_rope)[:, :, None, :],
                          positions)[:, :, 0, :]                 # (B, S, rd)
        scale = 1.0 / math.sqrt(qk)

        if mode in ("train", "prefill"):
            k_nope = (c_kv @ self.wk_b.reshape(r, h * nope)).view(
                b, s, h, nope)
            v = (c_kv @ self.wv_b.reshape(r, h * dv)).view(b, s, h, dv)
            k_full = torch.cat(
                [k_nope, k_rope[:, :, None, :].expand(b, s, h, rd)], -1)
            q_full = torch.cat([q_nope, q_rope], -1)
            if mode == "prefill":
                update_cache(cache["c_kv"], c_kv, pos)
                update_cache(cache["k_rope"], k_rope, pos)
                out = flash_attention(q_full, k_full, v, kv_len=s,
                                      scale=scale, layout="bshd")
            else:
                out = flash_attention_trainable(q_full, k_full, v,
                                                scale=scale, layout="bshd")
        elif mode == "decode":
            update_cache(cache["c_kv"], c_kv, pos)
            update_cache(cache["k_rope"], k_rope, pos)
            with torch.profiler.record_function("mla_absorbed_decode"):
                out = self._absorbed_decode(q_nope, q_rope, cache, pos,
                                            scale).to(x.dtype)
        else:
            raise ValueError(f"unknown mode {mode!r}")
        return out.reshape(b, s, h * dv) @ self.wo.reshape(h * dv, d)

    def _absorbed_decode(self, q_nope, q_rope, cache, pos, scale):
        """The reference's weight-absorbed decode, in float32: scores and
        values contracted in latent space over the whole cache, masked at
        each row's fill level; returns (B, S, H, dv) float32."""
        b, s = q_nope.shape[:2]
        ck = cache["c_kv"].float()                               # (B, T, r)
        kr = cache["k_rope"].float()                             # (B, T, rd)
        q_lat = torch.einsum("bshk,rhk->bshr", q_nope.float(),
                             self.wk_b.float())
        scores = (torch.einsum("bshr,btr->bhst", q_lat, ck)
                  + torch.einsum("bshk,btk->bhst", q_rope.float(), kr)
                  ) * scale
        mask = _decode_mask(b, s, ck.shape[1], pos, q_nope.device)
        scores = scores.masked_fill(mask[:, None], NEG_INF)
        w = torch.softmax(scores, dim=-1)                        # (B,H,S,T)
        lat = torch.einsum("bhst,btr->bshr", w, ck)
        return torch.einsum("bshr,rhk->bshk", lat, self.wv_b.float())
