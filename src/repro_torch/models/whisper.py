"""Whisper-small encoder-decoder backbone (audio family).

As in the JAX package, the conv/mel frontend is a stub: the encoder takes
precomputed frame embeddings ``enc_frames`` (B, encoder_seq, d).  The
backbone is the reference's: a bidirectional encoder (learned ``enc_pos``,
non-causal attention, ``enc_norm``), and a decoder of causal self-attention
with a cache, cross-attention over the encoder's output and gelu MLPs,
with learned ``dec_pos`` at each row's positions (``rotary_pct`` is 0: no
rotary embedding anywhere).

Encoder and decoder layers are two ``nn.ModuleList``s, ``enc_layers`` and
``dec_layers``, in order (the reference stacks each and scans it;
``convert.model_params_from_reference`` splits the stacks).  Every
attention goes through the flash ops (in train mode their trainable
forms, whose backward recomputes attention causal or not): the encoder's
and the cross-attention at ``causal=False`` with ``kv_len =
encoder_seq``, so a prefill launches one flash kernel per encoder layer
and two per decoder layer (self and cross), a decode step two per
decoder layer.

The cache holds, per decoder layer, the self-attention's ``k``/``v`` (B,
S, Hkv, D) and the cross-attention's ``cross_k``/``cross_v`` (B,
encoder_seq, Hkv, D): prefill computes the latter from the encoder output
and writes them; decode reads them and runs no encoder.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import attention as attn
from repro_torch.models import ffn
from repro_torch.models.common import (
    checkpoint_body,
    rms_norm,
    rms_norm_spec,
)
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model, _positions
from repro_torch.models.params import Spec, add_parameters, stack_spec_tree


def _enc_layer_specs(cfg: ModelConfig) -> dict:
    return {
        "attn_norm": rms_norm_spec(cfg.d_model),
        "attn": attn.gqa_specs(cfg),
        "mlp_norm": rms_norm_spec(cfg.d_model),
        "mlp": ffn.mlp_specs(cfg.d_model, cfg.d_ff, act="gelu"),
    }


def _dec_layer_specs(cfg: ModelConfig) -> dict:
    return {
        "self_norm": rms_norm_spec(cfg.d_model),
        "self_attn": attn.gqa_specs(cfg),
        "cross_norm": rms_norm_spec(cfg.d_model),
        "cross_attn": attn.gqa_specs(cfg),
        "mlp_norm": rms_norm_spec(cfg.d_model),
        "mlp": ffn.mlp_specs(cfg.d_model, cfg.d_ff, act="gelu"),
    }


def param_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    return {
        "embed": Spec((cfg.vocab_size, d), ("vocab", "embed"), fan_in=1),
        "enc_pos": Spec((cfg.encoder_seq, d), (None, "embed"), fan_in=1),
        "dec_pos": Spec((cfg.max_seq, d), (None, "embed"), fan_in=1),
        "enc_layers": stack_spec_tree(_enc_layer_specs(cfg),
                                      cfg.encoder_layers),
        "dec_layers": stack_spec_tree(_dec_layer_specs(cfg), cfg.num_layers),
        "enc_norm": rms_norm_spec(d),
        "final_norm": rms_norm_spec(d),
        "lm_head": Spec((d, cfg.vocab_size), ("embed", "vocab"), fan_in=d),
    }


def cache_specs(cfg: ModelConfig, batch: int, seq: int) -> dict[str, Spec]:
    """One decoder layer's cache: self-attention k/v over ``seq``
    positions, cross-attention k/v over the encoder's ``encoder_seq``."""
    hkv, hd = cfg.num_kv_heads, cfg.head_dim
    axes = ("batch", "cache_seq", "kv_heads", "head_dim")
    return {
        "k": Spec((batch, seq, hkv, hd), axes, init="zeros"),
        "v": Spec((batch, seq, hkv, hd), axes, init="zeros"),
        "cross_k": Spec((batch, cfg.encoder_seq, hkv, hd), axes,
                        init="zeros"),
        "cross_v": Spec((batch, cfg.encoder_seq, hkv, hd), axes,
                        init="zeros"),
    }


class EncoderLayer(nn.Module):
    """Pre-norm bidirectional self-attention plus a gelu MLP."""

    def __init__(self, cfg: ModelConfig, *, dtype, device):
        super().__init__()
        self.cfg = cfg
        add_parameters(self, {"attn_norm": rms_norm_spec(cfg.d_model)},
                       dtype, device)
        self.attn = attn.GQAAttention(cfg, dtype=dtype, device=device)
        add_parameters(self, {"mlp_norm": rms_norm_spec(cfg.d_model)},
                       dtype, device)
        self.mlp = ffn.MLP(cfg.d_model, cfg.d_ff, act="gelu", dtype=dtype,
                           device=device)

    def forward(self, x, positions):
        eps = self.cfg.norm_eps
        x = x + self.attn(rms_norm(x, self.attn_norm, eps), mode="train",
                          cache=None, pos=0, positions=positions,
                          causal=False)
        return x + self.mlp(rms_norm(x, self.mlp_norm, eps))


class DecoderLayer(nn.Module):
    """Pre-norm causal self-attention with a cache, cross-attention over
    the encoder's output (its k/v cached), and a gelu MLP."""

    def __init__(self, cfg: ModelConfig, *, dtype, device):
        super().__init__()
        self.cfg = cfg
        add_parameters(self, {"self_norm": rms_norm_spec(cfg.d_model)},
                       dtype, device)
        self.self_attn = attn.GQAAttention(cfg, dtype=dtype, device=device)
        add_parameters(self, {"cross_norm": rms_norm_spec(cfg.d_model)},
                       dtype, device)
        self.cross_attn = attn.GQAAttention(cfg, dtype=dtype, device=device)
        add_parameters(self, {"mlp_norm": rms_norm_spec(cfg.d_model)},
                       dtype, device)
        self.mlp = ffn.MLP(cfg.d_model, cfg.d_ff, act="gelu", dtype=dtype,
                           device=device)

    def forward(self, x, *, mode, cache, pos, positions, enc_out):
        """x (B, S, d) -> x.  ``cache`` is this layer's {"k", "v",
        "cross_k", "cross_v"}; ``enc_out`` the encoder's output (train and
        prefill; None in decode, which reads the cached cross k/v)."""
        cfg = self.cfg
        b, s, d = x.shape
        h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        x = x + self.self_attn(rms_norm(x, self.self_norm, cfg.norm_eps),
                               mode=mode, cache=cache, pos=pos,
                               positions=positions, causal=True)
        xn = rms_norm(x, self.cross_norm, cfg.norm_eps)
        p = self.cross_attn
        if mode == "decode":
            ck, cv = cache["cross_k"], cache["cross_v"]
        else:
            se = enc_out.shape[1]
            ck = (enc_out @ p.wk.reshape(d, hkv * hd)).view(b, se, hkv, hd)
            cv = (enc_out @ p.wv.reshape(d, hkv * hd)).view(b, se, hkv, hd)
            if cache is not None:
                cache["cross_k"].copy_(ck)
                cache["cross_v"].copy_(cv)
        q = (xn @ p.wq.reshape(d, h * hd)).view(b, s, h, hd)
        out = attn.noncausal_attention(q, ck, cv, kv_len=cfg.encoder_seq,
                                       scale=1.0 / math.sqrt(hd))
        x = x + out.reshape(b, s, h * hd) @ p.wo.reshape(h * hd, d)
        return x + self.mlp(rms_norm(x, self.mlp_norm, cfg.norm_eps))


class Whisper(Model):
    """The encoder-decoder: ``embed``, ``enc_pos``, ``dec_pos``,
    ``enc_layers``, ``dec_layers``, ``enc_norm``, ``final_norm`` and
    ``lm_head``, the reference's names.  Its cache is stacked over the
    decoder layers (``cfg.num_layers``)."""

    def add_body(self, cfg: ModelConfig) -> None:
        d = cfg.d_model
        add_parameters(self, {
            "enc_pos": Spec((cfg.encoder_seq, d), (None, "embed"), fan_in=1),
            "dec_pos": Spec((cfg.max_seq, d), (None, "embed"), fan_in=1),
        }, self.dtype, self.device)
        kw = dict(dtype=self.dtype, device=self.device)
        self.enc_layers = nn.ModuleList(
            EncoderLayer(cfg, **kw) for _ in range(cfg.encoder_layers))
        self.dec_layers = nn.ModuleList(
            DecoderLayer(cfg, **kw) for _ in range(cfg.num_layers))
        add_parameters(self, {"enc_norm": rms_norm_spec(d)}, self.dtype,
                       self.device)

    @staticmethod
    def cache_specs(cfg: ModelConfig, batch: int, seq: int):
        return cache_specs(cfg, batch, seq)

    def encode(self, enc_frames: torch.Tensor, *,
               remat: bool = False) -> torch.Tensor:
        """The encoder: frames (B, encoder_seq, d) -> (B, encoder_seq, d);
        ``remat`` checkpoints every layer, as the train forward does."""
        cfg = self.cfg
        x = enc_frames.to(device=self.device, dtype=self.dtype)
        b, s, _ = x.shape
        if s != cfg.encoder_seq:
            raise ValueError(f"{cfg.name}: enc_frames has {s} rows, the "
                             f"encoder takes encoder_seq = {cfg.encoder_seq}")
        x = x + self.enc_pos[None, :s]
        positions = torch.zeros((b, s), dtype=torch.int64, device=self.device)
        for layer in self.enc_layers:
            x = (checkpoint_body(layer, cfg) if remat else layer)(
                x, positions)
        return rms_norm(x, self.enc_norm, cfg.norm_eps)

    @property
    def prefill_inputs(self) -> tuple[str, ...]:
        return ("tokens", "enc_frames")

    def body_layers(self) -> nn.ModuleList:
        return self.dec_layers

    def _prelude(self, x, pos, mode: str, enc_frames, remat: bool = False):
        """Train and prefill encode ``enc_frames`` (the train forward's
        encoder layers rematerialized with its decoder's); decode reads
        the cached cross k/v.  The decoder adds ``dec_pos`` at each row's
        positions and rotates nothing (its layers' positions are zeros)."""
        cfg = self.cfg
        if mode in ("train", "prefill"):
            if enc_frames is None:
                raise ValueError(f"{cfg.name}: {mode} takes enc_frames "
                                 "(B, encoder_seq, d)")
            enc_out = self.encode(enc_frames, remat=remat)
        elif enc_frames is not None:
            raise ValueError(f"{cfg.name}: decode reads the cached cross "
                             "k/v and takes no enc_frames")
        else:
            enc_out = None
        b, s = x.shape[:2]
        x = x + self.dec_pos[_positions(pos, b, s, self.device)]
        positions = torch.zeros((b, s), dtype=torch.int64, device=self.device)
        return x, positions, {"enc_out": enc_out}
