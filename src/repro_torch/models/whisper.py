"""Whisper-small encoder-decoder backbone (audio family): its shape table
only.

A bidirectional encoder over precomputed frame embeddings and a causal
decoder with cross-attention, learned positional embeddings and gelu
MLPs.  The forward is not ported yet (ROADMAP Queue 1, item 16).
"""

from __future__ import annotations

from repro_torch.models import attention as attn
from repro_torch.models import ffn
from repro_torch.models.common import rms_norm_spec
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import Spec, stack_spec_tree


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
