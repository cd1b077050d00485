"""Jamba (arch jamba-v0.1-52b), hybrid Mamba + attention + MoE: its shape
table only.

32 layers are 4 stacked super-blocks of the period-8 pattern: slot i holds
attention at ``cfg.is_attn_layer(i)``, else Mamba, and a MoE feed-forward
at ``cfg.is_moe_layer(i)``, else the dense MLP (arXiv:2403.19887).  The
forward is not ported yet (ROADMAP Queue 1, item 16).
"""

from __future__ import annotations

from repro_torch.models import attention as attn
from repro_torch.models import ffn
from repro_torch.models.common import rms_norm_spec
from repro_torch.models.config import ModelConfig
from repro_torch.models.mamba import mamba_specs
from repro_torch.models.params import Spec, stack_spec_tree

PERIOD = 8


def _block_specs(cfg: ModelConfig) -> dict:
    s: dict = {}
    for i in range(PERIOD):
        layer: dict = {"norm": rms_norm_spec(cfg.d_model)}
        if cfg.is_attn_layer(i):
            layer["attn"] = attn.attn_specs(cfg)
        else:
            layer["mamba"] = mamba_specs(cfg)
        layer["ffn_norm"] = rms_norm_spec(cfg.d_model)
        if cfg.is_moe_layer(i):
            layer["moe"] = ffn.moe_specs(cfg)
        else:
            layer["mlp"] = ffn.mlp_specs(cfg.d_model, cfg.d_ff)
        s[f"l{i}"] = layer
    return s


def param_specs(cfg: ModelConfig) -> dict:
    if cfg.num_layers % PERIOD:
        raise ValueError(
            f"{cfg.name}: {cfg.num_layers} layers is no whole number of "
            f"period-{PERIOD} blocks")
    return {
        "embed": Spec((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                      fan_in=1),
        "blocks": stack_spec_tree(_block_specs(cfg),
                                  cfg.num_layers // PERIOD),
        "final_norm": rms_norm_spec(cfg.d_model),
        "lm_head": Spec((cfg.d_model, cfg.vocab_size), ("embed", "vocab"),
                        fan_in=cfg.d_model),
    }
