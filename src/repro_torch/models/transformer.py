"""Decoder-only transformer LM, the dense family (stablelm-1.6b).

Each layer is pre-norm GQA attention plus a SwiGLU MLP, held in the
model's ``nn.ModuleList``; the KV cache is written in place layer by layer.
The MoE and VLM variants of the JAX module and MLA layers are not ported
yet (ROADMAP Queue 1, item 16); :func:`param_specs` is the reference's
shape table for every variant (MLA, MoE, dense prefix layers, embedding
inputs), for parameter counts.
"""

from __future__ import annotations

from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models.common import rms_norm, rms_norm_spec
from repro_torch.models.config import ModelConfig
from repro_torch.models import ffn
from repro_torch.models.ffn import MLP
from repro_torch.models.model import Model
from repro_torch.models.params import Spec, add_parameters, stack_spec_tree


def _layer_specs(cfg: ModelConfig, moe_layer: bool) -> dict:
    s: dict = {
        "attn_norm": rms_norm_spec(cfg.d_model),
        "attn": attn.attn_specs(cfg),
        "mlp_norm": rms_norm_spec(cfg.d_model),
    }
    if moe_layer:
        s["moe"] = ffn.moe_specs(cfg)
    else:
        s["mlp"] = ffn.mlp_specs(cfg.d_model, cfg.d_ff)
    return s


def param_specs(cfg: ModelConfig) -> dict:
    """The dense, MoE and VLM-backbone families' parameters: the token
    embedding unless the model takes embeddings, ``first_dense_layers``
    unstacked dense layers, the stacked rest (MoE when the config has
    experts), final norm and LM head."""
    n_stacked = cfg.num_layers - cfg.first_dense_layers
    specs: dict = {}
    if not cfg.embeds_input:
        specs["embed"] = Spec(
            (cfg.vocab_size, cfg.d_model), ("vocab", "embed"), fan_in=1)
    if cfg.first_dense_layers:
        specs["prefix"] = [_layer_specs(cfg, moe_layer=False)
                           for _ in range(cfg.first_dense_layers)]
    specs["layers"] = stack_spec_tree(
        _layer_specs(cfg, moe_layer=cfg.num_experts > 0), n_stacked)
    specs["final_norm"] = rms_norm_spec(cfg.d_model)
    specs["lm_head"] = Spec(
        (cfg.d_model, cfg.vocab_size), ("embed", "vocab"), fan_in=cfg.d_model)
    return specs


class DenseLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, *, dtype, device):
        super().__init__()
        self.cfg = cfg
        add_parameters(self, {"attn_norm": rms_norm_spec(cfg.d_model)},
                       dtype, device)
        self.attn = attn.GQAAttention(cfg, dtype=dtype, device=device)
        add_parameters(self, {"mlp_norm": rms_norm_spec(cfg.d_model)},
                       dtype, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, dtype=dtype, device=device)

    def forward(self, x, *, mode, cache, pos, positions):
        x = x + self.attn(rms_norm(x, self.attn_norm, self.cfg.norm_eps),
                          mode=mode, cache=cache, pos=pos,
                          positions=positions)
        return x + self.mlp(rms_norm(x, self.mlp_norm, self.cfg.norm_eps))


class Transformer(Model):
    layer_cls = DenseLayer

    @staticmethod
    def cache_specs(cfg: ModelConfig, batch: int, seq: int):
        return attn.cache_specs(cfg, batch, seq)
