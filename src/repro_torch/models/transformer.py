"""Decoder-only transformer LM, the dense family (stablelm-1.6b).

Each layer is pre-norm GQA attention plus a SwiGLU MLP, held in the
model's ``nn.ModuleList``; the KV cache is written in place layer by layer.
The MoE and VLM variants of the JAX module are not ported yet (ROADMAP
Queue 1, item 16).
"""

from __future__ import annotations

from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models.common import rms_norm, rms_norm_spec
from repro_torch.models.config import ModelConfig
from repro_torch.models.ffn import MLP
from repro_torch.models.model import Model
from repro_torch.models.params import add_parameters


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
