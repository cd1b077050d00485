"""Decoder-only transformer LM: the dense family (stablelm-1.6b,
minicpm3-4b with MLA), the MoE family (granite-moe-1b-a400m,
deepseek-v2-lite-16b with MLA) and the vlm backbone (qwen2-vl-7b).

Each layer is pre-norm attention (GQA or MLA, as the config says) plus a
SwiGLU MLP (:class:`DenseLayer`) or a MoE (:class:`MoELayer`): the first
``first_dense_layers`` layers are dense, the rest MoE when the config has
experts.  All of them sit in the model's one ``nn.ModuleList``, in order,
and the cache is one set of tensors stacked over every layer, written in
place layer by layer.  (The JAX module keeps the dense prefix apart, as
``params["prefix"]`` and ``cache["prefix"]``, from its scanned stack;
``convert.model_params_from_reference`` maps both onto the one list.)
The vlm variant (``embeds_input``) has no token embedding: its first
layer takes the given embeddings (the reference stubs the vision
frontend), and its attention rotates by M-RoPE (``common.rope_for``),
whose three position streams are the one (B, S) stream of the model, as
in the reference.  :func:`param_specs` is the reference's shape table for
every variant.
"""

from __future__ import annotations

from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models.common import rms_norm, rms_norm_spec
from repro_torch.models.config import ModelConfig
from repro_torch.models import ffn
from repro_torch.models.ffn import MLP, MoE
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
    """Pre-norm attention (GQA or MLA) plus a SwiGLU MLP of width d_ff."""

    def __init__(self, cfg: ModelConfig, *, dtype, device):
        super().__init__()
        self.cfg = cfg
        add_parameters(self, {"attn_norm": rms_norm_spec(cfg.d_model)},
                       dtype, device)
        attn_cls = (attn.MLAAttention if cfg.attention == "mla"
                    else attn.GQAAttention)
        self.attn = attn_cls(cfg, dtype=dtype, device=device)
        add_parameters(self, {"mlp_norm": rms_norm_spec(cfg.d_model)},
                       dtype, device)
        self.add_ffn(cfg, dtype, device)

    def add_ffn(self, cfg: ModelConfig, dtype, device) -> None:
        self.mlp = MLP(cfg.d_model, cfg.d_ff, dtype=dtype, device=device)

    def ffn(self, x):
        return self.mlp(x)

    def forward(self, x, *, mode, cache, pos, positions):
        x = x + self.attn(rms_norm(x, self.attn_norm, self.cfg.norm_eps),
                          mode=mode, cache=cache, pos=pos,
                          positions=positions)
        return x + self.ffn(rms_norm(x, self.mlp_norm, self.cfg.norm_eps))


class MoELayer(DenseLayer):
    """Pre-norm attention (GQA or MLA) plus a MoE."""

    def add_ffn(self, cfg: ModelConfig, dtype, device) -> None:
        self.moe = MoE(cfg, dtype=dtype, device=device)

    def ffn(self, x):
        return self.moe(x)


class Transformer(Model):
    @staticmethod
    def layer_cls(cfg: ModelConfig, i: int) -> type:
        moe = cfg.num_experts > 0 and i >= cfg.first_dense_layers
        return MoELayer if moe else DenseLayer

    @staticmethod
    def cache_specs(cfg: ModelConfig, batch: int, seq: int):
        return attn.cache_specs(cfg, batch, seq)
