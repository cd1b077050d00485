"""Jamba (arch jamba-v0.1-52b), hybrid Mamba + attention + MoE.

Layers come in period-8 blocks: slot i of a block holds attention at
``cfg.is_attn_layer(i)``, else Mamba, and a MoE feed-forward at
``cfg.is_moe_layer(i)``, else the dense SwiGLU MLP (arXiv:2403.19887):
at the published config attention at slot 4 (1:7), MoE on odd slots.  The
port keeps every layer in one ``nn.ModuleList`` in order, each pre-norm
(``norm``, then ``attn`` or ``mamba``; ``ffn_norm``, then ``moe`` or
``mlp``); the reference stacks the blocks and scans over them
(``blocks.l{i}.<name>[b]``, which ``convert.model_params_from_reference``
maps to layer ``8b + i``).

The cache holds one set of tensors per kind of layer: ``k``/``v`` (n_attn,
B, S, Hkv, D) over the attention layers and ``conv``/``h`` (n_mamba, B,
...) over the Mamba layers; each layer indexes its own kind
(:meth:`Jamba.layer_cache`).  (The reference stacks a per-block tree of
every slot's cache over the blocks.)
"""

from __future__ import annotations

import functools

from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models import ffn
from repro_torch.models.common import rms_norm, rms_norm_spec
from repro_torch.models.config import ModelConfig
from repro_torch.models.mamba import Mamba, mamba_specs, mamba_state_specs
from repro_torch.models.model import Model
from repro_torch.models.params import Spec, add_parameters, stack_spec_tree

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


def _check_blocks(cfg: ModelConfig) -> None:
    if cfg.num_layers % PERIOD:
        raise ValueError(
            f"{cfg.name}: {cfg.num_layers} layers is no whole number of "
            f"period-{PERIOD} blocks")


def param_specs(cfg: ModelConfig) -> dict:
    _check_blocks(cfg)
    return {
        "embed": Spec((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                      fan_in=1),
        "blocks": stack_spec_tree(_block_specs(cfg),
                                  cfg.num_layers // PERIOD),
        "final_norm": rms_norm_spec(cfg.d_model),
        "lm_head": Spec((cfg.d_model, cfg.vocab_size), ("embed", "vocab"),
                        fan_in=cfg.d_model),
    }


class JambaLayer(nn.Module):
    """One layer: pre-norm attention (``attn``) or Mamba (``mamba``), then
    pre-norm MoE (``moe``) or dense MLP (``mlp``)."""

    def __init__(self, cfg: ModelConfig, *, attention: bool, moe: bool,
                 dtype, device):
        super().__init__()
        self.cfg = cfg
        add_parameters(self, {"norm": rms_norm_spec(cfg.d_model)}, dtype,
                       device)
        if attention:
            attn_cls = (attn.MLAAttention if cfg.attention == "mla"
                        else attn.GQAAttention)
            self.attn = attn_cls(cfg, dtype=dtype, device=device)
        else:
            self.mamba = Mamba(cfg, dtype=dtype, device=device)
        add_parameters(self, {"ffn_norm": rms_norm_spec(cfg.d_model)}, dtype,
                       device)
        if moe:
            self.moe = ffn.MoE(cfg, dtype=dtype, device=device)
        else:
            self.mlp = ffn.MLP(cfg.d_model, cfg.d_ff, dtype=dtype,
                               device=device)

    def forward(self, x, *, mode, cache, pos, positions):
        eps = self.cfg.norm_eps
        xn = rms_norm(x, self.norm, eps)
        if hasattr(self, "attn"):
            h = self.attn(xn, mode=mode, cache=cache, pos=pos,
                          positions=positions)
        else:
            h = self.mamba(xn, mode=mode, state=cache)
        x = x + h
        xn = rms_norm(x, self.ffn_norm, eps)
        return x + (self.moe(xn) if hasattr(self, "moe") else self.mlp(xn))


class Jamba(Model):
    @staticmethod
    def layer_cls(cfg: ModelConfig, i: int):
        return functools.partial(JambaLayer,
                                 attention=cfg.is_attn_layer(i % PERIOD),
                                 moe=cfg.is_moe_layer(i % PERIOD))

    def add_body(self, cfg: ModelConfig) -> None:
        _check_blocks(cfg)
        super().add_body(cfg)
        attn_names = tuple(attn.cache_specs(cfg, 1, 1))
        mamba_names = tuple(mamba_state_specs(cfg, 1))
        # layer i -> its kind's cache names and its place among its kind
        self._slots, counts = [], {attn_names: 0, mamba_names: 0}
        for i in range(cfg.num_layers):
            names = (attn_names if cfg.is_attn_layer(i % PERIOD)
                     else mamba_names)
            self._slots.append((names, counts[names]))
            counts[names] += 1
        self._counts = (counts[attn_names], counts[mamba_names])

    def cache_groups(self, batch: int, seq: int):
        n_attn, n_mamba = self._counts
        return [(n_attn, attn.cache_specs(self.cfg, batch, seq)),
                (n_mamba, mamba_state_specs(self.cfg, batch))]

    def layer_cache(self, cache: dict, i: int) -> dict:
        names, j = self._slots[i]
        return {name: cache[name][j] for name in names}
