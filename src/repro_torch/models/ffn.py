"""Feed-forward layers: the dense SwiGLU (or gelu) MLP.

The MoE layer is not ported yet (ROADMAP Queue 1, item 16); its shape table
(:func:`moe_specs`) is, for parameter counts.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.config import ModelConfig
from repro_torch.models.params import Spec, add_parameters


def mlp_specs(d_model: int, d_ff: int, act: str = "swiglu") -> dict[str, Spec]:
    if act == "gelu":  # whisper-style
        return {
            "w_in": Spec((d_model, d_ff), ("embed", "ff"), fan_in=d_model),
            "w_out": Spec((d_ff, d_model), ("ff", "embed"), fan_in=d_ff),
        }
    return {
        "w_gate": Spec((d_model, d_ff), ("embed", "ff"), fan_in=d_model),
        "w_up": Spec((d_model, d_ff), ("embed", "ff"), fan_in=d_model),
        "w_down": Spec((d_ff, d_model), ("ff", "embed"), fan_in=d_ff),
    }


def moe_specs(cfg: ModelConfig) -> dict:
    """A MoE layer's parameters: float32 router, stacked experts, and the
    shared experts' MLP when the config has them (the reference's table)."""
    d, e, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    s: dict = {
        "router": Spec((d, e), ("embed", "experts"), fan_in=d,
                       dtype=torch.float32),
        "w_gate": Spec((e, d, f), ("experts", "embed", "moe_ff"), fan_in=d),
        "w_up": Spec((e, d, f), ("experts", "embed", "moe_ff"), fan_in=d),
        "w_down": Spec((e, f, d), ("experts", "moe_ff", "embed"), fan_in=f),
    }
    if cfg.num_shared_experts:
        s["shared"] = mlp_specs(d, cfg.num_shared_experts * cfg.moe_d_ff)
    return s


class MLP(nn.Module):
    def __init__(self, d_model: int, d_ff: int, *, act: str = "swiglu",
                 dtype, device):
        super().__init__()
        add_parameters(self, mlp_specs(d_model, d_ff, act), dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if hasattr(self, "w_in"):
            # jax.nn.gelu defaults to the tanh approximation
            return F.gelu(x @ self.w_in, approximate="tanh") @ self.w_out
        return (F.silu(x @ self.w_gate) * (x @ self.w_up)) @ self.w_down


def moe(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    raise NotImplementedError(
        "the MoE layer is not ported yet (ROADMAP Queue 1, item 16)")
