"""Feed-forward layers: the dense SwiGLU (or gelu) MLP.

The MoE layer is not ported yet (ROADMAP Queue 1, item 16).
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
