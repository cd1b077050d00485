"""Shared layer primitives: RMSNorm and RoPE (standard and partial).

M-RoPE (qwen2-vl) is not ported yet (ROADMAP Queue 1, item 16).
"""

from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.params import Spec


def rms_norm_spec(d: int) -> Spec:
    return Spec((d,), ("embed",), init="ones", dtype=torch.float32)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5):
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


def rope_freqs(dim: int, theta: float, device=None) -> torch.Tensor:
    """(dim/2,) inverse frequencies."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Standard rotary embedding on the last dim (rotated halves).
    x (B, S, H, D_rot), positions (B, S) integer."""
    d = x.shape[-1]
    inv = rope_freqs(d, theta, x.device)                     # (d/2,)
    ang = positions[..., None].float() * inv                 # (B, S, d/2)
    cos, sin = ang.cos()[:, :, None, :], ang.sin()[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


def rope_for(cfg: ModelConfig, x: torch.Tensor,
             positions: torch.Tensor) -> torch.Tensor:
    """Rotary embedding of the configured kind; the caller slices the
    rotary part of a partial-rotary head."""
    if cfg.mrope_sections is not None:
        raise NotImplementedError(
            "M-RoPE is not ported yet (ROADMAP Queue 1, item 16)")
    return apply_rope(x, positions, cfg.rope_theta)
