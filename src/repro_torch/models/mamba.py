"""Mamba (selective SSM) block, Jamba's attention-free layer.

The reference's layer (``repro.models.mamba.mamba_layer``): the input
projection into x and the gate z, a depthwise causal convolution of
``ssm_d_conv`` taps with SiLU (plain torch, as the reference computes it
in jnp), the projections of Δ (softplus, float32), B and C, A = -exp(a_log),
the selective scan, the ``d_skip`` term and the SiLU(z) gate.

Prefill and train mode start from h = 0 and run the scan through
``kernels.mamba_scan.ops`` (on the card the CUDA kernels, on the CPU the
plain step loops): prefill through ``mamba_scan``, train mode through
``mamba_scan_trainable``, whose backward is the scan's backward kernel; a
one-token decode keeps the reference's own one-step formula in torch, as
the reference branches there too, so the forward kernel launches once per
Mamba layer and prefill (twice per layer and train step under remat, the
backward once).  The kernels pick their own chunks: the port has no copy
of the reference's ``scan_utils`` (``pick_chunk``,
``unrolled_chunk_scan``).

The layer's state is the conv tail (B, d_conv - 1, d_inner) in the model's
dtype and h (B, d_inner, d_state) in float32, written in place.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.mamba_scan.ops import (
    mamba_scan,
    mamba_scan_trainable,
)
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import Spec, add_parameters


def mamba_specs(cfg: ModelConfig) -> dict[str, Spec]:
    d, di = cfg.d_model, cfg.ssm_d_inner
    n, dc, dtr = cfg.ssm_d_state, cfg.ssm_d_conv, cfg.ssm_dt_rank
    f32 = torch.float32
    return {
        "in_proj": Spec((d, 2 * di), ("embed", "ff"), fan_in=d),
        "conv_w": Spec((dc, di), (None, "ff")),
        "conv_b": Spec((di,), ("ff",), init="zeros"),
        "x_proj": Spec((di, dtr + 2 * n), ("ff", None), fan_in=di),
        "dt_w": Spec((dtr, di), (None, "ff"), fan_in=dtr),
        "dt_b": Spec((di,), ("ff",), init="zeros", dtype=f32),
        "a_log": Spec((di, n), ("ff", "state"), init="zeros", dtype=f32),
        "d_skip": Spec((di,), ("ff",), init="ones", dtype=f32),
        "out_proj": Spec((di, d), ("ff", "embed"), fan_in=di),
    }


def mamba_state_specs(cfg: ModelConfig, batch: int) -> dict[str, Spec]:
    """One Mamba layer's state: the conv tail and the float32 SSM state."""
    di, n, dc = cfg.ssm_d_inner, cfg.ssm_d_state, cfg.ssm_d_conv
    return {
        "conv": Spec((batch, dc - 1, di), ("batch", None, "ff"), init="zeros"),
        "h": Spec((batch, di, n), ("batch", "ff", "state"), init="zeros",
                  dtype=torch.float32),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 tail: torch.Tensor | None) -> torch.Tensor:
    """Depthwise causal conv along the sequence: x (B, S, di), w (dc, di),
    the taps summed in the reference's order; ``tail`` (B, dc - 1, di) is
    the decode's carried input, else zeros."""
    dc, s = w.shape[0], x.shape[1]
    pad = (x.new_zeros((x.shape[0], dc - 1, x.shape[2])) if tail is None
           else tail.to(x.dtype))
    xp = torch.cat([pad, x], 1)                      # (B, S + dc - 1, di)
    out = xp[:, 0:s] * w[0]
    for j in range(1, dc):
        out = out + xp[:, j:j + s] * w[j]
    return out + b


class Mamba(nn.Module):
    """Parameters of :func:`mamba_specs`, the reference's layouts."""

    def __init__(self, cfg: ModelConfig, *, dtype, device):
        super().__init__()
        self.cfg = cfg
        add_parameters(self, mamba_specs(cfg), dtype, device)

    def forward(self, x: torch.Tensor, *, mode: str,
                state: dict | None) -> torch.Tensor:
        """x (B, S, d) -> (B, S, d).  ``state`` is this layer's {"conv",
        "h"}: read in decode, written in place whenever given."""
        cfg = self.cfg
        b, s, _ = x.shape
        di, n, dtr, dc = (cfg.ssm_d_inner, cfg.ssm_d_state, cfg.ssm_dt_rank,
                          cfg.ssm_d_conv)
        f32 = torch.float32
        x_in, z = (x @ self.in_proj).split(di, dim=-1)   # (B, S, di) each
        carry = mode == "decode"
        tail = state["conv"] if carry else None
        x_conv = F.silu(_causal_conv(x_in, self.conv_w, self.conv_b, tail))
        pad = (tail.to(x_in.dtype) if carry
               else x_in.new_zeros((b, dc - 1, di)))
        new_conv = torch.cat([pad, x_in], 1)[:, -(dc - 1):]

        proj = x_conv @ self.x_proj                      # (B, S, dtr + 2n)
        b_ssm = proj[..., dtr:dtr + n].to(f32)
        c_ssm = proj[..., dtr + n:].to(f32)
        delta = F.softplus(proj[..., :dtr].to(f32) @ self.dt_w.to(f32)
                           + self.dt_b)                  # (B, S, di)
        a = -torch.exp(self.a_log)                       # (di, n)
        xf = x_conv.to(f32)
        h0 = (state["h"].to(f32) if (state is not None and carry)
              else torch.zeros((b, di, n), dtype=f32, device=x.device))

        if carry and s == 1:  # the reference's one-step decode
            da = torch.exp(delta[:, 0, :, None] * a[None])        # (B, di, n)
            bx = (delta[:, 0, :, None] * b_ssm[:, 0, None, :]
                  * xf[:, 0, :, None])
            h_final = da * h0 + bx
            y = torch.einsum("bn,bdn->bd", c_ssm[:, 0], h_final)[:, None, :]
        else:
            scan = mamba_scan_trainable if mode == "train" else mamba_scan
            y, h_final = scan(delta, xf, a, b_ssm, c_ssm, h0)

        y = y + self.d_skip * xf
        y = (y * F.silu(z.to(f32))).to(x.dtype)
        if state is not None:
            state["conv"].copy_(new_conv)
            state["h"].copy_(h_final)
        return y @ self.out_proj
