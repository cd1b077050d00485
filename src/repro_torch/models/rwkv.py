"""RWKV-6 "Finch" (data-dependent decay linear attention) — arch rwkv6-3b.

Attention-free: a per-head (hs x hs) state instead of a KV cache.  Prefill
and train run the time mix's recurrence through the linrec ops
(``repro_torch.kernels.linrec.ops``): on the card the CUDA kernel reads the
(B, T, H, hs) projections in place; on the CPU the chunked plain version.
Train mode takes the trainable op (``rwkv6_trainable``), whose backward
recomputes the chunked algebra under autograd.
A single-token decode step is the inline outer-product update, as in the
JAX package: it needs no kernel.  The layer's state (token shifts and the
float32 recurrence state) is written in place.

Deviation from upstream RWKV, kept from the JAX package: LayerNorm is
replaced by RMSNorm.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.linrec.ops import (
    rwkv6_linear_attention_logw,
    rwkv6_trainable,
)
from repro_torch.models.common import rms_norm, rms_norm_spec
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model
from repro_torch.models.params import Spec, add_parameters, stack_spec_tree

# Mix components order: r, k, v, w (decay), g (gate)
_N_MIX = 5


def rwkv_layer_specs(cfg: ModelConfig) -> dict[str, Spec]:
    d, dff = cfg.d_model, cfg.d_ff
    h, hs = cfg.rwkv_heads, cfg.rwkv_head_size
    m, ld = cfg.rwkv_lora_mix, cfg.rwkv_lora_decay
    f32 = torch.float32
    return {
        "ln1": rms_norm_spec(d),
        "ln2": rms_norm_spec(d),
        # time-mix (ddlerp) parameters
        "mu_base": Spec((d,), ("embed",), init="zeros"),
        "mu": Spec((_N_MIX, d), (None, "embed"), init="zeros"),
        "mix_a": Spec((d, _N_MIX * m), ("embed", None), fan_in=d),
        "mix_b": Spec((_N_MIX, m, d), (None, None, "embed"), fan_in=m),
        # data-dependent decay
        "w0": Spec((d,), ("embed",), init="zeros", dtype=f32),
        "wa": Spec((d, ld), ("embed", None), fan_in=d),
        "wb": Spec((ld, d), (None, "embed"), fan_in=ld),
        # projections
        "wr": Spec((d, d), ("embed", "ff"), fan_in=d),
        "wk": Spec((d, d), ("embed", "ff"), fan_in=d),
        "wv": Spec((d, d), ("embed", "ff"), fan_in=d),
        "wg": Spec((d, d), ("embed", "ff"), fan_in=d),
        "u": Spec((h, hs), (None, None), init="zeros", dtype=f32),
        "ln_x": Spec((d,), ("embed",), init="ones", dtype=f32),
        "wo": Spec((d, d), ("ff", "embed"), fan_in=d),
        # channel-mix
        "cmix_k": Spec((d,), ("embed",), init="zeros"),
        "cmix_r": Spec((d,), ("embed",), init="zeros"),
        "cwk": Spec((d, dff), ("embed", "ff"), fan_in=d),
        "cwv": Spec((dff, d), ("ff", "embed"), fan_in=dff),
        "cwr": Spec((d, d), ("embed", "ff"), fan_in=d),
    }


def param_specs(cfg: ModelConfig) -> dict:
    """The whole model's parameters, layers stacked (the reference's
    table)."""
    return {
        "embed": Spec((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                      fan_in=1),
        "layers": stack_spec_tree(rwkv_layer_specs(cfg), cfg.num_layers),
        "final_norm": rms_norm_spec(cfg.d_model),
        "lm_head": Spec((cfg.d_model, cfg.vocab_size), ("embed", "vocab"),
                        fan_in=cfg.d_model),
    }


def rwkv_state_specs(cfg: ModelConfig, batch: int) -> dict[str, Spec]:
    d, h, hs = cfg.d_model, cfg.rwkv_heads, cfg.rwkv_head_size
    return {
        "att_shift": Spec((batch, d), ("batch", "embed"), init="zeros"),
        "ffn_shift": Spec((batch, d), ("batch", "embed"), init="zeros"),
        "s": Spec((batch, h, hs, hs), ("batch", None, None, None),
                  init="zeros", dtype=torch.float32),
    }


def _token_shift(x: torch.Tensor, prev: torch.Tensor | None) -> torch.Tensor:
    """xs_t = x_{t-1}; the first position takes ``prev`` (decode carry) or
    0."""
    first = (torch.zeros_like(x[:, :1]) if prev is None
             else prev[:, None].to(x.dtype))
    return torch.cat([first, x[:, :-1]], dim=1)


class RWKVLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, *, dtype, device):
        super().__init__()
        self.cfg = cfg
        add_parameters(self, rwkv_layer_specs(cfg), dtype, device)

    def forward(self, x, *, mode, cache, pos=None, positions=None):
        """x (B, T, d) -> x.  ``cache`` is this layer's state {"att_shift",
        "ffn_shift", "s"}: read in decode, written in place whenever
        given.  ``pos`` and ``positions`` are not used: RWKV has no
        positions."""
        p, cfg, state = self, self.cfg, cache
        b, t, d = x.shape
        h, hs = cfg.rwkv_heads, cfg.rwkv_head_size
        dtype = x.dtype
        f32 = torch.float32
        carry = state is not None and mode == "decode"

        # ---- time mix ----
        xn = rms_norm(x, p.ln1, cfg.norm_eps)
        xs = _token_shift(xn, state["att_shift"] if carry else None)
        dx = xs - xn
        base = xn + dx * p.mu_base.to(dtype)
        z = torch.tanh(base @ p.mix_a).view(b, t, _N_MIX, cfg.rwkv_lora_mix)
        offs = torch.einsum("btfm,fmd->btfd", z, p.mix_b)         # (B,T,5,d)
        x_r, x_k, x_v, x_w, x_g = (
            xn + dx * (p.mu[i].to(dtype) + offs[:, :, i]) for i in range(_N_MIX))

        w_raw = p.w0 + torch.tanh(x_w.to(f32) @ p.wa.to(f32)) @ p.wb.to(f32)
        logw = -torch.exp(w_raw.clamp(-20.0, 10.0)).view(b, t, h, hs)  # <= 0
        r = (x_r @ p.wr).view(b, t, h, hs).to(f32)
        k = (x_k @ p.wk).view(b, t, h, hs).to(f32)
        v = (x_v @ p.wv).view(b, t, h, hs).to(f32)
        g = x_g @ p.wg
        u = p.u.to(f32)
        s0 = state["s"] if carry else torch.zeros(b, h, hs, hs, device=x.device)

        if mode == "decode" and t == 1:
            kv = k[:, 0, :, :, None] * v[:, 0, :, None, :]
            att = s0 + u[None, :, :, None] * kv
            y = torch.einsum("bhi,bhij->bhj", r[:, 0], att)[:, None]
            s_new = torch.exp(logw[:, 0])[..., None] * s0 + kv
        elif mode == "train":
            y, s_new = rwkv6_trainable(r, k, v, logw, u, layout="bthd")
        else:
            y, s_new = rwkv6_linear_attention_logw(r, k, v, logw, u, s0,
                                                   layout="bthd")

        # per-head group norm
        y = y * torch.rsqrt((y * y).mean(-1, keepdim=True) + cfg.norm_eps)
        y = (y.reshape(b, t, d) * p.ln_x).to(dtype)
        x = x + (y * F.silu(g)) @ p.wo

        # ---- channel mix ----
        xn2 = rms_norm(x, p.ln2, cfg.norm_eps)
        xs2 = _token_shift(xn2, state["ffn_shift"] if carry else None)
        dx2 = xs2 - xn2
        xk = xn2 + dx2 * p.cmix_k.to(dtype)
        xr = xn2 + dx2 * p.cmix_r.to(dtype)
        kk = torch.square(torch.relu(xk @ p.cwk))
        x = x + torch.sigmoid(xr @ p.cwr) * (kk @ p.cwv)

        if state is not None:
            state["att_shift"].copy_(xn[:, -1])
            state["ffn_shift"].copy_(xn2[:, -1])
            state["s"].copy_(s_new)
        return x


class RWKV(Model):
    @staticmethod
    def layer_cls(cfg: ModelConfig, i: int) -> type:
        return RWKVLayer

    @staticmethod
    def cache_specs(cfg: ModelConfig, batch: int, seq: int):
        del seq  # attention-free: O(1) state regardless of context length
        return rwkv_state_specs(cfg, batch)
