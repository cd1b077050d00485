"""Feed-forward layers: the dense SwiGLU (or gelu) MLP and the sort-based
capacity-buffer MoE.

The MoE dispatch is the reference's, step for step: float32 routing, the
top-k experts of each token, a stable argsort of the (token, k)
assignments by expert, each one's rank within its expert, and a scatter
into an (E, capacity, d) buffer, where assignments past an expert's
capacity are dropped.  The expert products are batched matmuls over the
expert axis (``torch.bmm``, under the profiler range ``"moe_experts"``),
as the reference leaves its einsums to XLA; no Pallas kernel computes
them.  Under autograd the combine's gather scatters its gradient without
accumulating (:class:`_SlotGather`, profiler range
``"moe_combine_backward"``).  :func:`moe_aux_loss` is ported, held to the
reference by a parity test, and added by neither package's train step.
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


class _SlotGather(torch.autograd.Function):
    """The expert outputs ``out (rows, d)`` at each sorted assignment's
    ``slot``, zeros where it was dropped (``valid`` False).  The backward
    writes each kept assignment's gradient to its slot (kept slots are
    distinct) with no accumulation, the dropped ones to a padding row that
    is cut off.  The gather's own backward accumulates every dropped
    assignment's zero into the one row their clamped slot names, and the
    card adds a row's duplicates one after another."""

    @staticmethod
    def forward(ctx, out, slot, valid):
        ctx.save_for_backward(slot)
        ctx.rows = rows = out.shape[0]
        return torch.where(valid[:, None], out[slot.clamp(max=rows - 1)],
                           0.0)

    @staticmethod
    def backward(ctx, g):
        (slot,) = ctx.saved_tensors
        with torch.profiler.record_function("moe_combine_backward"):
            grad = g.new_zeros((ctx.rows + 1, g.shape[-1]))
            grad[slot] = g            # a dropped slot is ``rows``: the pad
        return grad[:ctx.rows], None, None


def _capacity(num_tokens: int, cfg: ModelConfig) -> int:
    """Slots per expert for ``num_tokens`` tokens: the reference's Python
    float expression, left to right, and at least 8."""
    cap = int(
        cfg.top_k * num_tokens / cfg.num_experts * cfg.moe_capacity_factor
    )
    return max(cap, 8)


class MoE(nn.Module):
    """Top-k routed experts with capacity dropping, plus the shared
    experts' MLP when the config has them.  Parameters: the float32
    ``router (d, E)``, ``w_gate``/``w_up (E, d, f)``, ``w_down (E, f, d)``
    and ``shared`` (an :class:`MLP`), the reference's layouts."""

    def __init__(self, cfg: ModelConfig, *, dtype, device):
        super().__init__()
        self.cfg = cfg
        specs = moe_specs(cfg)
        specs.pop("shared", None)
        add_parameters(self, specs, dtype, device)
        if cfg.num_shared_experts:
            self.shared = MLP(cfg.d_model,
                              cfg.num_shared_experts * cfg.moe_d_ff,
                              dtype=dtype, device=device)

    def dispatch(self, xf: torch.Tensor):
        """Route the tokens ``xf (n, d)``: returns the renormalized top-k
        weights ``(n, k)`` float32, ``order`` (the stable sort of the
        flat assignments ``token * k + j`` by expert), each sorted
        assignment's buffer row ``slot`` (``E * cap`` where it is dropped)
        and ``valid`` (kept), and the capacity ``cap``."""
        cfg = self.cfg
        n, k, e = xf.shape[0], cfg.top_k, cfg.num_experts
        cap = _capacity(n, cfg)
        probs = torch.softmax(xf.float() @ self.router, -1)        # (n, e)
        top_w, top_i = torch.topk(probs, k, dim=-1)                 # (n, k)
        top_w = top_w / top_w.sum(-1, keepdim=True)                 # renorm
        flat_e = top_i.reshape(-1)                                  # (n*k,)
        order = torch.argsort(flat_e, stable=True)
        sorted_e = flat_e[order]
        seg_start = torch.searchsorted(
            sorted_e, torch.arange(e, device=xf.device))            # (e,)
        rank = torch.arange(n * k, device=xf.device) - seg_start[sorted_e]
        valid = rank < cap                                          # drops
        slot = torch.where(valid, sorted_e * cap + rank, e * cap)
        return top_w, order, slot, valid, cap

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, S, d) -> (B, S, d)."""
        cfg = self.cfg
        b, s, d = x.shape
        n, k, e = b * s, cfg.top_k, cfg.num_experts
        xf = x.reshape(n, d)
        top_w, order, slot, valid, cap = self.dispatch(xf)
        # scatter into the (e*cap + 1, d) buffer; the extra row takes the
        # dropped assignments and is cut off
        buf = xf.new_zeros((e * cap + 1, d))
        buf[slot] = xf[order // k]
        buf = buf[: e * cap].view(e, cap, d)
        with torch.profiler.record_function("moe_experts"):
            gate = F.silu(torch.bmm(buf, self.w_gate))
            up = torch.bmm(buf, self.w_up)
            out = torch.bmm(gate * up, self.w_down).view(e * cap, d)
        # gather back (dropped assignments give 0), unsort, weight, sum
        y_sorted = _SlotGather.apply(out, slot, valid)
        y = torch.empty_like(y_sorted)
        y[order] = y_sorted
        y = (y.view(n, k, d) * top_w[..., None].to(y.dtype)).sum(1)
        if cfg.num_shared_experts:
            y = y + self.shared(xf)
        return y.view(b, s, d)


def moe_aux_loss(p: MoE, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Switch-style load-balancing auxiliary loss of the MoE layer ``p`` on
    ``x (B, S, d)``: E times the sum over experts of the mean router
    probability and the share of tokens whose top expert it is."""
    xf = x.reshape(-1, x.shape[-1])
    probs = torch.softmax(xf.float() @ p.router, -1)
    top_i = probs.argmax(-1)
    me = probs.mean(0)
    ce = torch.bincount(top_i, minlength=cfg.num_experts).float() / xf.shape[0]
    return cfg.num_experts * (me * ce).sum()
