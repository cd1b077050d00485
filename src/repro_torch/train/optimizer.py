"""AdamW with float32 master weights, over a model's named parameters.

The port of ``repro.train.optimizer``.  The optimizer state is a dict:
``master``, ``m`` and ``v`` map each parameter's name to a float32 tensor
on the parameter's device, and ``step`` is a 0-dim int32 tensor on the
host (the schedule and the bias corrections are host scalars, so reading
it costs no device sync).  Every leaf is decayed, the float32 norm scales
too; gradients are clipped by their global norm in float32; the warmup is
``lr * min(1, (step + 1) / warmup)``; the new parameters are cast from the
master.  :func:`adamw_update` updates the state and writes the new
parameters in place, so a step allocates no second copy of either (the
full stablelm-1.6b keeps 16 bytes per parameter: bf16 weights, float32
master, m and v).

The host scalars (learning rate, bias corrections) are computed in
float32, as the reference computes them on its device, so both packages
apply the same factors.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100


@torch.no_grad()
def init_opt_state(params: Mapping[str, torch.Tensor]) -> dict:
    """Float32 master copies (never aliasing a float32 parameter), zero
    moments on each parameter's device, and step 0."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return {
        "master": {n: p.detach().to(torch.float32, copy=True)
                   for n, p in params.items()},
        "m": {n: zeros(p) for n, p in params.items()},
        "v": {n: zeros(p) for n, p in params.items()},
        "step": torch.zeros((), dtype=torch.int32),
    }


def _schedule(cfg: AdamWConfig, step: int) -> float:
    """The learning rate of step ``step`` (0-based), in float32."""
    f32 = np.float32
    warm = min(f32(1.0), f32(step + 1) / f32(max(cfg.warmup_steps, 1)))
    return float(f32(cfg.lr) * warm)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in float32: a 0-dim
    tensor on the tensors' device."""
    norms = [torch.linalg.vector_norm(g, dtype=torch.float32)
             for g in tensors]
    return torch.stack(norms).square().sum().sqrt()


@torch.no_grad()
def adamw_update(
    grads: Mapping[str, torch.Tensor],
    opt_state: dict,
    cfg: AdamWConfig,
    params: Mapping[str, torch.Tensor],
) -> tuple[Mapping[str, torch.Tensor], dict]:
    """One AdamW step from ``grads`` (name -> gradient, the parameters'
    dtype).  Updates ``opt_state`` and writes each new parameter, cast
    from its master, into ``params`` in place; returns both."""
    if set(grads) != set(opt_state["master"]) or set(grads) != set(params):
        raise ValueError("grads, params and the optimizer state must name "
                         "the same parameters")
    step = int(opt_state["step"])
    lr = _schedule(cfg, step)
    f32 = np.float32
    t = f32(step + 1)
    bc1 = float(f32(1.0) - f32(cfg.b1) ** t)
    bc2 = float(f32(1.0) - f32(cfg.b2) ** t)
    gnorm = global_norm(grads.values())
    clip = torch.full_like(gnorm, cfg.grad_clip)
    scale = torch.clamp(clip / gnorm.clamp(min=1e-9), max=1.0)

    for name, g in grads.items():
        m, v = opt_state["m"][name], opt_state["v"][name]
        w = opt_state["master"][name]
        g = g.to(torch.float32, copy=True).mul_(scale)
        m.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
        v.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
        upd = torch.div(m, bc1).div_(torch.div(v, bc2).sqrt_().add_(cfg.eps))
        w.sub_(upd.add_(w, alpha=cfg.weight_decay), alpha=lr)
        params[name].copy_(w)
    opt_state["step"] = torch.tensor(step + 1, dtype=torch.int32)
    return params, opt_state
