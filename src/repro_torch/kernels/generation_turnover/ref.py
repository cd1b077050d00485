"""Plain PyTorch version of the turnover pass: the spec the CUDA kernel is
held to, and the CPU path.

For base demand ``b`` (P, T), edges g = (src, dst, inv_gain, mid, rate)
and the hourly software drift ``sw_log``:

    m_g(t)   = sigmoid(rate_g * (t - mid_g))       explicit exp form
    eff(t)   = exp(-sw_log * t)
    col[p,t] = b[p,t] - b[p,t] * m_g(t)                    p = src_g
             = b[p,t] + (b[src_g,t] * m_g(t)) * inv_gain_g p = dst_g
             = b[p,t]                                      otherwise
    out      = col * eff

The reference's scan (``repro/capacity/generations.py::migrate_demand``)
carries m into hour t as ``sigmoid(rate * ((t - 1) + 1 - mid))``; in
float32 ``(t - 1) + 1`` is t exactly for every t below 2^24, so each hour
is this closed form and no hour depends on another.  Every product, sum
and quotient here is one float32 operation rounded once, and the sigmoid
is the reference's explicit composition (``_sigmoid``), so the kernel,
which rounds the same steps explicitly, equals this version bit for bit
on the card.
"""

from __future__ import annotations

import torch


def sigmoid_ref(x: torch.Tensor) -> torch.Tensor:
    """The logistic from exp, add and divide, as the reference builds it:
    1 / (1 + e) for x >= 0, e / (1 + e) below, with e = exp(-|x|)."""
    e = torch.exp(-torch.abs(x))
    pos = 1.0 / (1.0 + e)
    neg = e / (1.0 + e)
    return torch.where(x >= 0, pos, neg)


def turnover_ref(
    base: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    inv_gain: torch.Tensor,
    midpoint_hours: torch.Tensor,
    rate_per_hour: torch.Tensor,
    sw_log: float,
) -> torch.Tensor:
    """base (P, T) float32; src, dst (G,) int64 pool indices; inv_gain,
    midpoint_hours, rate_per_hour (G,) float32; ``sw_log`` the hourly log
    drift as a Python float (used as float32) -> (P, T) float32, on
    ``base``'s device, vectorized over (pool, hour)."""
    t = torch.arange(base.shape[-1], dtype=torch.float32, device=base.device)
    m = sigmoid_ref(rate_per_hour[:, None]
                    * (t[None, :] - midpoint_hours[:, None]))     # (G, T)
    eff = torch.exp(-sw_log * t)                                 # (T,)
    moved = base[src] * m
    col = base.clone()
    col[src] = base[src] - moved
    col[dst] = base[dst] + moved * inv_gain[:, None]
    return col * eff[None, :]
