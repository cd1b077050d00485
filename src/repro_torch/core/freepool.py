"""Free-pool sizing: predictive pre-provisioning (paper §5).

Cloud VM provisioning takes minutes at p90/p99 (paper Fig. 10), far above
a sub-second SLO for warehouse creation, so a pool of pre-provisioned VMs
absorbs demand spikes.  The paper minimizes

    c(t) = p_o * max(0, y_hat_t - d_t) + p_u * max(0, d_t - y_hat_t)

over the pool size y_hat_t per time window.  This is §3's asymmetric
newsvendor objective again, so the optimal *static* pool is the
p_u/(p_o+p_u) quantile of demand, and the optimal *predicted* pool is that
quantile of the forecast residuals stacked on the point forecast.  Both are
here, with the provisioning lead time: the pool must cover demand over the
replenishment lead window.

Quantiles are :func:`_quantile`, the reference's ``jnp.quantile`` bit
for bit.  :func:`predicted_pool` and
:func:`compare_static_vs_predicted` run on ``device`` (default the card).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import forecast as fc
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class FreePoolConfig:
    p_over: float = 1.0    # cost / over-provisioned server-minute
    p_under: float = 10.0  # cost / under-provisioned server (SLO miss)
    lead_time: int = 3     # provisioning latency in windows (paper Fig 10)


def pool_cost(
    pool: torch.Tensor, demand: torch.Tensor,
    cfg: FreePoolConfig = FreePoolConfig(),
) -> torch.Tensor:
    """The paper's c(t), summed over time.  pool, demand: (..., T)."""
    over = torch.clamp(pool - demand, min=0.0)
    under = torch.clamp(demand - pool, min=0.0)
    return (cfg.p_over * over + cfg.p_under * under).sum(-1)


def critical_fractile(cfg: FreePoolConfig) -> float:
    return cfg.p_under / (cfg.p_under + cfg.p_over)


def _quantile(a: torch.Tensor, q: float) -> torch.Tensor:
    """(...) ``q`` quantile of the last axis of float32 ``a``, the
    reference's ``jnp.quantile(a, q, axis=-1)`` bit for bit.  Several rows
    are :func:`repro_torch.core.forecast._quantile_linear`.  One row is a
    scalar quantile, which XLA's CPU program evaluates the other way round:
    lo (1 - h) rounded to float32 and hi h fused into the add (one
    rounding, reproduced in float64)."""
    n = a.shape[-1]
    if a.numel() != n:
        return fc._quantile_linear(a, [q])[..., 0]
    pos = torch.tensor(q, dtype=torch.float32) * float(n - 1)
    lo, hi = torch.floor(pos), torch.ceil(pos)
    h = pos - lo
    wl = float(1.0 - h)
    srt = torch.sort(a, dim=-1).values
    lo, hi = (int(v.clamp(0, n - 1)) for v in (lo, hi))
    return ((srt[..., lo] * wl).double()
            + srt[..., hi].double() * float(h)).to(a.dtype)


def optimal_static_pool(
    demand: torch.Tensor, cfg: FreePoolConfig = FreePoolConfig()
) -> torch.Tensor:
    """Best single pool size: the critical-fractile quantile of demand
    (..., T) -> (...)."""
    return _quantile(demand, critical_fractile(cfg))


def predicted_pool(
    demand_history,
    demand_future_len: int,
    cfg: FreePoolConfig = FreePoolConfig(),
    *,
    device: "torch.device | str | None" = None,
) -> torch.Tensor:
    """Forecast-driven pool sizing (paper §5.1), (demand_future_len,) on
    ``device``.

    Fits the structural forecaster on the history (T,), takes the point
    forecast for the future, and adds a safety margin equal to the
    critical-fractile quantile of the in-sample residuals: the newsvendor
    answer under the empirical residual distribution.  The lead time
    shifts the target: the pool set now must cover demand ``lead_time``
    windows ahead, so each hour takes the max of the forecast over its
    lead window.

    The pool model has no trend changepoints and no yearly terms: the last
    changepoint segment's slope is fit on a sliver of recent history, and
    extrapolating it over even a 2-day horizon injects double-digit-%
    phantom demand drops.  One global trend plus daily and weekly
    seasonality suits short horizons; the residual quantile absorbs what
    it misses."""
    dev = resolve_device(device)
    hist = torch.as_tensor(demand_history, dtype=torch.float32).to(dev)
    model_cfg = fc.ForecastConfig(yearly_order=0, num_changepoints=0)
    t_hist = hist.shape[-1]
    t_max = float(t_hist - 1)
    beta = fc._fit(hist[None], model_cfg, t_max)[0]
    model = fc.ForecastModel(beta=beta, t_max=t_max, cfg=model_cfg)

    fitted = fc.predict(model, torch.arange(t_hist, device=dev))
    q = _quantile(hist - fitted, critical_fractile(cfg))

    future_t = t_hist + torch.arange(demand_future_len + cfg.lead_time,
                                     device=dev)
    yhat = fc.predict(model, future_t)
    # Cover the worst point forecast over the lead window starting at each
    # hour: the lead_time + 1 shifted slices as one unfold.
    yhat_eff = yhat.unfold(0, demand_future_len, 1).amax(0)
    return torch.clamp(yhat_eff + q, min=0.0)


def compare_static_vs_predicted(
    history,
    future,
    cfg: FreePoolConfig = FreePoolConfig(),
    *,
    device: "torch.device | str | None" = None,
) -> dict:
    """Paper Fig. 12: cost of the best static pool against the predicted
    pool on a held-out window, both on ``device``; one copy to the host."""
    dev = resolve_device(device)
    history = torch.as_tensor(history, dtype=torch.float32).to(dev)
    future = torch.as_tensor(future, dtype=torch.float32).to(dev)
    static = optimal_static_pool(history, cfg)
    static_series = static.expand_as(future)
    pred = predicted_pool(history, future.shape[-1], cfg, device=dev)
    host = torch.stack([
        static,
        pool_cost(static_series, future, cfg),
        pool_cost(pred, future, cfg),
        pred.mean(),
        torch.clamp(future - static_series, min=0.0).sum(),
        torch.clamp(future - pred, min=0.0).sum(),
    ]).cpu().tolist()
    return dict(zip(("static_size", "static_cost", "predicted_cost",
                     "predicted_mean_size", "under_minutes_static",
                     "under_minutes_predicted"), host))


def provisioning_latency_profile(hour_of_day: torch.Tensor) -> torch.Tensor:
    """Synthetic p99 provisioning-latency curve (minutes) by hour of day,
    shaped like paper Fig. 10: elevated at business peaks."""
    return 2.0 + 1.5 * torch.sin(2 * torch.pi * (hour_of_day - 14) / 24.0) ** 2
