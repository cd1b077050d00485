"""Structural time-series forecaster (paper §3.3.3, Prophet replacement):
the prefix-refit half the rolling replay runs every week.

    log y = beta . [1, t, relu(t - cp_1..K),            # piecewise trend
                    fourier_daily, fourier_weekly, fourier_yearly,
                    holiday_dummy]

solved as ridge-regularized least squares through the normal equations.
With one fixed design matrix (time normalization and changepoints pinned
to the full trace), the week-w normal equations are prefix sums of
per-week blocks, so a weekly refit is one gather plus a (D, D) ridge solve.

Float32 throughout, as in the reference.  The solves use
``torch.linalg.solve_ex``, which skips the singularity check and with it a
device-to-host sync; the ridge term keeps the systems well posed.
Matrix products are full float32 only with TF32 off
(``torch.backends.cuda.matmul.allow_tf32``, False by default).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.demand import DAYS_PER_YEAR, HOURS_PER_DAY, HOURS_PER_WEEK
from repro_torch.numerics import linspace

HOURS_PER_YEAR = HOURS_PER_DAY * DAYS_PER_YEAR


@dataclasses.dataclass(frozen=True)
class ForecastConfig:
    daily_order: int = 4        # Fourier harmonics per period
    weekly_order: int = 6
    yearly_order: int = 8
    num_changepoints: int = 8   # evenly spaced piecewise-linear trend knots
    ridge: float = 1e-3
    asym_weight: float = 2.1    # paper footnote 2: under-forecast costs 2.1x
    irls_iters: int = 4
    holiday_start_day: int = 357  # Dec 24 (day-of-year, 0-based)
    holiday_len_days: int = 9


def _fourier(t: torch.Tensor, period: float, order: int) -> torch.Tensor:
    """(T, 2*order) Fourier design block."""
    k = torch.arange(1, order + 1, dtype=torch.float32, device=t.device)
    ang = 2.0 * math.pi * t[:, None] * k[None, :] / period
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def design_matrix(
    t_hours: torch.Tensor, cfg: ForecastConfig, t_max: float
) -> torch.Tensor:
    """Feature matrix X (T, D).  ``t_max`` fixes changepoint locations so the
    same basis extends consistently into the future."""
    t = t_hours.to(torch.float32)
    ts = t / t_max  # normalized time for trend columns
    cols = [torch.ones_like(ts)[:, None], ts[:, None]]
    if cfg.num_changepoints:
        cps = linspace(0.1, 0.9, cfg.num_changepoints, device=t.device)
        cols.append(torch.clamp(ts[:, None] - cps[None, :], min=0.0))
    cols.append(_fourier(t, HOURS_PER_DAY, cfg.daily_order))
    cols.append(_fourier(t, HOURS_PER_WEEK, cfg.weekly_order))
    cols.append(_fourier(t, HOURS_PER_YEAR, cfg.yearly_order))
    day_of_year = torch.remainder(
        torch.div(t, HOURS_PER_DAY, rounding_mode="floor"), DAYS_PER_YEAR
    )
    holiday = (
        (day_of_year >= cfg.holiday_start_day)
        & (day_of_year < cfg.holiday_start_day + cfg.holiday_len_days)
    ).to(torch.float32)
    cols.append(holiday[:, None])
    return torch.cat(cols, dim=-1)


def _ridge_solve(gram: torch.Tensor, rhs: torch.Tensor, ridge: float):
    """Solve (gram + ridge I) beta = rhs for one shared gram and a batch of
    right-hand sides rhs (P, D) -> (P, D)."""
    g = gram + ridge * torch.eye(
        gram.shape[-1], dtype=gram.dtype, device=gram.device
    )
    return torch.linalg.solve_ex(g, rhs.T)[0].T


@dataclasses.dataclass(frozen=True)
class PrefixFitState:
    """Precomputed normal-equation state for rolling prefix re-fits:

        gram_prefix[w] = sum_{t < (w+1) 168} x_t x_t^T     (pool-shared)
        rhs_prefix[p, w] = sum_{t < (w+1) 168} x_t log y_{p,t}

    Unweighted; :func:`irls_refine` adds the asymmetric reweighting as an
    optional exact refinement on top of the prefix solve."""

    x: torch.Tensor            # (T + H, D) design over history + horizon
    gram_prefix: torch.Tensor  # (W, D, D) cumulative X^T X per week prefix
    rhs_prefix: torch.Tensor   # (P, W, D) cumulative X^T log y per prefix
    logy: torch.Tensor         # (P, T) log-space targets
    cfg: ForecastConfig
    t_max: float
    num_hist_hours: int
    period_hours: int


def prefix_fit_state(
    ys: torch.Tensor,
    cfg: ForecastConfig = ForecastConfig(),
    *,
    horizon_hours: int,
    period_hours: int = HOURS_PER_WEEK,
    min_prefix_hours: int | None = None,
) -> PrefixFitState:
    """Build the rolling-refit state for a (P, T) pool batch, on ``ys``'s
    device.

    ``min_prefix_hours`` is the shortest prefix any refit will see: the
    short-history guard on the yearly Fourier terms keys on it.  T is
    truncated to whole periods."""
    ys = torch.as_tensor(ys, dtype=torch.float32)
    dev = ys.device
    num_weeks = ys.shape[-1] // period_hours
    t_hist = num_weeks * period_hours
    ys = ys[..., :t_hist]
    guard_hours = t_hist if min_prefix_hours is None else min_prefix_hours
    if guard_hours < 1.2 * HOURS_PER_YEAR and cfg.yearly_order:
        cfg = dataclasses.replace(cfg, yearly_order=0)
    t_max = float(max(t_hist - 1, 1))
    t_all = torch.arange(t_hist + horizon_hours, dtype=torch.float32, device=dev)
    x = design_matrix(t_all, cfg, t_max)
    xh = x[:t_hist]
    d = xh.shape[-1]
    xw = xh.reshape(num_weeks, period_hours, d)
    gram_prefix = torch.cumsum(torch.einsum("wtd,wte->wde", xw, xw), dim=0)
    logy = torch.log(torch.clamp(ys, min=1e-6))
    lw = logy.reshape(ys.shape[0], num_weeks, period_hours)
    rhs_prefix = torch.cumsum(torch.einsum("wtd,pwt->pwd", xw, lw), dim=1)
    return PrefixFitState(
        x=x, gram_prefix=gram_prefix, rhs_prefix=rhs_prefix, logy=logy,
        cfg=cfg, t_max=t_max, num_hist_hours=t_hist,
        period_hours=period_hours,
    )


def solve_prefix(state: PrefixFitState, week: int) -> torch.Tensor:
    """beta (P, D) fit on the prefix of ``week`` whole periods — one index
    into the cumulative normal equations + a ridge solve; ``week >= 1``."""
    return _ridge_solve(
        state.gram_prefix[week - 1], state.rhs_prefix[:, week - 1],
        state.cfg.ridge,
    )


def solve_prefix_direct(state: PrefixFitState, week: int) -> torch.Tensor:
    """The same prefix fit computed the naive way: mask the full design and
    re-accumulate the normal equations from scratch, O(T D^2) per call —
    the independent implementation the prefix-sum path is tested against;
    it differs from :func:`solve_prefix` only in float summation order."""
    xh = state.x[: state.num_hist_hours]
    t = torch.arange(state.num_hist_hours, device=xh.device)
    mask = (t < week * state.period_hours).to(xh.dtype)
    xm = xh * mask[:, None]
    g = xm.T @ xh
    r = torch.einsum("td,pt->pd", xm, state.logy)
    return _ridge_solve(g, r, state.cfg.ridge)


def irls_refine(
    state: PrefixFitState, beta: torch.Tensor, week: int, iters: int
) -> torch.Tensor:
    """Optional asymmetric-error refinement of a prefix fit: ``iters`` IRLS
    passes over the masked prefix (under-forecast residuals weighted
    ``cfg.asym_weight``), each a full O(P T D^2) masked accumulation;
    ``iters=0`` returns ``beta`` unchanged."""
    if iters == 0:
        return beta
    xh = state.x[: state.num_hist_hours]
    t = torch.arange(state.num_hist_hours, device=xh.device)
    mask = (t < week * state.period_hours).to(xh.dtype)
    eye = state.cfg.ridge * torch.eye(
        xh.shape[-1], dtype=xh.dtype, device=xh.device
    )
    for _ in range(iters):
        resid = state.logy - beta @ xh.T                     # (P, T)
        w = torch.where(resid > 0, state.cfg.asym_weight, 1.0) * mask
        g = torch.einsum("pt,td,te->pde", w, xh, xh)         # (P, D, D)
        r = torch.einsum("pt,td->pd", w * state.logy, xh)
        beta = torch.linalg.solve_ex(g + eye, r[..., None])[0][..., 0]
    return beta


def predict_from_beta(
    state: PrefixFitState, beta: torch.Tensor, t_start: int, num_hours: int
) -> torch.Tensor:
    """(P, num_hours) forecast from prefix-fit betas starting at absolute
    hour ``t_start``."""
    xf = state.x[t_start:t_start + num_hours]
    return torch.exp(beta @ xf.T)
