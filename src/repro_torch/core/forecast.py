"""Structural time-series forecaster (paper §3.3.3, Prophet replacement):
the one-shot fit (:func:`fit`, :func:`fit_batched`) and the prefix refits
the rolling replay runs every week.

    log y = beta . [1, t, relu(t - cp_1..K),            # piecewise trend
                    fourier_daily, fourier_weekly, fourier_yearly,
                    holiday_dummy]

solved as ridge-regularized least squares through the normal equations,
then reweighted by IRLS so that under-forecast hours (residual > 0) weigh
``asym_weight`` times more, the paper's asymmetric error metric.
With one fixed design matrix (time normalization and changepoints pinned
to the full trace), the week-w normal equations are prefix sums of
per-week blocks, so a weekly refit is one gather plus a (D, D) ridge solve.

A state built with ``row_block`` runs every per-row product, solve and
reduction of its refits block by block, ``row_block`` rows at a time: a
row's result then has the same bits whatever the number of rows beside it
(a GEMM's or a solve's blocking, and so its rounding, depends on the
number of rows), which is what a scenario-batched replay needs for its
scenario 0 to equal the unbatched replay.

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


@dataclasses.dataclass
class ForecastModel:
    beta: torch.Tensor  # (D,), or (P, D) from fit_batched
    t_max: float
    cfg: ForecastConfig


def _whiten(x: torch.Tensor, ridge: float):
    """The preconditioner that the weighted ridge systems over the design
    x (T, D) share: A = L^-T from the float64 Cholesky factor L of
    X^T X + ridge I, Z = X A, the hourly outer products of Z's rows
    (T, D*D), and the penalty ridge A^T A.

    In beta = A gamma the system (X^T W X + ridge I) beta = X^T W y reads
    (Z^T W Z + ridge A^T A) gamma = Z^T W y, the same estimator; for
    weights in [1, asym] its eigenvalues lie in [1, asym].  The plain
    normal equations do not: with the yearly terms on, X^T X + ridge I has
    a condition number near 1e7, where float32 sums lose the fit."""
    d = x.shape[-1]
    x64 = x.to(torch.float64)
    eye = torch.eye(d, dtype=torch.float64, device=x.device)
    chol = torch.linalg.cholesky_ex(x64.T @ x64 + ridge * eye)[0]
    a = torch.linalg.solve_triangular(chol.mT, eye, upper=True)
    z = (x64 @ a).to(x.dtype)
    outer = (z[:, :, None] * z[:, None, :]).reshape(-1, d * d)
    return a, z, outer, (ridge * a.T @ a).to(x.dtype)


def _solve_wls(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor, ridge,
               whitened=None):
    """Weighted ridge least squares for a batch of rows sharing the design
    x (T, D): targets y and weights w (P, T) -> beta (P, D), solved in the
    whitened basis of :func:`_whiten` (``whitened``, when given, is its
    result for x).

    The P weighted grams are one matrix product, w (P, T) @ the hourly
    outer products (T, D*D), so no (P, T, D) weighted design is formed."""
    a, z, outer, pen = whitened if whitened is not None else _whiten(x, ridge)
    d = z.shape[-1]
    g = (w @ outer).reshape(-1, d, d) + pen
    r = (w * y) @ z
    gamma = torch.linalg.solve_ex(g, r[..., None])[0][..., 0]
    return (gamma.to(torch.float64) @ a.T).to(x.dtype)


def _irls(x, logy, beta, iters: int, cfg: ForecastConfig, whitened=None,
          mask=None):
    """``iters`` asymmetric IRLS passes from ``beta`` (P, D): each weighs
    under-forecast hours ``cfg.asym_weight`` (times the 0/1 ``mask`` (T,),
    when given) and re-solves, a full O(P T D^2) accumulation.
    ``whitened`` is :func:`_whiten` of the (masked) design, when known."""
    if iters == 0:
        return beta
    if whitened is None:
        whitened = _whiten(x if mask is None else x * mask[:, None],
                           cfg.ridge)
    for _ in range(iters):
        resid = logy - beta @ x.T                            # (P, T)
        w = torch.where(resid > 0, cfg.asym_weight, 1.0)
        if mask is not None:
            w = w * mask
        beta = _solve_wls(x, logy, w, cfg.ridge, whitened)
    return beta


def _fit(ys: torch.Tensor, cfg: ForecastConfig, t_max: float) -> torch.Tensor:
    """beta (P, D) for histories ys (P, T): one unweighted ridge solve, whose
    gram all rows share, then ``cfg.irls_iters`` IRLS passes, all in the
    whitened basis of :func:`_whiten`."""
    t = torch.arange(ys.shape[-1], dtype=torch.float32, device=ys.device)
    x = design_matrix(t, cfg, t_max)
    logy = torch.log(torch.clamp(ys, min=1e-6))
    whitened = _whiten(x, cfg.ridge)
    a, z, _, pen = whitened
    gamma = torch.linalg.solve_ex(z.T @ z + pen, (logy @ z).T)[0].T
    beta = (gamma.to(torch.float64) @ a.T).to(torch.float32)
    return _irls(x, logy, beta, cfg.irls_iters, cfg, whitened)


def _guarded(cfg: ForecastConfig, num_hours: int) -> ForecastConfig:
    """The short-history guard: below ~1.2 years of history the yearly
    Fourier terms are unidentifiable and extrapolate wildly, so they are
    turned off (the guard Prophet applies)."""
    if num_hours < 1.2 * HOURS_PER_YEAR and cfg.yearly_order:
        return dataclasses.replace(cfg, yearly_order=0)
    return cfg


def fit(y: torch.Tensor, cfg: ForecastConfig = ForecastConfig()) -> ForecastModel:
    """Fit on an hourly history ``y`` (T,), on its device; yearly terms off
    below ~1.2 years of history."""
    y = torch.as_tensor(y, dtype=torch.float32)
    cfg = _guarded(cfg, y.shape[-1])
    t_max = float(max(y.shape[-1] - 1, 1))
    return ForecastModel(beta=_fit(y[None], cfg, t_max)[0], t_max=t_max,
                         cfg=cfg)


def fit_batched(
    ys: torch.Tensor, cfg: ForecastConfig = ForecastConfig()
) -> ForecastModel:
    """:func:`fit` over a (P, T) pool batch in one pass (the reference's
    vmap), with the same short-history guard."""
    ys = torch.as_tensor(ys, dtype=torch.float32)
    cfg = _guarded(cfg, ys.shape[-1])
    t_max = float(max(ys.shape[-1] - 1, 1))
    return ForecastModel(beta=_fit(ys, cfg, t_max), t_max=t_max, cfg=cfg)


def predict(model: ForecastModel, t_hours: torch.Tensor) -> torch.Tensor:
    """Predict demand at absolute hour indices ``t_hours`` (may be future)."""
    x = design_matrix(t_hours.to(torch.float32), model.cfg, model.t_max)
    return torch.exp(x @ model.beta)


def predict_batched(model: ForecastModel, t_hours: torch.Tensor) -> torch.Tensor:
    """(P, H) predictions of a :func:`fit_batched` model."""
    x = design_matrix(t_hours.to(torch.float32), model.cfg, model.t_max)
    return torch.exp(model.beta @ x.T)


def forecast_horizon(
    model: ForecastModel, t_start: int, num_hours: int
) -> torch.Tensor:
    """Forecast ``num_hours`` starting at absolute hour ``t_start``, on the
    model's device (Step 1 of Algorithm 1)."""
    t = t_start + torch.arange(num_hours, device=model.beta.device)
    return predict(model, t)


def weighted_mape(
    y_true: torch.Tensor, y_pred: torch.Tensor, asym: float = 2.1
) -> torch.Tensor:
    """The paper's asymmetric error metric (footnote 2): under-forecast
    errors (y_true > y_pred, i.e. we'd pay on-demand) cost ``asym`` x more."""
    err = (y_true - y_pred) / torch.clamp(y_true, min=1e-9)
    w = torch.where(err > 0, asym, 1.0)
    return (w * err.abs()).mean(-1)


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
    row_block: int | None = None  # rows per block of the refits (None: all)

    def blocks(self) -> list[slice]:
        """The row blocks the refits run on, in row order."""
        rows = self.rhs_prefix.shape[0]
        step = self.row_block or max(rows, 1)
        return [slice(i, i + step) for i in range(0, rows, step)]


def prefix_fit_state(
    ys: torch.Tensor,
    cfg: ForecastConfig = ForecastConfig(),
    *,
    horizon_hours: int,
    period_hours: int = HOURS_PER_WEEK,
    min_prefix_hours: int | None = None,
    row_block: int | None = None,
) -> PrefixFitState:
    """Build the rolling-refit state for a (P, T) pool batch, on ``ys``'s
    device.

    ``min_prefix_hours`` is the shortest prefix any refit will see: the
    short-history guard on the yearly Fourier terms keys on it.  T is
    truncated to whole periods.  ``row_block`` (dividing P) makes every
    per-row result independent of P (module docstring)."""
    ys = torch.as_tensor(ys, dtype=torch.float32)
    dev = ys.device
    num_weeks = ys.shape[-1] // period_hours
    t_hist = num_weeks * period_hours
    ys = ys[..., :t_hist]
    cfg = _guarded(cfg, t_hist if min_prefix_hours is None
                   else min_prefix_hours)
    t_max = float(max(t_hist - 1, 1))
    t_all = torch.arange(t_hist + horizon_hours, dtype=torch.float32, device=dev)
    x = design_matrix(t_all, cfg, t_max)
    xh = x[:t_hist]
    d = xh.shape[-1]
    xw = xh.reshape(num_weeks, period_hours, d)
    gram_prefix = torch.cumsum(torch.einsum("wtd,wte->wde", xw, xw), dim=0)
    rows = ys.shape[0]
    if row_block is not None and rows % row_block:
        raise ValueError(f"row_block={row_block} does not divide {rows} rows")
    step = row_block or max(rows, 1)
    logy = torch.empty_like(ys)
    rhs_prefix = torch.empty((rows, num_weeks, d), dtype=torch.float32,
                             device=dev)
    for i in range(0, rows, step):
        blk = slice(i, i + step)
        logy[blk] = torch.log(torch.clamp(ys[blk], min=1e-6))
        lw = logy[blk].reshape(-1, num_weeks, period_hours)
        rhs_prefix[blk] = torch.cumsum(
            torch.einsum("wtd,pwt->pwd", xw, lw), dim=1)
    return PrefixFitState(
        x=x, gram_prefix=gram_prefix, rhs_prefix=rhs_prefix, logy=logy,
        cfg=cfg, t_max=t_max, num_hist_hours=t_hist,
        period_hours=period_hours, row_block=row_block,
    )


def solve_prefix(state: PrefixFitState, week: int) -> torch.Tensor:
    """beta (P, D) fit on the prefix of ``week`` whole periods — one index
    into the cumulative normal equations + a ridge solve; ``week >= 1``."""
    rhs = state.rhs_prefix[:, week - 1]
    return torch.cat([
        _ridge_solve(state.gram_prefix[week - 1], rhs[blk], state.cfg.ridge)
        for blk in state.blocks()
    ])


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
    return torch.cat([
        _ridge_solve(g, torch.einsum("td,pt->pd", xm, state.logy[blk]),
                     state.cfg.ridge)
        for blk in state.blocks()
    ])


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
    whitened = _whiten(xh * mask[:, None], state.cfg.ridge)
    return torch.cat([
        _irls(xh, state.logy[blk], beta[blk], iters, state.cfg, whitened,
              mask=mask)
        for blk in state.blocks()
    ])


def predict_from_beta(
    state: PrefixFitState, beta: torch.Tensor, t_start: int, num_hours: int
) -> torch.Tensor:
    """(P, num_hours) forecast from prefix-fit betas starting at absolute
    hour ``t_start``."""
    xf = state.x[t_start:t_start + num_hours]
    out = torch.empty((beta.shape[0], num_hours), dtype=beta.dtype,
                      device=beta.device)
    for blk in state.blocks():
        torch.mm(beta[blk], xf.T, out=out[blk])
    return torch.exp_(out)
