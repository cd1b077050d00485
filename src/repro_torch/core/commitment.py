"""Commitment-level optimization (paper §3.1-§3.2).

The paper minimizes, over the commitment level ``c``, the two-sided cost

    C(c) = A * sum_t max(f_t - c, 0)     (on-demand premium above the line)
        + B * sum_t max(c - f_t, 0)     (unused committed capacity below)

for an empirical hourly demand curve ``f``.  ``C`` is convex and piecewise
linear in ``c``; its minimizer is the A/(A+B) order statistic of ``f``.
Three solvers, tested against each other and against the reference:

  * :func:`optimal_commitment_quantile` — exact, one sort;
  * :func:`optimal_commitment_golden`  — fixed-iteration golden section,
    batched over rows; on the card each iteration's two evaluations are
    one launch of the commitment-sweep kernel;
  * :func:`optimal_commitment_brent`   — scipy's bounded Brent on the host,
    the paper's own method.

:func:`cost_curve` evaluates a candidate grid: on CUDA tensors it is the
commitment-sweep kernel (``kernels/commitment_sweep``), on CPU tensors the
plain formula.  Every function runs on the device of its tensor.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.kernels.commitment_sweep import ops as sweep_ops
from repro_torch.numerics import linspace

# Paper §3.2: On-Demand averages 2.1x the 3-year savings-plan rate (Table 2).
DEFAULT_A = 2.1  # cost factor for demand above the commitment (on-demand)
DEFAULT_B = 1.0  # cost factor for unused commitment below the line

_INVPHI = float((np.sqrt(5.0) - 1.0) / 2.0)  # 1/phi
_INVPHI2 = float((3.0 - np.sqrt(5.0)) / 2.0)  # 1/phi^2


def _level(c, f: torch.Tensor) -> torch.Tensor:
    """``c`` as a float32 tensor on ``f``'s device with a trailing axis."""
    return torch.as_tensor(c, dtype=f.dtype, device=f.device)[..., None]


def commitment_cost(
    f: torch.Tensor, c, a: float = DEFAULT_A, b: float = DEFAULT_B
) -> torch.Tensor:
    """C(c): paper Eq. (1) on the sample grid of ``f``.  ``f`` (..., T),
    ``c`` broadcastable to (...,); returns (...,).  The paper's objective
    counts only the mismatch areas, not the committed capacity itself."""
    c = _level(c, f)
    over = torch.clamp(f - c, min=0.0)
    under = torch.clamp(c - f, min=0.0)
    return a * over.sum(-1) + b * under.sum(-1)


def total_spend(
    f: torch.Tensor,
    c,
    a: float = DEFAULT_A,
    committed_rate: float = 1.0,
) -> torch.Tensor:
    """Actual dollars: committed capacity (used or not) at
    ``committed_rate`` plus on-demand overflow at ``a``.  Its minimizer is
    the (1 - 1/a) quantile, not Eq. (1)'s A/(A+B); the planner optimizes
    and reports Eq. (1), as the paper does."""
    c = _level(c, f)
    t = f.shape[-1]
    over = torch.clamp(f - c, min=0.0).sum(-1)
    return committed_rate * c[..., 0] * t + a * over


def cost_curve(
    f: torch.Tensor,
    cs: torch.Tensor,
    a: float = DEFAULT_A,
    b: float = DEFAULT_B,
) -> torch.Tensor:
    """C(c) on a shared grid: f (..., T), cs (G,) -> (..., G).

    One launch of the commitment-sweep kernel on CUDA tensors (the rows
    are f's leading axes flattened, the candidate row shared, no weights);
    the plain formula on CPU tensors."""
    lead = f.shape[:-1]
    rows = f.reshape(-1, f.shape[-1])
    cs = torch.as_tensor(cs, dtype=f.dtype, device=f.device)
    costs = sweep_ops.commitment_sweep(rows, cs, a=a, b=b)
    return costs.reshape(*lead, cs.shape[-1])


def optimal_commitment_quantile(
    f: torch.Tensor, a: float = DEFAULT_A, b: float = DEFAULT_B
) -> torch.Tensor:
    """Exact minimizer of C(c): the k*-th order statistic of ``f`` with
    k* = ceil(T * A/(A+B)), the first count of samples below c at which
    the slope B k - A (T - k) turns nonnegative.  f (..., T) -> (...,).

    k* is static.  T * A/(A+B) is rounded to float32 before the ceiling,
    as the reference's ``jnp.ceil`` of a Python float does."""
    q = a / (a + b)
    t = f.shape[-1]
    idx = min(max(math.ceil(float(np.float32(t * q))) - 1, 0), t - 1)
    return torch.sort(f, dim=-1).values[..., idx]


def golden_rows(
    rows: torch.Tensor,
    w: torch.Tensor | None,
    lo: torch.Tensor,
    hi: torch.Tensor,
    a: float,
    b: float,
    *,
    iters: int,
    fractions: tuple[float, float] = (_INVPHI2, _INVPHI),
) -> torch.Tensor:
    """Golden section on each row's weighted cost
    a * sum_t w max(f - c, 0) + b * sum_t w max(c - f, 0) inside [lo, hi]:
    rows, w (R, T), lo, hi (R,) -> (R,).  Each iteration evaluates its two
    candidates per row, at ``fractions`` of the bracket, as one commitment
    sweep: on CUDA tensors one kernel launch, on CPU tensors the plain
    formula.  A fixed count, so no step reads the device back."""
    f1, f2 = fractions
    for _ in range(iters):
        x1 = lo + f1 * (hi - lo)
        x2 = lo + f2 * (hi - lo)
        costs = sweep_ops.commitment_sweep(
            rows, torch.stack([x1, x2], dim=-1), w, a=a, b=b
        )
        smaller1 = costs[:, 0] < costs[:, 1]
        lo = torch.where(smaller1, lo, x1)
        hi = torch.where(smaller1, x2, hi)
    return 0.5 * (lo + hi)


def optimal_commitment_golden(
    f: torch.Tensor,
    a: float = DEFAULT_A,
    b: float = DEFAULT_B,
    *,
    iters: int = 60,
) -> torch.Tensor:
    """Golden-section minimization of C(c) between each row's min and max,
    batched over rows with the exact 1/phi and 1/phi^2; 60 iterations
    shrink the bracket ~1e-13x.  f (..., T) -> (...,)."""
    rows = f.reshape(-1, f.shape[-1])
    c = golden_rows(rows, None, rows.amin(-1), rows.amax(-1), a, b,
                    iters=iters)
    return c.reshape(f.shape[:-1])


def optimal_commitment_brent(
    f, a: float = DEFAULT_A, b: float = DEFAULT_B
) -> float:
    """The paper's baseline: Brent's method [Brent 1973] via scipy, on the
    host.  A tensor is copied to numpy first."""
    from scipy.optimize import minimize_scalar

    if isinstance(f, torch.Tensor):
        f = f.detach().cpu().numpy()
    f = np.asarray(f)

    def obj(c):
        return float(
            a * np.maximum(f - c, 0.0).sum() + b * np.maximum(c - f, 0.0).sum()
        )

    res = minimize_scalar(
        obj, bounds=(float(f.min()), float(f.max())), method="bounded"
    )
    return float(res.x)


def scenario_costs(
    f: torch.Tensor,
    num_levels: int = 9,
    a: float = DEFAULT_A,
    b: float = DEFAULT_B,
):
    """Paper Fig 4: ``num_levels`` evenly spaced commitment levels between
    min and max demand of a (T,) trace; returns (levels, costs, argmin
    index), all on ``f``'s device."""
    levels = linspace(f.amin(), f.amax(), num_levels, device=f.device)
    costs = cost_curve(f, levels, a, b)
    return levels, costs, torch.argmin(costs, dim=-1)


def unused_commitment_fraction(f: torch.Tensor, c) -> torch.Tensor:
    """Fraction of committed capacity left unused (paper §4 reports ~4.3%)."""
    c = _level(c, f)
    unused = torch.clamp(c - f, min=0.0).sum(-1)
    total = c[..., 0] * f.shape[-1]
    return unused / torch.clamp(total, min=1e-12)
