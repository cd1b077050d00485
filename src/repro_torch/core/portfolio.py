"""Multi-option commitment portfolios (paper §3 generalized; Table 2 SKUs).

Capacity is a *stack* of tranches: option k covers the band
(s_{k-1}, s_k], on-demand everything above the stack top.  Each option is a
cost line over slice utilization u, ``l_k(u) = alpha_k (1 - u) + beta_k u``
(committed: alpha = beta = rate; on-demand: alpha = od_rate, beta = 0), and
the optimal stack is the lower envelope of the K+1 lines: each threshold is
a weighted quantile of demand at the fractile where one option hands over
to the next.

Two solvers, both batched over a leading row axis (the reference vmaps):

* :func:`optimal_portfolio_stack` — exact, O(T log T) per row: the band
  assignment is demand independent, thresholds are gathers into sorted
  demand;
* :func:`optimal_portfolio_grid` — the grid solver on the commitment
  sweep's over/under integrals; thresholds land on grid-cell edges.

:func:`portfolio_spends` bills stacks in real dollars over an evaluation
window, all rows in one sweep.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.capacity import pricing
from repro_torch.kernels.commitment_sweep import ops as sweep_ops
from repro_torch.numerics import linspace

# Fail at import, not as a silently absurd plan, if the pricing rows this
# module turns into cost lines ever stop satisfying their invariants.
pricing.validate_tables()


@dataclasses.dataclass(frozen=True)
class PurchaseOption:
    """One purchasable commitment SKU.

    ``rate`` is the committed $/unit-hour in normalized units (mean Table-2
    3y committed rate = 1.0, so on-demand ~= 2.1).  ``convertible`` marks
    the cloud-level exchangeable SKU class, which the convertible slice
    (ROADMAP Queue 1, item 11) adds to the planner."""

    name: str
    cloud: str
    rate: float
    term_weeks: int
    convertible: bool = False


def options_from_pricing(
    plans: Sequence[pricing.SavingsPlan] | None = None,
    *,
    terms: Sequence[str] = ("1y", "3y"),
    clouds: Sequence[str] | None = None,
) -> list[PurchaseOption]:
    """Turn Table 2 rows into PurchaseOptions (1y and 3y per SKU), rates
    normalized so the mean 3y committed rate is 1.0."""
    plans = list(plans if plans is not None else pricing.SAVINGS_PLANS)
    if clouds is not None:
        plans = [p for p in plans if p.cloud in clouds]
    base = 1.0 - pricing.mean_discount_3y()
    out = []
    for p in plans:
        if "1y" in terms:
            out.append(PurchaseOption(
                f"{p.cloud}/{p.family}/1y", p.cloud,
                (1.0 - p.discount_1y) / base, 52,
            ))
        if "3y" in terms:
            out.append(PurchaseOption(
                f"{p.cloud}/{p.family}/3y", p.cloud,
                (1.0 - p.discount_3y) / base, 156,
            ))
    return out


def option_lines(
    options: Sequence[PurchaseOption],
    *,
    term_weighting: float = 0.0,
    device=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(alphas, betas) cost-line coefficients (K,) for ``options``.

    ``term_weighting`` in [0, 1] interpolates the idle-cost coefficient
    between exact in-window dollars (0.0: beta = rate) and term-proportional
    stranding (1.0: beta = rate * term/term_max)."""
    if not options:
        raise ValueError("portfolio requires at least one purchase option")
    rates = torch.tensor(
        [o.rate for o in options], dtype=torch.float32, device=device
    )
    terms = torch.tensor(
        [o.term_weeks for o in options], dtype=torch.float32, device=device
    )
    load = (1.0 - term_weighting) + term_weighting * terms / terms.max()
    return rates, rates * load


def pool_option_lines(
    options: Sequence[PurchaseOption],
    clouds: Sequence[str],
    *,
    term_weighting: float = 0.0,
    od_rate: float = 2.1,
    device=None,
) -> tuple[torch.Tensor, torch.Tensor, np.ndarray]:
    """Per-pool cost lines (P, K) for a fleet of pools on ``clouds``.

    An option is purchasable in a pool only when their clouds match;
    unavailable options are priced at the on-demand rate (alpha = beta =
    od_rate), which never undercuts the on-demand line and so gets zero
    width.  Returns (alphas (P, K), betas (P, K), available (P, K) numpy)."""
    al, be = option_lines(
        options, term_weighting=term_weighting, device=device
    )
    avail = np.asarray(
        [[o.cloud == c for o in options] for c in clouds], bool
    ).reshape(len(clouds), len(options))
    mask = torch.as_tensor(avail, device=al.device)
    od = torch.tensor(od_rate, dtype=torch.float32, device=al.device)
    return (
        torch.where(mask, al[None, :], od),
        torch.where(mask, be[None, :], od),
        avail,
    )


@dataclasses.dataclass
class PortfolioPlan:
    """A stacked-commitment plan, batched over leading row axes.

    Arrays are aligned with the input option list; options off the envelope
    get zero width.  ``levels[k]`` is the stack top of option k's band (==
    the bottom of the band when the width is zero)."""

    levels: torch.Tensor       # (..., K) band tops
    widths: torch.Tensor       # (..., K) band widths, >= 0
    total: torch.Tensor        # (...,)   stack top = on-demand threshold
    cost: torch.Tensor         # (...,)   objective value (cost-line dollars)


def _stack_heights(
    has: torch.Tensor, lo: torch.Tensor, widths: torch.Tensor, sentinel
) -> torch.Tensor:
    """Geometric stack tops from per-option band widths: cumulative widths
    in envelope depth order (ascending first-band index ``lo``; options off
    the envelope sort last via ``sentinel``), scattered back to input-option
    order.  The sorts are stable: options off the envelope tie at the
    sentinel and must keep input order, as the reference's do."""
    keys = torch.where(has, lo, torch.full_like(lo, sentinel))
    shape = torch.broadcast_shapes(widths.shape, keys.shape)
    order = torch.argsort(keys, dim=-1, stable=True).expand(shape)
    inv = torch.argsort(order, dim=-1, stable=True)
    w_ord = torch.gather(widths.expand(shape), -1, order)
    heights = torch.cumsum(w_ord, dim=-1)
    return torch.gather(heights, -1, inv)


def _band_assignment(
    t: int, alphas: torch.Tensor, betas: torch.Tensor, od_rate: float
) -> torch.Tensor:
    """(..., T) argmin option per capacity band; K = on-demand.

    Band j sits between sorted demand values j-1 and j, where exactly j of
    the T hours fall below it.  On-demand is column 0 so cost ties resolve
    to no commitment (argmin takes the first minimum)."""
    dev = alphas.device
    j = torch.arange(t, dtype=torch.float32, device=dev)[:, None]
    od = torch.full((t, 1), od_rate, dtype=torch.float32, device=dev)
    lines = torch.cat(
        [
            (od * (t - j)).expand(*alphas.shape[:-1], t, 1),
            alphas[..., None, :] * (t - j) + betas[..., None, :] * j,
        ],
        dim=-1,
    )  # (..., T, K+1); column 0 = on-demand
    return torch.argmin(lines, dim=-1)


def _exact_envelope(t, alphas, betas, od_rate):
    """Demand-independent half of the exact solver for lines (K,): per-band
    winner ``best`` (T,), per-option envelope membership ``has`` and first
    and last band ``lo``/``hi`` (K,), and the winning line's per-band
    cost coefficient ``line_best`` (T,)."""
    dev = alphas.device
    k = alphas.shape[-1]
    best = _band_assignment(t, alphas, betas, od_rate)        # (T,)
    opt = best - 1                                            # -1 = od
    bands = torch.arange(t, device=dev)
    mask = opt[None, :] == torch.arange(k, device=dev)[:, None]   # (K, T)
    has = mask.any(-1)
    hi = torch.where(mask, bands[None, :], -1).amax(-1)
    lo = torch.where(mask, bands[None, :], t + 1).amin(-1)
    jf = bands.to(torch.float32)
    alph_all = torch.cat([
        torch.tensor([od_rate], dtype=torch.float32, device=dev), alphas
    ])
    beta_all = torch.cat([
        torch.zeros(1, dtype=torch.float32, device=dev), betas
    ])
    line_best = alph_all[best] * (t - jf) + beta_all[best] * jf
    return opt, has, lo, hi, line_best


def optimal_portfolio_stack(
    f: torch.Tensor,
    alphas: torch.Tensor,
    betas: torch.Tensor,
    *,
    od_rate: float = 2.1,
) -> PortfolioPlan:
    """Exact minimizer of the stacked cost-line objective.  f (..., T).

    ``alphas``/``betas`` are shared (K,) lines or per-row (R, K) lines for
    f (R, T) — the batch the reference writes as a vmap.  The envelope is
    demand independent, so it is computed once per distinct line set (a
    fleet has one per cloud) and gathered onto the rows; per-row
    thresholds are gathers into sorted demand."""
    t = f.shape[-1]
    k = alphas.shape[-1]
    dev = f.device
    if alphas.dim() == 1:
        opt, has, lo, hi, line_best = _exact_envelope(
            t, alphas, betas, od_rate
        )
    else:
        lines = torch.cat([alphas, betas], dim=-1)
        uniq, inv = torch.unique(lines, dim=0, return_inverse=True)
        parts = [
            _exact_envelope(t, u[:k], u[k:], od_rate) for u in uniq
        ]
        opt, has, lo, hi, line_best = (
            torch.stack([p[i] for p in parts])[inv] for i in range(5)
        )

    sorted_f = torch.sort(f, dim=-1).values        # band j's top: sorted_f[j]
    lead = f.shape[:-1]

    def gather(idx):
        # sorted_f[..., idx] for idx (..., K); indices of options off the
        # envelope run past the end and are clamped: their widths are 0
        # whatever is gathered.
        idx = torch.clamp(idx, 0, t - 1).expand(*lead, k)
        return torch.gather(sorted_f, -1, idx)

    h = torch.diff(
        sorted_f, dim=-1, prepend=torch.zeros_like(sorted_f[..., :1])
    )
    covered = opt >= 0

    tops = gather(torch.clamp(hi, min=0))
    bottoms = torch.where(
        lo > 0, gather(torch.clamp(lo - 1, min=0)),
        torch.zeros((), dtype=f.dtype, device=dev),
    )
    widths = torch.where(has, tops - bottoms, 0.0)
    # The committed bands tile a prefix of the capacity axis, so cumulative
    # widths in envelope depth order ARE the geometric tops.
    heights = _stack_heights(has, lo, widths, t + 1)
    cost_committed = (h * line_best * covered).sum(-1)
    total = widths.sum(-1) + torch.zeros_like(f[..., 0])
    over = torch.clamp(f - total[..., None], min=0.0).sum(-1)
    cost = cost_committed + od_rate * over

    shape = lead + (k,)
    return PortfolioPlan(
        levels=heights.expand(shape),
        widths=widths.expand(shape),
        total=total,
        cost=cost,
    )


def portfolio_cost(
    f: torch.Tensor,
    levels: torch.Tensor,
    alphas: torch.Tensor,
    betas: torch.Tensor,
    *,
    od_rate: float = 2.1,
) -> torch.Tensor:
    """Cost-line objective of an arbitrary monotone stack.  f (..., T),
    levels (..., K) nondecreasing band tops *in stack order* (option k
    covers (levels[k-1], levels[k]]).  The brute-force test oracle."""
    prev = torch.cat(
        [torch.zeros_like(levels[..., :1]), levels[..., :-1]], dim=-1
    )
    fexp = f[..., None, :]                               # (..., 1, T)
    top = levels[..., :, None]
    bot = prev[..., :, None]
    used = torch.clamp(torch.minimum(fexp, top) - bot, min=0.0).sum(-1)
    width = levels - prev
    unused = width * f.shape[-1] - used
    over = torch.clamp(f - levels[..., -1:], min=0.0).sum(-1)
    return (alphas * used + betas * unused).sum(-1) + od_rate * over


def optimal_portfolio_grid(
    f: torch.Tensor,
    alphas: torch.Tensor,
    betas: torch.Tensor,
    *,
    od_rate: float = 2.1,
    num_grid: int = 256,
    use_kernel: bool = False,
    weights: torch.Tensor | None = None,
) -> PortfolioPlan:
    """Grid solver on the over/under sweep.

    One sweep over ``num_grid`` candidate levels per row (``max(f) x
    linspace(0, 1)``) yields exact per-cell used/idle integrals, the
    envelope picks the best option per cell (on-demand first, so it wins
    ties), and thresholds land on cell edges.

    The sweep always goes through ``ops.commitment_sweep_over_under``: on
    CUDA tensors that launches the hand-written CUDA kernel, whatever
    ``use_kernel`` says (the flag keeps the reference's spelling of a
    request; on the card there is no other sweep); on CPU tensors it runs
    the plain version.

    ``alphas``/``betas`` may be (K,) shared lines or (P, K) per-row lines.
    ``weights`` (P, T) masks or reweights hours — a 0/1 prefix mask turns
    the sweep into Algorithm 1's per-horizon prefix solve."""
    del use_kernel  # the device decides; see the docstring
    squeeze = f.dim() == 1
    if squeeze:
        f = f[None, :]
        if weights is not None and weights.dim() == 1:
            weights = weights[None, :]
    p, t = f.shape
    k = alphas.shape[-1]
    dev = f.device
    al = torch.atleast_2d(alphas).expand(p, k)
    be = torch.atleast_2d(betas).expand(p, k)
    w = torch.ones_like(f) if weights is None else weights.to(f.dtype)

    grid = linspace(0.0, 1.0, num_grid, device=dev)
    cs = f.amax(-1, keepdim=True) * grid[None, :]        # (P, G) per row
    over, under = sweep_ops.commitment_sweep_over_under(f, cs, w)

    used = over[:, :-1] - over[:, 1:]                    # (P, G-1) cell ints
    idle = under[:, 1:] - under[:, :-1]
    cell_cost = torch.cat(
        [
            (od_rate * used)[:, None, :],
            al[:, :, None] * used[:, None, :]
            + be[:, :, None] * idle[:, None, :],
        ],
        dim=1,
    )  # (P, K+1, G-1); index 0 = on-demand (first wins ties)
    best = torch.argmin(cell_cost, dim=1) - 1            # (P, G-1)

    cells = torch.arange(num_grid - 1, device=dev)
    mask = best[:, None, :] == torch.arange(k, device=dev)[None, :, None]
    has = mask.any(-1)
    hi = torch.where(mask, cells[None, None, :], -1).amax(-1)    # (P, K)
    lo = torch.where(mask, cells[None, None, :], num_grid).amin(-1)
    tops = torch.gather(cs, -1, torch.clamp(hi + 1, min=0))
    bottoms = torch.gather(cs, -1, torch.clamp(lo, 0, num_grid - 1))
    widths = torch.where(has, tops - bottoms, 0.0)
    heights = _stack_heights(has, lo, widths, num_grid)
    cost = cell_cost.amin(dim=1).sum(-1)

    plan = PortfolioPlan(
        levels=heights, widths=widths, total=widths.sum(-1), cost=cost
    )
    if squeeze:
        plan = PortfolioPlan(
            levels=plan.levels[0], widths=plan.widths[0],
            total=plan.total[0], cost=plan.cost[0],
        )
    return plan


def handover_fractiles(
    alphas: torch.Tensor,
    betas: torch.Tensor,
    *,
    od_rate: float = 2.1,
    resolution: int = 4096,
) -> torch.Tensor:
    """(..., K) utilization fractile u*_k where option k hands over to the
    next envelope occupant; 0.0 marks options off the envelope.  These are
    the per-option critical fractiles: option k's optimal threshold on any
    demand curve is its weighted u*_k-quantile.  Lines may be (K,) or
    batched (..., K)."""
    dev = alphas.device
    k = alphas.shape[-1]
    u = linspace(0.0, 1.0, resolution, device=dev)       # (R,)
    lines = torch.cat(
        [
            (od_rate * (1.0 - u))[:, None].expand(
                *alphas.shape[:-1], resolution, 1
            ),
            alphas[..., None, :] * (1.0 - u)[:, None]
            + betas[..., None, :] * u[:, None],
        ],
        dim=-1,
    )                                                     # (..., R, K+1)
    best = torch.argmin(lines, dim=-1) - 1                # (..., R)
    mask = best[..., None, :] == torch.arange(k, device=dev)[:, None]
    hi = torch.where(mask, u, -1.0).amax(-1)              # (..., K)
    return torch.where(hi >= 0, hi, 0.0)


@dataclasses.dataclass
class PortfolioSpend:
    """Real-dollar accounting of a stack over an evaluation window.

    ``spot`` is the expected-rate bill of the demand above the spot floor
    (0.0 on spot-free plans); ``spot_chip_hours`` the volume that rode
    spot."""

    committed: np.ndarray         # (K,) committed spend per option
    on_demand: float
    total: float
    all_on_demand: float
    savings_vs_on_demand: float
    spot: float = 0.0
    spot_chip_hours: float = 0.0


def portfolio_spends(
    f: torch.Tensor,
    widths: torch.Tensor,
    options: Sequence[PurchaseOption],
    *,
    od_rate: float = 2.1,
    spot_rate: torch.Tensor | None = None,
    spot_floor: torch.Tensor | None = None,
    level_offset: torch.Tensor | None = None,
) -> list[PortfolioSpend]:
    """:func:`portfolio_spend` for P rows at once: f (P, T) demand and
    widths (P, K) stacks on one device; ``spot_rate``, ``spot_floor`` and
    ``level_offset`` are None or (P,).

    The over-integrals sum_t max(f - level, 0) of all rows (and, with a
    spot band, above each floor) are one commitment sweep: on the card one
    kernel launch, whose order-free integer sums make it equal to a launch
    per row, bit for bit.  The sums and widths then come to the host in one
    copy, and the dollars are host float64 arithmetic, as in the
    reference."""
    num_rows, t = f.shape
    level = widths.sum(-1)
    if level_offset is not None:
        level = level + torch.as_tensor(level_offset, dtype=f.dtype,
                                        device=f.device)
    cs = [level]
    if spot_rate is not None:
        floor = torch.as_tensor(spot_floor, dtype=f.dtype, device=f.device)
        # A floor above the row's peak (an infinite one included) bills no
        # spot; capping it there keeps the candidates finite for the sweep.
        cs.append(torch.minimum(torch.maximum(floor, level), f.amax(-1)))
    over, _ = sweep_ops.commitment_sweep_over_under(
        f, torch.stack(cs, dim=-1)
    )                                                     # (P, 1 or 2)
    host = torch.cat(
        [widths.to(f.dtype), over, f.sum(-1, keepdim=True)], dim=-1
    ).cpu().numpy()
    k = widths.shape[-1]
    w_np, over_np, f_sum = host[:, :k], host[:, k:-1], host[:, -1]
    rates = np.asarray([o.rate for o in options])
    s_rate = (None if spot_rate is None
              else torch.as_tensor(spot_rate).cpu().numpy())
    out = []
    for p in range(num_rows):
        committed = rates * w_np[p] * t
        over_p = float(over_np[p, 0])
        spot_vol = spot_cost = 0.0
        if s_rate is not None:
            spot_vol = float(over_np[p, 1])
            spot_cost = float(s_rate[p]) * spot_vol
            over_p = max(over_p - spot_vol, 0.0)
        od = od_rate * over_p
        all_od = od_rate * float(f_sum[p])
        total = float(committed.sum()) + od + spot_cost
        out.append(PortfolioSpend(
            committed=committed,
            on_demand=od,
            total=total,
            all_on_demand=all_od,
            # A pool can sit empty over the window (e.g. its training job
            # ended): no demand means nothing to save on.
            savings_vs_on_demand=1.0 - total / all_od if all_od > 0 else 0.0,
            spot=spot_cost,
            spot_chip_hours=spot_vol,
        ))
    return out


def portfolio_spend(
    f: torch.Tensor,
    widths,
    options: Sequence[PurchaseOption],
    *,
    od_rate: float = 2.1,
    spot_rate: float | None = None,
    spot_floor: float | None = None,
    level_offset: float = 0.0,
) -> PortfolioSpend:
    """In-window dollars of one stack on demand f (T,): every active tranche
    bills its committed rate for all hours; demand above the stack pays
    on-demand, except that with a spot band (``spot_rate``/``spot_floor``)
    demand above the floor bills at the effective spot rate instead.

    ``level_offset`` lifts the serving level above the stack without
    billing here (a convertible allocation re-pinned onto the pool).
    Runs on ``f``'s device; one row of :func:`portfolio_spends`."""
    widths = torch.as_tensor(widths, dtype=f.dtype, device=f.device)

    def row(x):
        return None if x is None else torch.tensor([x], dtype=torch.float64)

    return portfolio_spends(
        f[None], widths[None], options, od_rate=od_rate,
        spot_rate=row(spot_rate), spot_floor=row(spot_floor),
        level_offset=torch.tensor([level_offset], dtype=torch.float64),
    )[0]
