"""Demand-driver decomposition and share-based forecasting (paper §2.3).

The inference side of generation turnover (the generative side is
``repro_torch.capacity.generations``): fit the three drivers that compose
demand,

    per-pool VM demand = fleet user growth x family adoption share
                         x software efficiency,

and forecast *family share x pair total* instead of raw per-pool traces.
The pair total in old-equivalent units (old + (1 + uplift) x successor) is
turnover-invariant, so the structural forecaster fits a stable series; the
turnover itself is a 2-parameter logistic share fit, weighted least
squares on the logit, which is linear in time for a logistic adoption
curve.

Everything is prefix-sum friendly, so the rolling replay re-fits both
pieces every week: the pair-total rows ride ``forecast.prefix_fit_state``,
and the share fit keeps five cumulative weekly moment sums per edge
(:class:`SharePrefixState`, one gather and a closed-form 2x2 solve a
week).  Float32 throughout, as in the reference; tensors live on the
edges' device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.capacity import generations as gn
from repro_torch.core import demand as dm
from repro_torch.core import forecast as fc
from repro_torch.core.demand import HOURS_PER_WEEK

# Observed shares are clipped into [SHARE_EPS, 1 - SHARE_EPS] before the
# logit: a successor pool with no demand is "not launched yet", not
# infinitely unlaunched.
SHARE_EPS = 1e-5
_RIDGE = 1e-6


def share_observations(
    demand: torch.Tensor, edges: gn.MigrationEdges
) -> tuple[torch.Tensor, torch.Tensor]:
    """(z, w) each (G, T): per-edge logit of the successor's share of the
    pair total in old-equivalent units, and its logistic-regression weight
    s(1 - s), near zero where the share pins to a clipped extreme."""
    d = demand.to(torch.float32)
    old = d[edges.src]                                   # (G, T)
    new_adj = d[edges.dst] * (1.0 + edges.uplift[:, None])
    total = old + new_adj
    s = torch.where(total > 0, new_adj / torch.clamp(total, min=1e-12), 0.0)
    s = torch.clamp(s, SHARE_EPS, 1.0 - SHARE_EPS)
    z = torch.log(s) - torch.log1p(-s)
    return z, s * (1.0 - s)


def _wls_line(sw, swt, swt2, swz, swtz):
    """Weighted least-squares line z ~ a + b t from the five moment sums
    (broadcasts over any leading axes)."""
    denom = sw * swt2 - swt * swt + _RIDGE
    b = (sw * swtz - swt * swz) / denom
    a = (swz - b * swt) / torch.clamp(sw, min=1e-9)
    return a, b


def _prior_moments(
    edges: gn.MigrationEdges, t_max: float, weight: float
) -> torch.Tensor:
    """(G, 5) pseudo-observation moments encoding the successor table's
    announced S-curve as a prior on the logit-share line: two points of
    total weight ``weight`` at normalized times 0 and 1 on the table's line
    z(t) = rate (t - midpoint).  Before launch every real observation sits
    at a clipped extreme with weight ~ 0, so the prior is the fit; once
    adoption is under way the data outweigh it."""
    b0 = edges.rate_per_hour * t_max
    a0 = -edges.rate_per_hour * edges.midpoint_hours
    half = weight / 2.0
    return torch.stack(
        [
            torch.full_like(a0, weight),         # sum w
            torch.full_like(a0, half),           # sum w t   (t in {0, 1})
            torch.full_like(a0, half),           # sum w t^2
            half * (2.0 * a0 + b0),              # sum w z
            half * (a0 + b0),                    # sum w t z
        ],
        dim=-1,
    )


def fit_share(
    demand: torch.Tensor,
    edges: gn.MigrationEdges,
    *,
    t_max: float,
    prior_weight: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(a, b) each (G,): full-window logit-share line fits, time normalized
    by ``t_max`` (the forecaster's trend clock), so the predicted share is
    sigmoid(a + b t / t_max).  ``prior_weight`` blends in the table's
    announced adoption curve (:func:`_prior_moments`)."""
    z, w = share_observations(demand, edges)
    t = torch.arange(z.shape[-1], dtype=torch.float32,
                     device=z.device) / t_max
    sums = [
        w.sum(-1),
        (w * t).sum(-1),
        (w * t * t).sum(-1),
        (w * z).sum(-1),
        (w * t * z).sum(-1),
    ]
    if prior_weight > 0:
        prior = _prior_moments(edges, t_max, prior_weight)
        sums = [s + prior[:, i] for i, s in enumerate(sums)]
    return _wls_line(*sums)


def predict_share(
    a: torch.Tensor, b: torch.Tensor, t_hours, t_max: float
) -> torch.Tensor:
    """(G, H) logistic share forecast at absolute hours ``t_hours``."""
    ts = torch.as_tensor(t_hours, device=a.device).to(torch.float32) / t_max
    return torch.sigmoid(a[:, None] + b[:, None] * ts[None, :])


def transform_for_fit(
    demand: torch.Tensor, edges: gn.MigrationEdges
) -> torch.Tensor:
    """Replace each edge's old-family row by the pair total in
    old-equivalent units, the turnover-invariant series the structural
    forecaster fits.  Successor rows are left as they are (their fits are
    overwritten by the share composition)."""
    d = demand.to(torch.float32)
    out = d.clone()
    out[edges.src] = d[edges.src] + d[edges.dst] * (
        1.0 + edges.uplift[:, None])
    return out


def compose_forecast(
    yhat_total: torch.Tensor,
    shares: torch.Tensor,
    edges: gn.MigrationEdges,
) -> torch.Tensor:
    """Recombine pair-total forecasts (P, H) with share forecasts (G, H)
    into per-pool forecasts: the old family keeps (1 - s) of the pair
    total, the successor serves s of it at 1/(1 + uplift) VMs per
    old-equivalent unit."""
    tot = yhat_total[edges.src]                          # (G, H)
    y = yhat_total.clone()
    y[edges.src] = (1.0 - shares) * tot
    y[edges.dst] = shares * tot * edges.inv_gain[:, None]
    return y


@dataclasses.dataclass
class SharePrefixState:
    """Cumulative weekly moment sums for rolling logit-share re-fits:
    ``cum[g, w]`` holds [sum w, sum w t, sum w t^2, sum w z, sum w t z]
    over the first w+1 whole weeks of edge g's share observations (time
    normalized by ``t_max``), so a week's share fit is one gather and a
    closed-form 2x2 solve."""

    cum: torch.Tensor      # (G, W, 5)
    t_max: float           # the forecast state's time normalization


def share_prefix_state(
    demand: torch.Tensor,
    edges: gn.MigrationEdges,
    *,
    t_max: float,
    period_hours: int = HOURS_PER_WEEK,
    prior_weight: float = 0.0,
) -> SharePrefixState:
    """The rolling share-fit state of a (P, T) fleet (T truncated to whole
    periods, as ``forecast.prefix_fit_state`` does).  The prior moments
    ride inside every prefix."""
    z, w = share_observations(demand, edges)
    g = z.shape[0]
    num_weeks = z.shape[-1] // period_hours
    t_hist = num_weeks * period_hours
    t = torch.arange(t_hist, dtype=torch.float32, device=z.device) / t_max
    z, w = z[:, :t_hist], w[:, :t_hist]
    moments = torch.stack([w, w * t, w * t * t, w * z, w * t * z], dim=-1)
    weekly = moments.reshape(g, num_weeks, period_hours, 5).sum(2)
    cum = torch.cumsum(weekly, dim=1)
    if prior_weight > 0:
        cum = cum + _prior_moments(edges, t_max, prior_weight)[:, None, :]
    return SharePrefixState(cum=cum, t_max=float(t_max))


def solve_share_prefix(
    state: SharePrefixState, week: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """(a, b) each (G,) fit on the prefix of ``week`` whole periods
    (``week`` >= 1)."""
    c = state.cum[:, week - 1]                           # (G, 5)
    return _wls_line(c[:, 0], c[:, 1], c[:, 2], c[:, 3], c[:, 4])


@dataclasses.dataclass
class EdgeFit:
    """One fitted turnover edge, reported in table units."""

    cloud: str
    region: str
    old_family: str
    new_family: str
    uplift: float
    midpoint_weeks: float    # fitted 50%-adoption epoch
    span_weeks: float        # fitted 10%->90% width
    final_share: float       # fitted share at the end of the window


@dataclasses.dataclass
class DriverDecomposition:
    """The three fitted demand drivers of a realized fleet.

    ``edge_fits`` carry the per-family logistic turnover; ``fleet_model``
    is the structural fit of the hardware-corrected fleet total (user
    growth x software efficiency, the turnover driver removed);
    ``efficiency_per_year`` separates the software driver out of that
    product when an independent user-volume series was supplied, else
    None.  ``hardware_index`` is the realized VM-count multiplier of
    turnover: raw fleet total over old-equivalent total."""

    keys: tuple[dm.PoolKey, ...]
    edges: gn.MigrationEdges
    share_a: np.ndarray            # (G,) logit intercepts (t / t_max clock)
    share_b: np.ndarray            # (G,) logit slopes
    t_max: float
    edge_fits: list[EdgeFit]
    fleet_model: fc.ForecastModel
    hardware_index: np.ndarray     # (T,)
    efficiency_per_year: float | None
    growth_per_year: float | None  # user-volume trend when supplied

    def predicted_shares(self, t_hours) -> np.ndarray:
        return predict_share(
            torch.from_numpy(self.share_a), torch.from_numpy(self.share_b),
            t_hours, self.t_max,
        ).numpy()


def _log_slope_per_year(series: np.ndarray) -> float:
    """OLS slope of log(series) per year of hours (host float64)."""
    y = np.log(np.maximum(np.asarray(series, np.float64), 1e-12))
    t = np.arange(y.shape[-1], dtype=np.float64) / gn.HOURS_PER_YEAR
    t = t - t.mean()
    return float((t * (y - y.mean())).sum() / np.maximum((t * t).sum(), 1e-12))


def _sigmoid64(x: float) -> float:
    return float(1.0 / (1.0 + np.exp(-x)))


def decompose_drivers(
    pools: dm.PoolSet,
    *,
    migration=True,
    user_volume: np.ndarray | None = None,
    cfg: fc.ForecastConfig = fc.ForecastConfig(),
    device: "torch.device | str | None" = None,
) -> DriverDecomposition:
    """Fit the three-driver decomposition to a realized fleet on ``device``
    (``None`` = the card).

    ``migration`` supplies the successor *structure* (which family pairs
    can turn over, and their uplifts); the adoption epochs are fitted from
    the data, never read from the table.  ``user_volume`` (T,) is an
    independent demand-driver series (old-equivalent VM units): with it
    the software-efficiency drift is the log-slope of the corrected VM
    total over user volume; without it user growth and efficiency stay
    folded into ``fleet_model``'s trend."""
    mig = gn.resolve_migration(migration)
    if mig is None:
        raise ValueError(
            "decompose_drivers needs a successor structure; pass "
            "migration=True (pricing.GENERATIONS) or a MigrationConfig"
        )
    edges = gn.migration_edges(pools.keys, mig, device=device)
    demand = torch.from_numpy(pools.demand).to(edges.device)
    t_hist = pools.num_hours
    t_max = float(max(t_hist - 1, 1))

    a, b = fit_share(demand, edges, t_max=t_max)
    a_np, b_np = a.cpu().numpy(), b.cpu().numpy()
    a64, b64 = a_np.astype(np.float64), b_np.astype(np.float64)
    src_np, dst_np = edges.src.cpu().numpy(), edges.dst.cpu().numpy()
    up_np = edges.uplift.cpu().numpy().astype(np.float64)
    edge_fits = []
    for g in range(edges.num_edges):
        rate_hr = b64[g] / t_max                   # logit slope per hour
        wk = HOURS_PER_WEEK
        flat = abs(rate_hr) <= 1e-12
        key_old, key_new = pools.keys[src_np[g]], pools.keys[dst_np[g]]
        edge_fits.append(EdgeFit(
            cloud=key_old[0], region=key_old[1],
            old_family=key_old[2], new_family=key_new[2],
            uplift=float(up_np[g]),
            midpoint_weeks=np.inf if flat else float(-a64[g] / rate_hr / wk),
            span_weeks=(np.inf if flat
                        else float(gn._LOGISTIC_1090 / rate_hr / wk)),
            final_share=_sigmoid64(a64[g] + b64[g] * (t_hist - 1) / t_max),
        ))

    # Hardware-corrected fleet total: successors counted at (1 + uplift)
    # VMs of old-equivalent work, the turnover driver divided out.
    perf = np.ones(pools.num_pools, np.float64)
    perf[dst_np] = 1.0 + up_np
    corrected = (pools.demand.astype(np.float64) * perf[:, None]).sum(0)
    raw_total = pools.demand.sum(0)
    fleet_model = fc.fit(
        torch.from_numpy(corrected.astype(np.float32)).to(edges.device), cfg)
    hardware_index = raw_total / np.maximum(corrected, 1e-12)

    efficiency = growth = None
    if user_volume is not None:
        user_volume = np.asarray(user_volume, np.float64)
        if user_volume.shape[-1] != t_hist:
            raise ValueError(
                f"user_volume length {user_volume.shape[-1]} != "
                f"{t_hist} fleet hours"
            )
        # corrected / user = (1 + r)^(-t/yr): the slope recovers the drift.
        slope = _log_slope_per_year(
            corrected / np.maximum(user_volume, 1e-12)
        )
        efficiency = float(np.expm1(-slope))
        growth = float(np.expm1(_log_slope_per_year(user_volume)))

    return DriverDecomposition(
        keys=pools.keys,
        edges=edges,
        share_a=a_np,
        share_b=b_np,
        t_max=t_max,
        edge_fits=edge_fits,
        fleet_model=fleet_model,
        hardware_index=np.asarray(hardware_index, np.float32),
        efficiency_per_year=efficiency,
        growth_per_year=growth,
    )
