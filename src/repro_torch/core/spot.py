"""Spot capacity as a portfolio line: effective cost + chance constraint.

Spot capacity bills like on-demand (pay only while used) at a deep
discount, but the slice can be revoked at any hour
(``capacity.preemption``).  Folding the revocation risk into the used rate
gives, per chip-hour of demand routed to the spot band,

    eff = a * (spot_rate * price + hazard * requeue_hours * od_rate)
          + (1 - a) * od_rate

with ``a`` the availability, ``spot_rate = (1 - discount) * od_rate``,
``price`` the mean price multiplier, the expected recompute of each
revocation redone at on-demand, and the on-demand fallback while revoked.
So spot is one more cost line l(u) = eff * (1 - u) (alpha = eff, beta =
0) beside the committed lines.  What keeps the portfolio honest is the
chance constraint: a fraction x of a pool's demand volume on spot leaves
demand-weighted availability 1 - x (1 - a), and requiring it >=
``availability_target`` caps x (:func:`spot_cap_fraction`).  The solvers
(``portfolio.optimal_portfolio_stack``/``grid`` and the planners' prefix
floors) hand spot the top of the demand distribution, truncated at that
volume cap.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.capacity import preemption as pe
from repro_torch.device import resolve_device
from repro_torch.numerics import linspace


@dataclasses.dataclass(frozen=True)
class SpotConfig:
    """Knobs of the spot subsystem (the reference's fields and defaults).

    ``availability_target`` is the chance-constraint floor on demand-
    weighted availability; ``risk_buffer`` backs the resulting volume cap
    off.  ``num_draws`` > 0 estimates the effective rate from simulated
    revocation paths (``sim_hours`` hours, a generator seeded ``seed``)
    instead of the analytic stationary distribution."""

    availability_target: float = 0.95
    requeue_hours: float = 2.0
    risk_buffer: float = 0.2
    num_draws: int = 0            # 0 = analytic stationary distribution
    sim_hours: int = 24 * 7 * 8
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class SpotLines:
    """The spot line per pool, (P,) float32 tensors on one device.

    ``rate`` is alpha of the cost line (beta = 0); ``cap`` the chance-
    constrained demand-volume fraction; ``market_rate`` the raw (1 -
    discount) * od rate billed per served spot chip-hour; ``availability``
    the availability the cap was derived from."""

    rate: torch.Tensor
    cap: torch.Tensor
    market_rate: torch.Tensor
    availability: torch.Tensor
    params: pe.PreemptionParams

    def to(self, device) -> "SpotLines":
        return SpotLines(
            rate=self.rate.to(device), cap=self.cap.to(device),
            market_rate=self.market_rate.to(device),
            availability=self.availability.to(device),
            params=self.params.to(device),
        )


def spot_cap_fraction(
    availability: torch.Tensor,
    target: float,
    *,
    risk_buffer: float = 0.0,
) -> torch.Tensor:
    """Chance-constrained cap on the demand fraction a pool may serve from
    spot: x <= (1 - target) / (1 - availability), backed off by
    ``risk_buffer`` and clipped to [0, 1]."""
    if not 0.0 < target <= 1.0:
        raise ValueError(f"availability_target must be in (0, 1], {target}")
    short = torch.clamp(1.0 - availability, min=1e-9)
    return torch.clamp((1.0 - target) / short * (1.0 - risk_buffer),
                       0.0, 1.0)


def effective_spot_rate(
    params: pe.PreemptionParams,
    *,
    od_rate: float,
    requeue_hours: float,
    availability: torch.Tensor | None = None,
    hazard: torch.Tensor | None = None,
    price: torch.Tensor | float = 1.0,
) -> torch.Tensor:
    """(P,) effective $/demanded-chip-hour of the spot band (module
    docstring formula).  ``availability``/``hazard``/``price`` default to
    the analytic process constants."""
    a = (availability if availability is not None
         else pe.stationary_availability(params))
    lam = hazard if hazard is not None else params.hazard
    spot_rate = (1.0 - params.discount) * od_rate
    serving = spot_rate * price + lam * requeue_hours * od_rate
    return a * serving + (1.0 - a) * od_rate


def _path_estimates(paths: pe.RevocationPaths):
    """(availability, hazard, price) (P,) estimated from sampled paths:
    mean availability, revocations per available hour, and the mean price
    multiplier over available hours."""
    avail = paths.available.mean((0, 2))
    up_hours = torch.clamp(paths.available.sum((0, 2)), min=1.0)
    hazard = paths.interrupted.sum((0, 2)) / up_hours
    price = (paths.price * paths.available).sum((0, 2)) / up_hours
    return avail, hazard, price


def _lines(params, cfg: SpotConfig, od_rate: float, avail, hazard, price):
    rate = effective_spot_rate(
        params, od_rate=od_rate, requeue_hours=cfg.requeue_hours,
        availability=avail, hazard=hazard, price=price,
    )
    cap = spot_cap_fraction(
        avail, cfg.availability_target, risk_buffer=cfg.risk_buffer
    )
    return SpotLines(
        rate=rate,
        cap=torch.where(rate < od_rate, cap, 0.0),
        market_rate=(1.0 - params.discount) * od_rate,
        availability=avail,
        params=params,
    )


def pool_spot_lines(
    clouds,
    *,
    od_rate: float,
    cfg: SpotConfig = SpotConfig(),
    markets=None,
    device=None,
) -> SpotLines:
    """The per-pool spot line for a fleet on ``clouds``, on ``device``
    (``None`` is the card).

    Analytic by default; with ``cfg.num_draws`` > 0 the availability,
    interruption rate and mean price multiplier are estimated from that
    many simulated revocation paths of ``cfg.sim_hours`` hours, drawn from
    a generator on ``device`` seeded ``cfg.seed``.  Pools whose effective
    rate is not below on-demand get cap 0."""
    params = pe.params_for_clouds(clouds, markets, device=device)
    if cfg.num_draws > 0:
        gen = torch.Generator(device=params.hazard.device)
        gen.manual_seed(cfg.seed)
        paths = pe.simulate_revocations(
            params, cfg.sim_hours, num_draws=cfg.num_draws, generator=gen)
        avail, hazard, price = _path_estimates(paths)
    else:
        avail = pe.stationary_availability(params)
        hazard, price = params.hazard, 1.0
    return _lines(params, cfg, od_rate, avail, hazard, price)


def spot_entry_fractile(
    alphas: torch.Tensor,
    betas: torch.Tensor,
    spot_rate: torch.Tensor,
    *,
    od_rate: float,
    resolution: int = 4096,
) -> torch.Tensor:
    """Utilization fractile where the spot line enters the lower envelope
    of [on-demand, committed options, spot]: below it some committed line
    is cheaper, above it spot wins (1.0 when spot never wins).

    Lines (K,) with a scalar rate give a 0-d result; (P, K) with (P,)
    rates give (P,), computed once per distinct line set (a fleet has one
    per cloud) and gathered back.  ``argmin`` takes the first of tied
    lines, so a rate tie never hands a fractile to spot."""
    spot_rate = torch.as_tensor(spot_rate, dtype=torch.float32,
                                device=alphas.device)
    if alphas.dim() == 1:
        return _entry_fractile(alphas, betas, spot_rate, od_rate,
                               resolution)
    rows = torch.cat([alphas, betas, spot_rate[:, None]], dim=-1)
    uniq, inv = torch.unique(rows, dim=0, return_inverse=True)
    k = alphas.shape[-1]
    per_set = torch.stack([
        _entry_fractile(u[:k], u[k:2 * k], u[2 * k], od_rate, resolution)
        for u in uniq
    ])
    return per_set[inv]


def _entry_fractile(alphas, betas, spot_rate, od_rate, resolution):
    u = linspace(0.0, 1.0, resolution, device=alphas.device)
    lines = torch.cat(
        [
            (od_rate * (1.0 - u))[:, None],
            alphas[None, :] * (1.0 - u)[:, None] + betas[None, :] * u[:, None],
            (spot_rate * (1.0 - u))[:, None],
        ],
        dim=1,
    )
    wins = torch.argmin(lines, dim=1) == lines.shape[1] - 1
    return torch.where(wins.any(), torch.where(wins, u, 2.0).amin(), 1.0)


def resolve_spot(
    spot,
    clouds,
    *,
    od_rate: float,
    device=None,
) -> tuple[SpotConfig, SpotLines] | None:
    """Normalize the planner-facing ``spot=`` argument: None/False disables
    (the spot-free path), True takes the default :class:`SpotConfig`, a
    SpotConfig builds its lines on ``device``, and a prebuilt (SpotConfig,
    SpotLines) pair passes through, its lines moved to ``device``."""
    if spot is None or spot is False:
        return None
    if spot is True:
        spot = SpotConfig()
    if isinstance(spot, SpotConfig):
        return spot, pool_spot_lines(clouds, od_rate=od_rate, cfg=spot,
                                     device=device)
    if (
        not isinstance(spot, tuple)
        or len(spot) != 2
        or not isinstance(spot[0], SpotConfig)
        or not isinstance(spot[1], SpotLines)
    ):
        raise TypeError(
            "spot must be None/bool/SpotConfig/(SpotConfig, SpotLines), "
            f"got {spot!r}"
        )
    return spot[0], spot[1].to(resolve_device(device))


def expected_availability(
    spot_frac: torch.Tensor, availability: torch.Tensor
) -> torch.Tensor:
    """Demand-weighted availability when ``spot_frac`` of a pool's demand
    volume rides capacity that is up ``availability`` of the time."""
    return 1.0 - spot_frac * (1.0 - availability)
