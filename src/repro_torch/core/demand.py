"""Demand traces for cloud compute pools (paper §2): the calibrated
synthetic generator and the (P, T) fleet container the planner consumes.

The deterministic profile (trend x diurnal/weekly cycle x holiday dip) is
the reference's float32 arithmetic op for op.  The AR(1) noise draws from
a seeded CPU ``torch.Generator``, so one seed gives one fleet on any
machine; its draws differ from ``jax.random``'s, so the two packages agree
on the noise's distribution, not its bits.  ``PoolSet.demand`` stays a
numpy array: data is device-free and the planner moves it onto its device.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

HOURS_PER_DAY = 24
HOURS_PER_WEEK = 24 * 7
DAYS_PER_YEAR = 365

#: AR(1) noise memory per hour.
AR_COEF = 0.95
#: Block length of the AR(1) filter (see ``_ar1``).
_AR_BLOCK = 256


@dataclasses.dataclass(frozen=True)
class DemandConfig:
    """Parameters of the synthetic demand model, calibrated to paper §2.2/§3.3.

    Defaults reproduce the published dataset statistics:
      * annual growth  ~58%  (paper: 3.9x over 3 years = 57.5%/yr)
      * diurnal peak/trough ~1.34x   (paper §2.2: daily max 34% above min)
      * weekly  peak/trough ~1.35x   (paper §2.2: weekly max 35% above min)
      * holiday (Dec 24 - Jan 1) drop ~8%  (paper §3.3.2)
      * lag-7 daily autocorrelation ~0.975 (paper §2.2)
    """

    base_level: float = 100.0
    annual_growth: float = 0.58
    diurnal_amplitude: float = 0.145  # -> ~1.34x daily max/min
    weekly_amplitude: float = 0.15    # weekend dip -> ~1.35x weekly max/min
    holiday_drop: float = 0.08
    noise_sigma: float = 0.01
    # Day-of-year (0-based) at which the holiday window starts (Dec 24).
    holiday_start_day: int = 357
    holiday_len_days: int = 9


def _periodic_profile(t_hours: torch.Tensor, cfg: DemandConfig) -> torch.Tensor:
    """Multiplicative diurnal x weekly profile, mean ~1.0: business-hours
    bump on weekdays, weekend dip (the paper's Fig 2(B) shape)."""
    hour_of_day = torch.remainder(t_hours, HOURS_PER_DAY)
    day_of_week = torch.remainder(
        torch.div(t_hours, HOURS_PER_DAY, rounding_mode="floor"), 7
    )
    diurnal = 1.0 + cfg.diurnal_amplitude * torch.cos(
        2.0 * math.pi * (hour_of_day - 15.0) / HOURS_PER_DAY
    )
    is_weekend = (day_of_week >= 5).to(torch.float32)
    weekly = 1.0 + cfg.weekly_amplitude * (0.4 - is_weekend)
    return diurnal * weekly


def _holiday_mask(t_hours: torch.Tensor, cfg: DemandConfig) -> torch.Tensor:
    day_of_year = torch.remainder(
        torch.div(t_hours, HOURS_PER_DAY, rounding_mode="floor"),
        DAYS_PER_YEAR,
    )
    in_window = (day_of_year >= cfg.holiday_start_day) & (
        day_of_year < cfg.holiday_start_day + cfg.holiday_len_days
    )
    return in_window.to(torch.float32)


def _ar1(eps: torch.Tensor, sigma: float) -> torch.Tensor:
    """x_t = AR_COEF x_{t-1} + sigma eps_t from x_{-1} = 0, in float64.

    Hours are cut into blocks of ``_AR_BLOCK``.  Inside a block the filter
    is the closed form x_i = a^i (carry a + sum_{k<=i} a^-k sigma eps_k),
    one cumsum; the blocks then chain through a loop that carries one
    scalar.  Elementwise ops and a sequential cumsum only, so the result
    does not depend on a BLAS build."""
    n = eps.shape[-1]
    nb = -(-n // _AR_BLOCK)
    e = torch.zeros(nb * _AR_BLOCK, dtype=torch.float64)
    e[:n] = eps.to(torch.float64) * sigma
    e = e.reshape(nb, _AR_BLOCK)
    i = torch.arange(_AR_BLOCK, dtype=torch.float64)
    grow = AR_COEF ** i                                   # a^i
    local = torch.cumsum(e / grow, dim=-1) * grow         # zero-carry blocks
    decay = AR_COEF * grow                                # a^(i+1)
    out = torch.empty_like(local)
    carry = torch.zeros((), dtype=torch.float64)
    for b in range(nb):
        out[b] = local[b] + decay * carry
        carry = out[b, -1]
    return out.reshape(-1)[:n]


def synth_demand(
    num_hours: int,
    cfg: DemandConfig = DemandConfig(),
    *,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Hourly VM-demand trace of length ``num_hours`` (CPU float32, >= 0).

    With a ``generator`` (a seeded CPU ``torch.Generator``) the trace
    carries multiplicative AR(1) noise, smooth like aggregate workload
    jitter; without one it is the deterministic profile."""
    t = torch.arange(num_hours, dtype=torch.float32)
    years = t / (DAYS_PER_YEAR * HOURS_PER_DAY)
    trend = cfg.base_level * torch.pow(
        torch.tensor(1.0 + cfg.annual_growth, dtype=torch.float32), years
    )
    profile = _periodic_profile(t, cfg)
    holiday = 1.0 - cfg.holiday_drop * _holiday_mask(t, cfg)
    demand = trend * profile * holiday
    if generator is not None:
        eps = torch.randn(
            num_hours, generator=generator, dtype=torch.float32
        )
        ar = _ar1(eps, cfg.noise_sigma).to(torch.float32)
        demand = demand * (1.0 + ar)
    return torch.clamp(demand, min=0.0)


# (cloud, region, machine_family) — the key the released dataset uses.
PoolKey = tuple[str, str, str]


@dataclasses.dataclass(frozen=True)
class PoolSet:
    """An aligned multi-pool fleet: demand matrix (P, T) with labelled rows.

    Row p of ``demand`` is the hourly trace of pool ``keys[p]``; every row
    shares one hourly time axis, so a PoolSet stacks into the (P, T) batch
    the planner and the commitment sweep consume."""

    keys: tuple[PoolKey, ...]
    demand: np.ndarray                          # (P, T) float32, hourly
    configs: tuple[DemandConfig, ...] | None = None   # per-pool synth params

    def __post_init__(self):
        demand = np.asarray(self.demand, np.float32)
        if demand.ndim != 2:
            raise ValueError(f"demand must be (P, T), got {demand.shape}")
        if len(self.keys) != demand.shape[0]:
            raise ValueError(
                f"{len(self.keys)} keys for {demand.shape[0]} demand rows"
            )
        if self.configs is not None and len(self.configs) != len(self.keys):
            raise ValueError(
                f"{len(self.configs)} configs for {len(self.keys)} pools"
            )
        object.__setattr__(self, "keys", tuple(self.keys))
        object.__setattr__(self, "demand", demand)

    @property
    def num_pools(self) -> int:
        return self.demand.shape[0]

    @property
    def num_hours(self) -> int:
        return self.demand.shape[1]

    @property
    def clouds(self) -> tuple[str, ...]:
        """Per-pool cloud labels, aligned with ``demand`` rows."""
        return tuple(k[0] for k in self.keys)

    def aggregate(self) -> np.ndarray:
        """The fleet-total series — what single-pool planning collapses to."""
        return self.demand.sum(0)

    def pool(self, key: PoolKey) -> np.ndarray:
        return self.demand[self.keys.index(tuple(key))]

    def select(
        self,
        cloud: str | None = None,
        region: str | None = None,
        machine_type: str | None = None,
    ) -> "PoolSet":
        """Sub-fleet matching the given key components (None = wildcard)."""
        want = (cloud, region, machine_type)
        idx = [
            i for i, k in enumerate(self.keys)
            if all(w is None or w == part for w, part in zip(want, k))
        ]
        return PoolSet(
            keys=tuple(self.keys[i] for i in idx),
            demand=self.demand[idx],
            configs=(
                tuple(self.configs[i] for i in idx)
                if self.configs is not None else None
            ),
        )

    @classmethod
    def from_dict(
        cls,
        pools: dict[PoolKey, np.ndarray],
        configs: dict[PoolKey, DemandConfig] | None = None,
    ) -> "PoolSet":
        """Stack a {key: trace} mapping into a PoolSet (keys sorted).  All
        traces must already share one length."""
        if not pools:
            raise ValueError(
                "cannot build a PoolSet from zero pools (empty dataset?)"
            )
        keys = tuple(sorted(pools))
        lengths = {k: len(pools[k]) for k in keys}
        if len(set(lengths.values())) > 1:
            raise ValueError(
                f"ragged pools cannot stack: lengths {lengths}; align them "
                "on one timestamp grid first"
            )
        return cls(
            keys=keys,
            demand=np.stack([np.asarray(pools[k], np.float32) for k in keys]),
            configs=(
                tuple(configs[k] for k in keys) if configs is not None
                else None
            ),
        )
