"""Scenario families: demand futures for the batched replay and the
policy tournament (paper §2 taxonomy).

Two family sets, as in the reference:

* :data:`PERTURBATIONS` turn the *realized* (P, T) trace into N demand
  futures for ``scenarios=`` on the rolling replay (:class:`ScenarioConfig`,
  :func:`scenario_batch`).  Scenario 0 is the realized trace verbatim;
  scenario ``s >= 1`` perturbs pool ``p`` with a numpy generator seeded
  ``(1_000_003 * family index, seed, s, p)``:

      realized   N identical copies of the realized trace
      burst      rare short x3 spikes (the burst family's transform)
      regime     piecewise-constant level shifts (the unpredictable one)
      growth     a seeded exponential drift ramp, up or down
      scale      one lognormal level multiplier per pool

  The port draws each (scenario, pool)'s few parameters on the host from
  those very streams, in the reference's order, and applies the transform
  to the realized trace on the replay's device, one scenario block at a
  time, so an (N, P, T) batch is never built on the host.  Every family
  reproduces the reference's numpy arithmetic and dtypes bit for bit:
  ``burst`` multiplies float32 hours by 3.0 once per covering spike,
  ``scale`` multiplies float32 by the float32-rounded factor, ``regime``
  and ``growth`` multiply in float64 and round once to float32.
  ``growth``'s ramp is an ``exp`` in float64, whose last bit differs
  between libraries; the few products that land within 64 float64 ulps of
  a float32 rounding boundary are recomputed on the host with numpy's
  ``exp``, as the reference computes them, so every element rounds as
  there.  :func:`_perturb` is the plain numpy version of one row.

* :data:`FAMILIES` are the tournament's demand paths
  (:func:`scenario_path`): the synthetic driver (trend x seasonality x
  AR(1) noise, ``core.demand.synth_demand``) per pool, then the family's
  transform with its own numpy generator.  The noise comes from a seeded
  ``torch.Generator`` where the reference uses ``jax.random``, so the
  paths match the reference's in distribution, and the transform step
  (:func:`_transform`, shared numpy streams) bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import demand as dm
from repro_torch.core.demand import HOURS_PER_WEEK
from repro_torch.device import resolve_device

FAMILIES: tuple[str, ...] = (
    "steady", "burst", "cyclic", "declining", "unpredictable",
)

PERTURBATIONS: tuple[str, ...] = (
    "realized", "burst", "regime", "growth", "scale",
)

# Growth/scale perturbation knobs (annualized drift range, level sigma).
GROWTH_RANGE = (-0.35, 0.45)
SCALE_SIGMA = 0.20

_CLOUDS = ("aws", "azure", "gcp")

# Burst family knobs.
BURST_EVERY_WEEKS = 4          # ~one spike per this many weeks
BURST_FACTOR = 3.0             # spike multiplier
BURST_LEN_HOURS = (6, 24)      # spike duration range
# Unpredictable family knobs.
REGIME_SEGMENTS = 5
REGIME_RANGE = (0.5, 1.8)

_GROWTH_HOURS = 52.0 * HOURS_PER_WEEK   # the ramp's time unit, a year
# A float64 product this many ulps from a float32 rounding boundary may
# round the other way under another library's exp; recomputed on the host.
_GROWTH_GUARD = 2.0 ** -46


def _family_config(family: str, pool: int) -> dm.DemandConfig:
    """The per-pool driver config of a tournament family, varied across
    pools the way the synthetic fleet's pools vary."""
    base = 40.0 * (1.5 ** (pool % 3))
    if family == "steady":
        return dm.DemandConfig(
            base_level=base, annual_growth=0.0,
            diurnal_amplitude=0.10 + 0.02 * (pool % 3),
            weekly_amplitude=0.12 + 0.02 * (pool % 4),
            noise_sigma=0.04,
        )
    if family == "burst":
        return dm.DemandConfig(
            base_level=base, annual_growth=0.0,
            diurnal_amplitude=0.08, weekly_amplitude=0.10,
            noise_sigma=0.05,
        )
    if family == "cyclic":
        return dm.DemandConfig(
            base_level=base, annual_growth=0.0,
            diurnal_amplitude=0.35 + 0.05 * (pool % 2),
            weekly_amplitude=0.45 + 0.05 * (pool % 3),
            noise_sigma=0.05,
        )
    if family == "declining":
        return dm.DemandConfig(
            base_level=1.6 * base, annual_growth=-0.90,
            diurnal_amplitude=0.10, weekly_amplitude=0.12,
            noise_sigma=0.05,
        )
    if family == "unpredictable":
        return dm.DemandConfig(
            base_level=base, annual_growth=0.0,
            diurnal_amplitude=0.10, weekly_amplitude=0.12,
            noise_sigma=0.15,
        )
    raise ValueError(f"unknown family {family!r}; known: {FAMILIES}")


def _transform(
    family: str, y: np.ndarray, rng: np.random.Generator
) -> np.ndarray:
    """Family-specific post-transform of one pool's hourly series (numpy,
    the reference's arithmetic)."""
    t = y.shape[-1]
    if family == "burst":
        num_bursts = max(1, t // (BURST_EVERY_WEEKS * HOURS_PER_WEEK))
        for _ in range(num_bursts):
            ln = int(rng.integers(*BURST_LEN_HOURS))
            at = int(rng.integers(0, max(t - ln, 1)))
            y = y.copy()
            y[at:at + ln] *= BURST_FACTOR
        return y
    if family == "cyclic":
        # A 4-week business cycle on top of the weekly/diurnal pattern.
        phase = rng.uniform(0.0, 2.0 * np.pi)
        month = 1.0 + 0.3 * np.sin(
            2.0 * np.pi * np.arange(t) / (4 * HOURS_PER_WEEK) + phase
        )
        return y * month
    if family == "unpredictable":
        # Piecewise-constant regime multipliers: level shifts no smooth
        # structural fit anticipates.
        edges = np.sort(rng.integers(1, t, size=REGIME_SEGMENTS - 1))
        mult = rng.uniform(*REGIME_RANGE, size=REGIME_SEGMENTS)
        levels = np.repeat(
            mult, np.diff(np.concatenate([[0], edges, [t]]))
        )
        return y * levels
    return y


@dataclasses.dataclass(frozen=True)
class ScenarioConfig:
    """Scenario axis of the batched rolling replay (``scenarios=`` on
    ``replan_fleet_pools`` / ``PlanRequest.scenarios``).

    ``n_scenarios`` demand futures are derived from the realized trace by
    the ``family`` perturbation (:data:`PERTURBATIONS`); scenario 0 is
    always the realized path, so ``n_scenarios=1`` with the default
    ``"realized"`` family is bit for bit the unbatched replay.  ``chunk``
    bounds how many scenarios one replay carries (sequential sub-replays,
    merged into one report; ``None`` runs all N at once)."""

    n_scenarios: int = 1
    family: str = "realized"
    seed: int = 0
    chunk: int | None = None

    def __post_init__(self):
        if self.n_scenarios < 1:
            raise ValueError(
                f"n_scenarios must be >= 1, got {self.n_scenarios}"
            )
        if self.family not in PERTURBATIONS:
            raise ValueError(
                f"unknown scenario family {self.family!r}; "
                f"known: {PERTURBATIONS}"
            )
        if self.chunk is not None and self.chunk < 1:
            raise ValueError(f"chunk must be >= 1 or None, got {self.chunk}")


def resolve_scenarios(
    spec: "ScenarioConfig | int | None",
) -> "ScenarioConfig | None":
    """Normalize the ``scenarios=`` spelling: ``None`` stays off, an int
    means ``ScenarioConfig(n_scenarios=int)``."""
    if spec is None or isinstance(spec, ScenarioConfig):
        return spec
    if isinstance(spec, bool):
        raise TypeError("scenarios= takes an int or ScenarioConfig, not bool")
    if isinstance(spec, int):
        return ScenarioConfig(n_scenarios=spec)
    raise TypeError(
        f"scenarios= takes None, an int, or a ScenarioConfig, "
        f"got {type(spec).__name__}"
    )


def _perturb(family: str, y: np.ndarray, rng: np.random.Generator):
    """One perturbed copy of one pool's realized hourly series: the plain
    numpy version of a row of :func:`scenario_block`."""
    t = y.shape[-1]
    if family == "burst":
        return _transform("burst", y, rng)
    if family == "regime":
        return _transform("unpredictable", y, rng)
    if family == "growth":
        g = rng.uniform(*GROWTH_RANGE)
        ramp = np.exp(g * np.arange(t) / _GROWTH_HOURS)
        return y * ramp
    if family == "scale":
        return y * rng.lognormal(0.0, SCALE_SIGMA)
    return y


def _rng(family: str, seed: int, s: int, p: int) -> np.random.Generator:
    return np.random.default_rng(
        (1_000_003 * PERTURBATIONS.index(family), seed, s, p))


def _draws(family: str, t: int, rng: np.random.Generator):
    """The parameters :func:`_perturb` draws from ``rng``, in its order."""
    if family == "burst":
        spikes = []
        for _ in range(max(1, t // (BURST_EVERY_WEEKS * HOURS_PER_WEEK))):
            ln = int(rng.integers(*BURST_LEN_HOURS))
            spikes.append((int(rng.integers(0, max(t - ln, 1))), ln))
        return spikes
    if family == "regime":
        edges = np.sort(rng.integers(1, t, size=REGIME_SEGMENTS - 1))
        return edges, rng.uniform(*REGIME_RANGE, size=REGIME_SEGMENTS)
    if family == "growth":
        return rng.uniform(*GROWTH_RANGE)
    return rng.lognormal(0.0, SCALE_SIGMA)                  # scale


def _burst_rows(y: torch.Tensor, spikes) -> torch.Tensor:
    """Rows y (P, T) x3 once per spike covering each hour, in float32."""
    p, t = y.shape
    dev = y.device
    delta = torch.zeros((p, t + 1), dtype=torch.int32, device=dev)
    rows = torch.tensor([r for r, sp in enumerate(spikes) for _ in sp],
                        dtype=torch.int64, device=dev)
    at = torch.tensor([a for sp in spikes for a, _ in sp],
                      dtype=torch.int64, device=dev)
    end = torch.clamp(at + torch.tensor(
        [ln for sp in spikes for _, ln in sp], dtype=torch.int64,
        device=dev), max=t)
    one = torch.ones_like(rows, dtype=torch.int32)
    delta.index_put_((rows, at), one, accumulate=True)
    delta.index_put_((rows, end), -one, accumulate=True)
    covering = torch.cumsum(delta[:, :t], dim=-1)
    out = y
    for k in range(int(covering.max())):
        out = torch.where(covering > k, out * BURST_FACTOR, out)
    return out


def _regime_rows(y: torch.Tensor, draws) -> torch.Tensor:
    """Rows y (P, T) times their piecewise-constant float64 levels."""
    dev = y.device
    edges = torch.tensor(np.stack([e for e, _ in draws]), device=dev)
    mult = torch.tensor(np.stack([m for _, m in draws]), dtype=torch.float64,
                        device=dev)
    hours = torch.arange(y.shape[-1], device=dev)
    seg = torch.zeros(y.shape, dtype=torch.int64, device=dev)
    for k in range(edges.shape[1]):
        seg += (hours[None, :] >= edges[:, k:k + 1]).to(torch.int64)
    return (y.double() * torch.gather(mult, 1, seg)).float()


def _round_f32(prod: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(float32 rounding of the float64 ``prod``, mask of the elements
    within 64 float64 ulps of a float32 rounding boundary, the midpoint
    between two neighbouring float32 values, where a last-bit difference
    in ``prod`` could round the other way)."""
    out = prod.float()
    o64 = out.double()
    mid_up = o64 + torch.nextafter(out, out.new_tensor(np.inf)).double()
    mid_dn = o64 + torch.nextafter(out, out.new_tensor(-np.inf)).double()
    gap = torch.minimum((prod - 0.5 * mid_up).abs(),
                        (prod - 0.5 * mid_dn).abs())
    return out, gap <= prod.abs() * _GROWTH_GUARD


def _growth_rows(y: torch.Tensor, g: np.ndarray,
                 host_y: np.ndarray) -> torch.Tensor:
    """Rows y (P, T) times exp(g t / 52 weeks) in float64, rounded once;
    products near a float32 rounding boundary recomputed with numpy's exp
    from the host rows ``host_y``."""
    dev = y.device
    g_t = torch.tensor(g, dtype=torch.float64, device=dev)
    hours = torch.arange(y.shape[-1], dtype=torch.float64, device=dev)
    prod = y.double() * torch.exp(g_t[:, None] * hours[None, :]
                                  / _GROWTH_HOURS)
    out, near = _round_f32(prod)
    rows, cols = torch.nonzero(near, as_tuple=True)
    if rows.numel():
        r, c = rows.cpu().numpy(), cols.cpu().numpy()
        ramp = np.exp(g[r] * c / _GROWTH_HOURS)
        exact = (host_y[r, c].astype(np.float64) * ramp).astype(np.float32)
        out[rows, cols] = torch.from_numpy(exact).to(dev)
    return out


def _perturb_rows(family: str, y: torch.Tensor, host_y: np.ndarray,
                  seed: int, s: int) -> torch.Tensor:
    """Scenario ``s``'s perturbation of the realized rows y (P, T) on
    their device (host_y the same rows on the host)."""
    t = y.shape[-1]
    draws = [_draws(family, t, _rng(family, seed, s, p))
             for p in range(y.shape[0])]
    if family == "burst":
        return _burst_rows(y, draws)
    if family == "regime":
        return _regime_rows(y, draws)
    if family == "growth":
        return _growth_rows(y, np.asarray(draws, np.float64), host_y)
    factor = torch.tensor(np.asarray(draws, np.float32), device=y.device)
    return y * factor[:, None]                                # scale


def scenario_block(
    demand, cfg: ScenarioConfig, lo: int, hi: int, *, device=None
) -> torch.Tensor:
    """Scenarios ``lo .. hi-1`` of :func:`scenario_batch`, (hi - lo, P, T)
    float32 on ``device`` (``None`` = the card): each one a pure function
    of (demand, cfg, s), so a chunk or a single scenario is built alone
    with the rows the whole batch holds."""
    host = np.ascontiguousarray(np.asarray(demand, np.float32))
    if host.ndim != 2:
        raise ValueError(f"demand must be (P, T), got shape {host.shape}")
    if not 0 <= lo < hi <= cfg.n_scenarios:
        raise ValueError(
            f"scenarios {lo}..{hi - 1} out of range for "
            f"{cfg.n_scenarios} scenario(s)")
    base = torch.from_numpy(host).to(resolve_device(device))
    out = torch.empty((hi - lo,) + host.shape, dtype=torch.float32,
                      device=base.device)
    for s in range(lo, hi):
        if s == 0 or cfg.family == "realized":
            out[s - lo] = base
        else:
            out[s - lo] = _perturb_rows(cfg.family, base, host, cfg.seed, s)
    return out


def scenario_batch(demand, cfg: ScenarioConfig, *,
                   device=None) -> torch.Tensor:
    """(N, P, T) float32 scenario batch on ``device`` (``None`` = the
    card) derived from the
    realized ``demand`` (P, T): scenario 0 the trace verbatim, scenario s
    the ``cfg.family`` perturbation of pool p with a generator seeded
    ``(family, cfg.seed, s, p)``, bit for bit the reference's batch."""
    return scenario_block(demand, cfg, 0, cfg.n_scenarios, device=device)


def scenario_keys(num_pools: int) -> tuple[dm.PoolKey, ...]:
    """Pool keys for a scenario fleet, cloud-cycled like the synthetic
    fleet, so the Table-2 purchase options apply."""
    return tuple(
        (_CLOUDS[i % 3], f"region_{i % 4}", f"type_{i:02d}")
        for i in range(num_pools)
    )


def scenario_path(
    family: str,
    *,
    num_pools: int = 3,
    num_weeks: int = 40,
    seed: int = 0,
) -> np.ndarray:
    """One (P, T) float32 demand path of ``family`` at ``seed``, T in whole
    weeks: pool p's driver noise from a CPU ``torch.Generator`` seeded
    ``100_000 * family index + 100 * seed + p``, then the family transform
    with a numpy generator seeded ``(family index, seed, p)``."""
    if family not in FAMILIES:
        raise ValueError(f"unknown family {family!r}; known: {FAMILIES}")
    num_hours = num_weeks * HOURS_PER_WEEK
    fam_idx = FAMILIES.index(family)
    rows = []
    for p in range(num_pools):
        gen = torch.Generator().manual_seed(100_000 * fam_idx + 100 * seed + p)
        y = dm.synth_demand(num_hours, _family_config(family, p),
                            generator=gen).numpy()
        rows.append(_transform(family, y,
                               np.random.default_rng((fam_idx, seed, p))))
    return np.stack(rows).astype(np.float32)


def scenario_paths(
    family: str,
    *,
    num_pools: int = 3,
    num_weeks: int = 40,
    num_seeds: int = 32,
    base_seed: int = 0,
) -> np.ndarray:
    """(N, P, T) seeded paths of one family, the tournament's unit of
    coverage (N >= 32 by default so ratio/regret tails are populated)."""
    return np.stack([
        scenario_path(family, num_pools=num_pools, num_weeks=num_weeks,
                      seed=base_seed + s)
        for s in range(num_seeds)
    ])


def scenario_pool_set(
    family: str,
    *,
    num_pools: int = 3,
    num_weeks: int = 40,
    seed: int = 0,
) -> dm.PoolSet:
    """One scenario path as a :class:`~repro_torch.core.demand.PoolSet`,
    so the whole planner surface runs on it."""
    keys = scenario_keys(num_pools)
    return dm.PoolSet(
        keys=keys,
        demand=scenario_path(family, num_pools=num_pools,
                             num_weeks=num_weeks, seed=seed),
        configs=tuple(_family_config(family, i) for i in range(num_pools)),
    )
