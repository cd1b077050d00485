"""Stochastic spot-revocation model: a per-pool two-state Markov process.

Spot capacity is the third purchasing option next to commitments and
on-demand: its used rate is deeply discounted, but the provider may revoke
a slice at any hour.  Revocation is a two-state (available / revoked)
Markov chain per pool with per-cloud rates from ``pricing.SPOT_MARKETS``:

    P(available -> revoked  | one hour) = hazard
    P(revoked   -> available| one hour) = recovery

so the stationary availability is a = recovery / (hazard + recovery).
Hourly spot prices wander inside a per-cloud band around the mean spot
rate (an AR(1) walk clipped to the band).

The Monte-Carlo walk steps all (draw, pool) lanes through the hours.  On
the card that is one launch of a hand-written CUDA kernel
(``kernels/revocation_walk``); on the CPU the plain per-hour loop
(:func:`revocation_walk_loop`), which is also the kernel's spec.  All
randomness is drawn up front (:func:`draw_noise`), so both walk identical
paths.  The draws come from a ``torch.Generator``, whose numbers differ
from ``jax.random``'s for one seed: tests hand the reference's draws to
both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.capacity import pricing
from repro_torch.device import resolve_device
from repro_torch.kernels.revocation_walk import ops as walk_ops
from repro_torch.kernels.revocation_walk.ref import revocation_walk_ref

# The SPOT_MARKETS rows must satisfy their invariants before any revocation
# process is built from them.
pricing.validate_tables()


@dataclasses.dataclass(frozen=True)
class PreemptionParams:
    """Per-pool revocation-process parameters, (P,) float32 tensors on one
    device, aligned with the pool axis."""

    hazard: torch.Tensor      # (P,) P(available -> revoked) per hour
    recovery: torch.Tensor    # (P,) P(revoked -> available) per hour
    discount: torch.Tensor    # (P,) spot discount vs on-demand
    price_band: torch.Tensor  # (P,) +/- fractional hourly price band

    @property
    def num_pools(self) -> int:
        return self.hazard.shape[0]

    def to(self, device) -> "PreemptionParams":
        return PreemptionParams(*(
            getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)))


def params_for_clouds(
    clouds: Sequence[str],
    markets: Sequence[pricing.SpotMarket] | None = None,
    *,
    device=None,
) -> PreemptionParams:
    """(P,) revocation parameters for a fleet of pools on ``clouds``: the
    per-cloud market rows broadcast to the pool axis (``KeyError`` naming
    any cloud without a market), on ``device`` (``None`` is the card, as
    for every entry point of the port)."""
    dev = resolve_device(device)
    by_cloud = {m.cloud: m for m in (markets or pricing.SPOT_MARKETS)}
    missing = sorted(set(clouds) - set(by_cloud))
    if missing:
        raise KeyError(f"no spot market data for clouds {missing}")
    rows = [by_cloud[c] for c in clouds]

    def col(name):
        return torch.tensor([getattr(m, name) for m in rows],
                            dtype=torch.float32, device=dev)

    return PreemptionParams(
        hazard=col("hazard_per_hour"),
        recovery=col("recovery_per_hour"),
        discount=col("discount"),
        price_band=col("price_band"),
    )


def stationary_availability(params: PreemptionParams) -> torch.Tensor:
    """(P,) long-run fraction of hours a spot slice is available:
    a = recovery / (hazard + recovery)."""
    return params.recovery / torch.clamp(
        params.hazard + params.recovery, min=1e-12
    )


def interruption_rate(params: PreemptionParams) -> torch.Tensor:
    """(P,) expected revocations per wall-clock hour in steady state:
    hazard while available, weighted by the availability fraction."""
    return params.hazard * stationary_availability(params)


@dataclasses.dataclass(frozen=True)
class RevocationPaths:
    """Sampled revocation paths: N draws x P pools x T hours, float32.

    ``available`` is the state path (1.0 while the pool's spot capacity is
    up); ``interrupted`` marks the hours where an available slice was
    revoked; ``price`` is the hourly spot price multiplier (mean 1.0,
    wandering in the per-cloud band).  The walk writes them hour-major, so
    each is an (N, P, T) view of (T, N, P) storage."""

    available: torch.Tensor    # (N, P, T) in {0, 1}
    interrupted: torch.Tensor  # (N, P, T) in {0, 1}
    price: torch.Tensor        # (N, P, T) multiplier around 1.0

    @property
    def num_draws(self) -> int:
        return self.available.shape[0]

    def availability(self) -> np.ndarray:
        """(P,) mean availability over draws and hours: the empirical
        counterpart of :func:`stationary_availability`."""
        return self.available.mean((0, 2)).cpu().numpy()

    def interruptions_per_hour(self) -> np.ndarray:
        """(P,) empirical revocations per wall-clock hour: the counterpart
        of :func:`interruption_rate`."""
        return self.interrupted.mean((0, 2)).cpu().numpy()


def draw_noise(
    params: PreemptionParams,
    num_hours: int,
    num_draws: int,
    generator: torch.Generator,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Everything random, drawn up front on the generator's device: initial
    states from the stationary distribution (so short windows are not
    biased by an all-available hour 0), (N, P) float32, and the per-hour
    transition uniforms and price-walk normals, (T, N, P) each."""
    dev = generator.device
    p = params.num_pools
    a = stationary_availability(params).to(dev)
    avail0 = (
        torch.rand((num_draws, p), generator=generator, device=dev)
        < a[None, :]
    ).to(torch.float32)
    us = torch.rand((num_hours, num_draws, p), generator=generator,
                    device=dev)
    zs = torch.randn((num_hours, num_draws, p), generator=generator,
                     device=dev)
    return avail0, us, zs


def revocation_walk(
    params: PreemptionParams,
    avail0: torch.Tensor,
    us: torch.Tensor,
    zs: torch.Tensor,
) -> RevocationPaths:
    """The fleet walk on the tensors' device: one kernel launch on the
    card, the plain per-hour loop on the CPU (``kernels/revocation_walk``).
    avail0 (N, P), us and zs (T, N, P)."""
    return RevocationPaths(*walk_ops.revocation_walk(
        params.hazard, params.recovery, params.price_band, avail0, us, zs))


def revocation_walk_loop(
    params: PreemptionParams,
    avail0: torch.Tensor,
    us: torch.Tensor,
    zs: torch.Tensor,
) -> RevocationPaths:
    """The same walk as a loop over hours on any device: the kernel's plain
    version, a handful of tensor operations per hour.  States and
    interruptions equal the kernel's and the reference's bit for bit;
    prices equal the kernel's, and the reference's to ~1e-7 (its compiled
    scan may fuse the price update into one multiply-add)."""
    return RevocationPaths(*(x.movedim(0, -1) for x in revocation_walk_ref(
        params.hazard, params.recovery, params.price_band,
        avail0.to(torch.float32), us.to(torch.float32),
        zs.to(torch.float32))))


def _noise(params, num_hours, num_draws, generator):
    """(params, avail0, us, zs), all on the params' device; ``None`` is a
    generator there seeded 0.  A generator on another device is an error:
    the walk never moves to where the parameters are not."""
    dev = params.hazard.device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    elif generator.device.type != dev.type:
        raise ValueError(
            f"generator on {generator.device} but the parameters on {dev}"
        )
    return (params, *draw_noise(params, num_hours, num_draws, generator))


def simulate_revocations(
    params: PreemptionParams,
    num_hours: int,
    *,
    num_draws: int = 32,
    generator: torch.Generator | None = None,
) -> RevocationPaths:
    """Sample revocation paths for the whole fleet on the parameters'
    device (default generator: one there seeded 0): draw the noise, walk."""
    return revocation_walk(*_noise(params, num_hours, num_draws, generator))


def simulate_revocations_loop(
    params: PreemptionParams,
    num_hours: int,
    *,
    num_draws: int = 32,
    generator: torch.Generator | None = None,
) -> RevocationPaths:
    """:func:`simulate_revocations` through the per-hour loop."""
    return revocation_walk_loop(
        *_noise(params, num_hours, num_draws, generator))


def requeue_cost_hours(
    paths: RevocationPaths,
    spot_usage: torch.Tensor,
    requeue_hours: float,
) -> torch.Tensor:
    """(N, P) recompute/requeue chip-hours: every interruption of a slice
    that was serving demand loses ``requeue_hours`` of work per interrupted
    chip.  ``spot_usage`` (P, T) or (N, P, T) is the spot chip demand per
    hour."""
    usage = torch.as_tensor(spot_usage, dtype=torch.float32,
                            device=paths.interrupted.device)
    if usage.dim() == 2:
        usage = usage[None, :, :]
    return (paths.interrupted * usage * requeue_hours).sum(-1)
