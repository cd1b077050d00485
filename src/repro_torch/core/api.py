"""Planner request API: one frozen :class:`PlanRequest` in, one plan out.

The same fields and the same eager validation as the reference's
``repro.core.api``, so a request spells the same in both packages:

    request = PlanRequest(
        pools=pools,
        mode="rolling",
        rolling=RollingConfig(solver="grid", num_grid=128),
    )
    report = plan(request)                 # on the card
    report = plan(request, device="cpu")   # plain versions on the CPU

Both modes are ported: ``mode="one_shot"`` (the default) returns a
:class:`repro_torch.core.planner.FleetPoolsPlan`, ``mode="rolling"`` a
:class:`repro_torch.core.replan.RollingPlanReport`.  ``spot=`` (None, a
bool or a :class:`repro_torch.core.spot.SpotConfig`), ``migration=``
(None, a bool or a :class:`repro_torch.capacity.generations.
MigrationConfig`) and ``convertible=`` (None, a bool or a list of
convertible purchase options) run in both; ``scenarios=`` (an int or a
:class:`ScenarioConfig`), every registry ``policy=``, ``telemetry=``
(None or False, True, or a :class:`repro_torch.obs.TelemetryConfig`),
``RollingConfig(cadence="breach")`` and ``RollingConfig(irls_carry=True)``
run in rolling mode, so a rolling request accepts everything the
reference's does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Literal

import torch

from repro_torch.capacity import generations as gn
from repro_torch.core import forecast as fc
from repro_torch.core import policy as pol
from repro_torch.core import spot as spot_mod
from repro_torch.data.scenarios import ScenarioConfig, resolve_scenarios
from repro_torch.obs.config import resolve_telemetry

__all__ = ["PlanRequest", "RollingConfig", "ScenarioConfig", "plan"]

_SOLVERS = ("quantile", "grid")
_BACKENDS = ("scan", "loop")
_MODES = ("one_shot", "rolling")


@dataclasses.dataclass(frozen=True)
class RollingConfig:
    """Rolling-replay knobs of a :class:`PlanRequest` (``mode="rolling"``).
    The defaults reproduce ``replan_fleet_pools``'s defaults exactly; see
    :func:`repro_torch.core.replan.replan_fleet_pools`."""

    cadence_weeks: int = 1
    start_weeks: int | None = None
    solver: Literal["quantile", "grid"] = "quantile"
    num_grid: int = 128
    use_kernel: bool = False
    irls_iters: int = 0
    irls_carry: bool = False
    backend: Literal["scan", "loop"] = "scan"
    compare: bool = True
    cadence: Literal["weekly", "breach"] = "weekly"
    breach_band: tuple = (0.05, 0.95)
    breach_tolerance: float = 4.0

    def __post_init__(self):
        if self.cadence_weeks < 1:
            raise ValueError(
                f"cadence_weeks must be >= 1, got {self.cadence_weeks}"
            )
        if self.cadence not in ("weekly", "breach"):
            raise ValueError(
                f"unknown cadence {self.cadence!r}; "
                "known: ('weekly', 'breach')"
            )
        if self.cadence == "breach" and self.cadence_weeks != 1:
            raise ValueError(
                "cadence='breach' evaluates every week and masks "
                "decisions itself; combine it with cadence_weeks=1, "
                f"got cadence_weeks={self.cadence_weeks}"
            )
        if len(self.breach_band) != 2:
            raise ValueError(
                f"breach_band must be a (lo, hi) pair, got {self.breach_band}"
            )
        lo, hi = self.breach_band
        if not 0.0 < lo < hi < 1.0:
            raise ValueError(
                "breach_band must be an increasing fractile pair inside "
                f"(0, 1), got {self.breach_band}"
            )
        if self.breach_tolerance <= 0.0:
            raise ValueError(
                f"breach_tolerance must be > 0, got {self.breach_tolerance}"
            )
        if self.start_weeks is not None and self.start_weeks < 1:
            raise ValueError(
                f"start_weeks must be >= 1 or None, got {self.start_weeks}"
            )
        if self.solver not in _SOLVERS:
            raise ValueError(
                f"unknown solver {self.solver!r}; known: {_SOLVERS}"
            )
        if self.num_grid < 2:
            raise ValueError(f"num_grid must be >= 2, got {self.num_grid}")
        if self.irls_iters < 0:
            raise ValueError(
                f"irls_iters must be >= 0, got {self.irls_iters}"
            )
        if self.backend not in _BACKENDS:
            raise ValueError(
                f"unknown backend {self.backend!r}; known: {_BACKENDS}"
            )


@dataclasses.dataclass(frozen=True)
class PlanRequest:
    """One planner invocation, fully specified and eagerly validated.

    ``pools`` carries the (P, T) demand; rolling-only knobs live in
    ``rolling``, and setting them on a one-shot request is a
    construction-time error."""

    pools: Any
    options: list | None = None
    mode: Literal["one_shot", "rolling"] = "one_shot"
    horizon_weeks: int = 8
    od_rate: float | None = None
    term_weighting: float = 0.0
    forecast: fc.ForecastConfig = dataclasses.field(
        default_factory=fc.ForecastConfig
    )
    spot: Any = None
    migration: Any = None
    convertible: Any = None
    policy: Any = None          # Policy | str | None
    scenarios: "ScenarioConfig | int | None" = None
    telemetry: Any = None
    rolling: RollingConfig = dataclasses.field(default_factory=RollingConfig)

    def __post_init__(self):
        if self.mode not in _MODES:
            raise ValueError(
                f"unknown mode {self.mode!r}; known: {_MODES}"
            )
        if self.horizon_weeks < 1:
            raise ValueError(
                f"horizon_weeks must be >= 1, got {self.horizon_weeks}"
            )
        if not isinstance(self.rolling, RollingConfig):
            raise TypeError(
                "rolling= takes a RollingConfig, got "
                f"{type(self.rolling).__name__}"
            )
        if not isinstance(self.forecast, fc.ForecastConfig):
            raise TypeError(
                "forecast= takes a ForecastConfig, got "
                f"{type(self.forecast).__name__}"
            )
        if self.spot is not None and not isinstance(self.spot, bool):
            if not isinstance(self.spot, spot_mod.SpotConfig):
                raise TypeError(
                    "spot= takes a SpotConfig, bool, or None, got "
                    f"{type(self.spot).__name__}"
                )
        gn.resolve_migration(self.migration)
        if isinstance(self.policy, str) and self.policy not in pol.POLICIES:
            raise ValueError(
                f"unknown policy {self.policy!r}; "
                f"known: {tuple(pol.POLICIES)}"
            )
        resolve_scenarios(self.scenarios)
        resolve_telemetry(self.telemetry)
        if self.mode == "one_shot":
            if self.policy is not None:
                raise ValueError("policy= applies to mode='rolling' only")
            if self.scenarios is not None:
                raise ValueError(
                    "scenarios= applies to mode='rolling' only"
                )
            if resolve_telemetry(self.telemetry) is not None:
                raise ValueError(
                    "telemetry= applies to mode='rolling' only (the "
                    "ledger decomposes the weekly replay)"
                )
            if self.rolling != RollingConfig():
                raise ValueError(
                    "rolling= knobs were set on a mode='one_shot' request"
                )

    def rolling_kwargs(self) -> dict:
        """The ``replan_fleet_pools`` keyword spelling of ``rolling``."""
        return dataclasses.asdict(self.rolling)


def plan(request: PlanRequest, *, device: "torch.device | str | None" = None):
    """Execute one :class:`PlanRequest` on ``device`` (``None`` = the card;
    without one, pass ``device="cpu"``).  Returns a
    :class:`repro_torch.core.planner.FleetPoolsPlan` for
    ``mode="one_shot"``, a :class:`repro_torch.core.replan.RollingPlanReport`
    for ``mode="rolling"``."""
    if not isinstance(request, PlanRequest):
        raise TypeError(
            f"plan() takes a PlanRequest, got {type(request).__name__}"
        )
    if request.mode == "one_shot":
        from repro_torch.core import planner

        return planner._plan_fleet_pools_one_shot(
            request.pools, request.options,
            horizon_weeks=request.horizon_weeks,
            od_rate=request.od_rate,
            term_weighting=request.term_weighting,
            cfg=request.forecast,
            spot=request.spot,
            migration=request.migration,
            convertible=request.convertible,
            device=device,
        )
    from repro_torch.core import replan

    return replan.replan_fleet_pools(
        request.pools, request.options,
        horizon_weeks=request.horizon_weeks,
        od_rate=request.od_rate,
        term_weighting=request.term_weighting,
        cfg=request.forecast,
        spot=request.spot,
        migration=request.migration,
        convertible=request.convertible,
        policy=request.policy,
        scenarios=request.scenarios,
        telemetry=request.telemetry,
        device=device,
        **request.rolling_kwargs(),
    )
