"""Telemetry configuration for plan requests.

``PlanRequest.telemetry`` (and the ``telemetry=`` kwarg on the legacy
``plan_fleet_pools`` shim) takes one of:

    None / False        no telemetry — the default; every plan path stays
                        bit-identical to a build without this subsystem
                        (the rolling replay emits no extra outputs at all)
    True                TelemetryConfig() — ledger + kernel stats on
    TelemetryConfig(...)  pick layers individually, attach a SpanRecorder

Kept separate from ``core.api`` so the obs package has no import cycle
with the planner: core imports ``obs.config``/``obs.ledger``, while obs
duck-types the report objects it receives and never imports core.  The
same fields and the same validation as the JAX package's
``repro.obs.config``.
"""

from __future__ import annotations

import dataclasses
import typing

if typing.TYPE_CHECKING:  # pragma: no cover
    from repro_torch.obs.spans import SpanRecorder


#: Forecast fractiles the calibration layer scores each week; the outer
#: pair doubles as the default breach band (``RollingConfig.breach_band``).
DEFAULT_FRACTILES = (0.05, 0.25, 0.5, 0.75, 0.95)


@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    """Which telemetry layers a plan request materializes.

    ``ledger``       emit per-week x per-pool x per-source billing rows
                     from the rolling replay and attach a ``CostLedger``
    ``kernel_stats`` attach ``KernelStats`` for the grid-solver sweep
                     shape (no-op for the quantile solver)
    ``calibration``  emit each week's forecast fractile levels from the
                     replay and score them against realized demand as a
                     ``CalibrationCube`` (forecasting policies only)
    ``provenance``   emit per-week decision records (buys, roll-offs,
                     binding constraints) and attach a ``DecisionLog``
    ``fractiles``    the forecast fractiles the calibration layer scores
    ``spans``        optional ``SpanRecorder`` for caller-side timed
                     phases; the replay itself never reads it
    """

    ledger: bool = True
    kernel_stats: bool = True
    calibration: bool = False
    provenance: bool = False
    fractiles: tuple[float, ...] = DEFAULT_FRACTILES
    spans: "SpanRecorder | None" = None

    def __post_init__(self):
        fr = tuple(float(q) for q in self.fractiles)
        if not fr:
            raise ValueError("fractiles must be non-empty")
        if any(not 0.0 < q < 1.0 for q in fr):
            raise ValueError(
                f"fractiles must lie strictly inside (0, 1), got {fr}"
            )
        if list(fr) != sorted(set(fr)):
            raise ValueError(
                f"fractiles must be strictly increasing, got {fr}"
            )
        object.__setattr__(self, "fractiles", fr)

    @property
    def enabled(self) -> bool:
        return (
            self.ledger or self.kernel_stats or self.calibration
            or self.provenance or self.spans is not None
        )


def resolve_telemetry(spec) -> TelemetryConfig | None:
    """Normalize a user telemetry spec to ``TelemetryConfig | None``."""
    if spec is None or spec is False:
        return None
    if spec is True:
        return TelemetryConfig()
    if isinstance(spec, TelemetryConfig):
        return spec if spec.enabled else None
    raise TypeError(
        "telemetry must be None, a bool, or a TelemetryConfig, "
        f"got {type(spec).__name__}"
    )
