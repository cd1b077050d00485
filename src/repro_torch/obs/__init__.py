"""Telemetry of the rolling planner: cost-attribution ledger, forecast
calibration, decision provenance, spans and kernel stats.

- ``obs.ledger``: :class:`~repro_torch.obs.ledger.CostLedger`, the
  per-week x per-pool x per-source billing decomposition of a
  telemetry-enabled rolling replay; JSONL export (the JAX package's
  format), ``diff``, unit economics.
- ``obs.calibration``: :class:`~repro_torch.obs.calibration.
  CalibrationCube`, per (week x pool x fractile) coverage, pinball loss and
  band widths of the weekly forecast fractiles against realized demand.
- ``obs.provenance``: :class:`~repro_torch.obs.provenance.DecisionLog`,
  the per-week decision record (buys per SKU, roll-offs, binding
  constraints): why week w holds this stack.
- ``obs.spans``: :class:`~repro_torch.obs.spans.SpanRecorder`, caller-side
  timed phases, by CUDA events or a caller's clock.
- ``obs.kernelstats``: :class:`~repro_torch.obs.kernelstats.KernelStats`
  of the CUDA commitment-sweep launch.

Enable per request: ``PlanRequest(..., telemetry=True)`` or
``telemetry=TelemetryConfig(calibration=True, provenance=True)``;
``telemetry=None`` (the default) leaves every plan as it was.
``python -m repro_torch.obs`` reports and diffs exported ledgers and
calibration cubes.  Everything here but the span recorder's events and
the kernel stats' constants is numpy on the host.
"""

from repro_torch.obs.calibration import (
    CalibrationCube,
    CalibrationDiff,
    calibration_from_arrays,
    calibration_from_scores,
)
from repro_torch.obs.config import TelemetryConfig, resolve_telemetry
from repro_torch.obs.kernelstats import KernelStats, sweep_kernel_stats
from repro_torch.obs.ledger import CostLedger, LedgerDiff, ledger_from_report
from repro_torch.obs.provenance import DecisionLog, decision_log_from_arrays
from repro_torch.obs.spans import Span, SpanRecorder, span

__all__ = [
    "TelemetryConfig",
    "resolve_telemetry",
    "KernelStats",
    "sweep_kernel_stats",
    "CostLedger",
    "LedgerDiff",
    "ledger_from_report",
    "CalibrationCube",
    "CalibrationDiff",
    "calibration_from_arrays",
    "calibration_from_scores",
    "DecisionLog",
    "decision_log_from_arrays",
    "Span",
    "SpanRecorder",
    "span",
]
