"""Capacity-commitment-aware scheduler for deferrable jobs (paper §4 and
Future Work #1, applied to this framework's own workloads).

Deferrable framework workloads — eval sweeps, checkpoint-replay regression
suites, compile farms, dataset preprocessing — are the Snowtrail/CI analogue
of the paper's §4 categories.  The scheduler packs them into the troughs
below the commitment line (already-paid capacity) instead of riding the
peak at on-demand rates.  Host numpy over
:func:`repro_torch.core.timeshift.schedule_jobs`.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import timeshift as ts
from repro_torch.capacity import pricing

pricing.validate_tables()


@dataclasses.dataclass(frozen=True)
class DeferrableWorkload:
    name: str
    kind: str                  # eval | regression | loadtest | build
    chip_hours: float
    arrival_hour: int
    deadline_hour: int
    interruptible: bool = True


FRAMEWORK_WORKLOADS = (
    # the framework's own §4-style internal workloads
    ("nightly-eval-sweep", "eval", 96.0, 18, 42, True),
    ("ckpt-replay-regression", "regression", 64.0, 10, 58, True),
    ("serving-loadtest", "loadtest", 48.0, 30, 78, True),
    ("artifact-builds", "build", 24.0, 40, 64, False),
)


def default_workloads(week_offset_hours: int = 0) -> list[DeferrableWorkload]:
    return [
        DeferrableWorkload(n, k, ch, a + week_offset_hours,
                           d + week_offset_hours, i)
        for (n, k, ch, a, d, i) in FRAMEWORK_WORKLOADS
    ]


@dataclasses.dataclass
class ScheduleReport:
    placements: dict[str, list[tuple[int, float]]]
    on_demand_cost_naive: float
    on_demand_cost_shifted: float
    savings: float
    savings_frac: float


def schedule(
    base_demand: np.ndarray,
    commitment: float,
    workloads: list[DeferrableWorkload],
) -> ScheduleReport:
    jobs = [
        ts.Job(arrival=w.arrival_hour, work=w.chip_hours,
               deadline=w.deadline_hour, interruptible=w.interruptible,
               deferrable=True)
        for w in workloads
    ]
    out = ts.schedule_jobs(base_demand, commitment, jobs)
    placements = {
        w.name: slices
        for w, (job, slices) in zip(workloads, out["placements"])
    }
    naive = out["on_demand_cost_naive"]
    shifted = out["on_demand_cost_shifted"]
    return ScheduleReport(
        placements=placements,
        on_demand_cost_naive=naive,
        on_demand_cost_shifted=shifted,
        savings=naive - shifted,
        savings_frac=(naive - shifted) / max(naive, 1e-9),
    )
