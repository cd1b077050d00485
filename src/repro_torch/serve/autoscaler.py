"""Free-pool replica autoscaler (paper §5 wired into the serving runtime).

The port of ``repro.serve.autoscaler``.  It keeps a pool of *warm* engine
replicas sized by the newsvendor-optimal forecast
(:func:`repro_torch.core.freepool.predicted_pool`, on ``device``): demand
above warm capacity waits out the simulated CSP provisioning latency
(paper Fig. 10, minutes-scale p99), demand below wastes replica-hours.
The tick simulation and its SLO accounting are host-side integer
bookkeeping, the reference's unchanged: the paper's cost function
c(t) = p_o * over + p_u * under per tick.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import freepool as fp


@dataclasses.dataclass
class AutoscalerConfig:
    pool: fp.FreePoolConfig = dataclasses.field(
        default_factory=fp.FreePoolConfig)
    provision_latency: int = 3      # ticks to bring up a cold replica
    window: int = 24


@dataclasses.dataclass
class AutoscalerStats:
    slo_misses: int = 0
    served_warm: int = 0
    replica_ticks: int = 0          # warm replica-time paid for
    cost: float = 0.0


class FreePoolAutoscaler:
    """Discrete-tick simulation driver around engine replicas.  ``device``
    is where :meth:`plan` fits the forecaster (``None``: the card, which
    raises without one; ``"cpu"`` runs the plain path)."""

    def __init__(self, cfg: AutoscalerConfig,
                 *, device: "str | None" = None):
        self.cfg = cfg
        self.device = device
        self.warm = 0
        self.pending: list[int] = []   # ticks remaining per cold start
        self.stats = AutoscalerStats()

    def plan(self, history: np.ndarray, horizon: int) -> np.ndarray:
        """Forecast-driven pool size for the next ``horizon`` ticks, as a
        float32 numpy array (one copy to the host)."""
        pool = fp.predicted_pool(np.array(history, dtype=np.float32),
                                 horizon, self.cfg.pool, device=self.device)
        return pool.cpu().numpy()

    def step(self, target: float, demand: float):
        """One tick: scale toward ``target`` warm replicas, then serve
        ``demand`` concurrent requests."""
        # finish cold starts
        self.pending = [t - 1 for t in self.pending]
        arrived = sum(1 for t in self.pending if t <= 0)
        self.warm += arrived
        self.pending = [t for t in self.pending if t > 0]

        want = int(np.ceil(target))
        in_flight = self.warm + len(self.pending)
        if want > in_flight:
            self.pending.extend(
                [self.cfg.provision_latency] * (want - in_flight))
        elif want < self.warm:
            self.warm = want  # deprovision is fast (paper §5.1)

        served = min(self.warm, int(np.ceil(demand)))
        missed = max(0, int(np.ceil(demand)) - served)
        over = max(0, self.warm - int(np.ceil(demand)))
        self.stats.slo_misses += missed
        self.stats.served_warm += served
        self.stats.replica_ticks += self.warm
        self.stats.cost += (
            self.cfg.pool.p_over * over + self.cfg.pool.p_under * missed)

    def run(self, history: np.ndarray, demand_future: np.ndarray,
            *, static_size: float | None = None) -> AutoscalerStats:
        """Simulate the full horizon with forecast-driven (default) or
        static pool sizing; returns accumulated stats (paper Fig. 12)."""
        horizon = len(demand_future)
        if static_size is None:
            targets = self.plan(history, horizon)
        else:
            targets = np.full(horizon, static_size)
        for t in range(horizon):
            self.step(float(targets[t]), float(demand_future[t]))
        return self.stats
