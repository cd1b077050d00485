"""Trainer: the training loop with checkpoint/restart, a straggler
watchdog and deterministic data resume.

The port of ``repro.train.trainer``.  Fault-tolerance model (one card):
  * ``fit`` checkpoints params, optimizer state and the data position
    asynchronously every ``ckpt_every`` steps; a crash at any point resumes
    from the newest complete checkpoint (atomic renames guarantee
    completeness) and the data pipeline skips ahead deterministically;
    the step is deterministic on the card (the embedding's gradient is
    summed in a fixed order, ``models.common.embed``), so a restart
    reproduces the uninterrupted run's losses bit for bit;
  * the straggler watchdog compares each step's time against a running
    EMA; slow steps past ``straggler_factor`` raise a counter and call the
    (pluggable) mitigation hook.

Step times come from the port's span recorder (``obs.spans``), the one
place the port reads time: CUDA events on the card, or the ``clock=``
given to the :class:`Trainer` (a CPU model needs one; there is no
fallback).  The model's device is the trainer's: a model built with
``device=None`` is on the card.  The elastic re-mesh restore needs
several cards and is not ported (ROADMAP item 12).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.models.model import Model
from repro_torch.obs.spans import SpanRecorder
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.step import build_train_step, init_train_state, to_device


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    straggler_factor: float = 3.0
    straggler_ema: float = 0.9
    opt: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)


class StragglerWatchdog:
    def __init__(self, factor: float, ema: float):
        self.factor = factor
        self.ema_coef = ema
        self.ema: float | None = None
        self.flagged_steps: list[int] = []
        self.mitigations = 0

    def observe(self, step: int, dt: float,
                mitigate: Callable[[], None] | None = None):
        if self.ema is None:
            self.ema = dt
            return False
        slow = dt > self.factor * self.ema
        if slow:
            self.flagged_steps.append(step)
            self.mitigations += 1
            if mitigate is not None:
                mitigate()
        # slow steps don't poison the EMA
        self.ema = self.ema_coef * self.ema + (1 - self.ema_coef) * (
            min(dt, self.factor * self.ema)
        )
        return slow


class Trainer:
    def __init__(
        self,
        model: Model,
        pipeline: TokenPipeline,
        cfg: TrainerConfig,
        ckpt_dir: str,
        *,
        clock: Callable[[], float] | None = None,
    ):
        self.model = model
        self.pipeline = pipeline
        self.cfg = cfg
        self.ckpt = CheckpointManager(ckpt_dir)
        self.watchdog = StragglerWatchdog(
            cfg.straggler_factor, cfg.straggler_ema
        )
        # one span per step, on the model's card or by the caller's clock
        self.spans = SpanRecorder(clock=clock, device=model.device)
        self.step_fn = build_train_step(model, cfg.opt)
        self.losses: list[float] = []
        self.step = 0
        self.params = None
        self.opt_state = None

    # ------------------------------------------------------------ lifecycle
    def init_or_restore(self, generator: torch.Generator | None = None):
        """Initialize from ``generator`` (default: seed 0 on the model's
        device), then load the newest checkpoint if there is one; returns
        the step training resumes at."""
        if generator is None:
            generator = torch.Generator(device=self.model.device)
            generator.manual_seed(0)
        params, opt_state = init_train_state(self.model, generator)
        restored = self.ckpt.restore_latest(
            {"params": params, "opt": opt_state}
        )
        if restored is None:
            self.params, self.opt_state, self.step = params, opt_state, 0
        else:
            step, tree, meta = restored
            with torch.no_grad():
                for name, p in params.items():
                    p.copy_(tree["params"][name])
            self.params, self.opt_state = params, tree["opt"]
            self.step = step
            self.pipeline.skip_to(meta.get("data_step", step))
        return self.step

    def _checkpoint(self):
        self.ckpt.save_async(
            self.step,
            {"params": self.params, "opt": self.opt_state},
            metadata={"data_step": self.pipeline.step,
                      "losses_tail": self.losses[-5:]},
        )

    # ------------------------------------------------------------------ fit
    def fit(self, max_steps: int | None = None,
            fail_at_step: int | None = None):
        """Run to cfg.total_steps (or ``max_steps``).  ``fail_at_step``
        injects a crash for the fault-tolerance tests."""
        total = max_steps or self.cfg.total_steps
        try:
            while self.step < total:
                if fail_at_step is not None and self.step == fail_at_step:
                    raise RuntimeError(
                        f"injected failure at step {self.step}"
                    )
                batch = to_device(self.pipeline.next_batch(),
                                  self.model.device)
                idx = len(self.spans.spans)
                with self.spans.span("train/step", phase="execute") as sp:
                    loss, self.params, self.opt_state = self.step_fn(
                        self.params, self.opt_state, batch
                    )
                    loss = float(loss)  # waits for the device's result
                self.spans.resolve(first=idx)
                self.watchdog.observe(self.step, sp.duration_s)
                self.losses.append(loss)
                self.step += 1
                if self.step % self.cfg.ckpt_every == 0:
                    self._checkpoint()
        finally:
            # Graceful-shutdown flush: drain any pending async save before a
            # failure escapes the loop.  Without it a crash races the
            # checkpoint writer thread and restart may resume from the
            # previous step.
            self.ckpt.wait()
        return self.losses

    def step_seconds(self) -> list[float]:
        """Each step's time so far, in order (this trainer's steps)."""
        return [s.duration_s for s in self.spans.resolve().spans
                if s.name == "train/step"]
