"""Caller-side span recorder: the timed phases of a plan, a tournament or
a benchmark, recorded by whoever calls them.

    rec = SpanRecorder()                       # CUDA events on the card
    with rec.span("tournament/rolling_portfolio", phase="execute"):
        report = tn.run_tournament(...)
    print(rec.report())

Spans nest (the recorder keeps a stack, so ``report()`` renders a tree)
and carry a coarse *phase* tag: ``"compile"`` (kernel builds, first-call
set-up), ``"execute"`` (device work), ``"host"`` (numpy, report assembly,
I/O).

The recorder reads no clock of its own.  Given ``clock=`` (any callable
returning seconds, such as a caller's monotonic counter, or a fake one in
tests) it reads that at entry and exit, as the JAX package's recorder
does.  Without one it records a pair of ``torch.cuda.Event(enable_timing=
True)`` per span on the current stream of its device (the card by default;
a CPU recorder needs ``clock=``): a span then measures the device work
queued between its entry and its exit, and the host returns from the
``with`` block without waiting.  Event times are read when a summary is
asked for (:meth:`SpanRecorder.resolve`, which ``report()``,
``summary()``, ``by_phase()``, ``total_s`` and the exports call).

Core modules that accept a recorder (``run_tournament(spans=...)``,
``TelemetryConfig.spans``) call only :func:`span`, and ``span(None, ...)``
does nothing, so ``spans=None`` paths do no timing work at all.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json

import torch

from repro_torch.device import resolve_device

PHASES = ("compile", "execute", "host")


@dataclasses.dataclass
class Span:
    """One recorded interval.  ``parent`` indexes into the recorder's span
    list (-1 for roots); ``depth`` is the nesting level at entry.  Under
    CUDA events ``start_s`` counts from the recorder's first span."""

    name: str
    phase: str
    start_s: float
    duration_s: float = 0.0
    depth: int = 0
    parent: int = -1

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "phase": self.phase,
            "start_s": self.start_s,
            "duration_s": self.duration_s,
            "depth": self.depth,
            "parent": self.parent,
        }


class SpanRecorder:
    """Append-only span log with a nesting stack, timed by ``clock`` or,
    without one, by CUDA events on ``device`` (module docstring)."""

    def __init__(self, clock=None, *,
                 device: "torch.device | str | None" = None):
        self._clock = clock
        self.device = None
        if clock is None:
            dev = resolve_device(device)
            if dev.type != "cuda":
                raise ValueError(
                    "a SpanRecorder without clock= times by CUDA events and "
                    f"needs a CUDA device, got {dev}; pass clock= to time "
                    "on the host"
                )
            self.device = dev
        self.spans: list[Span] = []
        self._stack: list[int] = []
        self._events: list[list] = []     # [start, end | None] per span
        self._origin = None

    @property
    def timer(self) -> str:
        """``"clock"`` or ``"cuda_events"``."""
        return "clock" if self._clock is not None else "cuda_events"

    def _event(self):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    @contextlib.contextmanager
    def span(self, name: str, phase: str = "host"):
        """Record ``name`` for the duration of the ``with`` body."""
        if phase not in PHASES:
            raise ValueError(f"unknown phase {phase!r}; known: {PHASES}")
        idx = len(self.spans)
        if self._clock is not None:
            start = self._clock()
        else:
            if self._origin is None:
                self._origin = self._event()
            self._events.append([self._event(), None])
            start = 0.0
        self.spans.append(Span(
            name=name, phase=phase, start_s=start,
            depth=len(self._stack),
            parent=self._stack[-1] if self._stack else -1,
        ))
        self._stack.append(idx)
        try:
            yield self.spans[idx]
        finally:
            self._stack.pop()
            if self._clock is not None:
                self.spans[idx].duration_s = (
                    self._clock() - self.spans[idx].start_s
                )
            else:
                self._events[idx][1] = self._event()

    def resolve(self, first: int = 0) -> "SpanRecorder":
        """Fill in the times of every closed span from index ``first`` on
        from its events (a no-op under a clock); waits for the device to
        reach each end event."""
        if self._clock is None:
            for i, (start, end) in enumerate(self._events[first:], first):
                if end is None:          # still open
                    continue
                end.synchronize()
                self.spans[i].start_s = (
                    self._origin.elapsed_time(start) / 1e3)
                self.spans[i].duration_s = start.elapsed_time(end) / 1e3
        return self

    # -- summaries ---------------------------------------------------------

    @property
    def total_s(self) -> float:
        """Time covered by root spans (nested spans not double-counted)."""
        self.resolve()
        return sum(s.duration_s for s in self.spans if s.parent == -1)

    def summary(self) -> dict[str, dict]:
        """name -> {count, total_s, mean_s, phase} over all spans."""
        self.resolve()
        out: dict[str, dict] = {}
        for s in self.spans:
            agg = out.setdefault(
                s.name, {"count": 0, "total_s": 0.0, "phase": s.phase}
            )
            agg["count"] += 1
            agg["total_s"] += s.duration_s
        for agg in out.values():
            agg["mean_s"] = agg["total_s"] / agg["count"]
        return out

    def by_phase(self) -> dict[str, float]:
        """phase -> total seconds (nested spans attributed to their own
        phase; a parent's *self* time is its duration minus its children)."""
        self.resolve()
        child_time: dict[int, float] = {}
        for s in self.spans:
            if s.parent >= 0:
                child_time[s.parent] = (
                    child_time.get(s.parent, 0.0) + s.duration_s
                )
        out = {p: 0.0 for p in PHASES}
        for i, s in enumerate(self.spans):
            self_s = s.duration_s - child_time.get(i, 0.0)
            out[s.phase] += max(self_s, 0.0)
        return out

    def report(self) -> str:
        """The span tree, one line per span, indented by nesting depth."""
        self.resolve()
        lines = ["span                                   phase     seconds"]
        for s in self.spans:
            label = "  " * s.depth + s.name
            lines.append(f"{label:38s} {s.phase:9s} {s.duration_s:9.4f}")
        for p, t in self.by_phase().items():
            lines.append(f"{'total ' + p:38s} {'':9s} {t:9.4f}")
        return "\n".join(lines)

    def to_dicts(self) -> list[dict]:
        self.resolve()
        return [s.to_dict() for s in self.spans]

    def to_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(
                {"spans": self.to_dicts(), "by_phase": self.by_phase(),
                 "timer": self.timer},
                f, indent=2,
            )


@contextlib.contextmanager
def span(recorder: SpanRecorder | None, name: str, phase: str = "host"):
    """``recorder.span(...)`` when a recorder is present, a no-op
    otherwise: the one-liner call sites use, so ``spans=None`` costs
    nothing."""
    if recorder is None:
        yield None
        return
    with recorder.span(name, phase=phase) as s:
        yield s
