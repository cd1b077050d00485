"""Forecast-calibration telemetry: did the weekly fractile bands cover
realized demand?

The chance-constrained machinery (spot caps today, the planned
overcommitment layer) prices risk off the weekly forecast fractiles; an
uncalibrated band makes those constraints fiction.  With
``TelemetryConfig(calibration=True)`` the rolling replay emits each week's
forecast fractile levels (``core.forecast.anchored_fractile_levels`` —
trailing-window empirical quantiles, the deployed band) scored against the
demand the replay actually billed (on the replay's device, in float64:
:func:`calibration_from_scores` builds the cube; the host-side
:func:`calibration_from_arrays` scores plain arrays the same way):

    hits[s, n, p, q]     share of week s's 168 realized hours at or below
                         the q-fractile level — the per-cell coverage
                         indicator (a calibrated band has E[hit] == q)
    pinball[s, n, p, q]  pinball (quantile) loss of the level against the
                         realized hours — the proper score for fractiles

materialized as a :class:`CalibrationCube` with empirical-vs-nominal
coverage, interval widths, a ``diff()`` regression comparator, an exact
JSONL round-trip (same guarantee as the cost ledger's), and the
``python -m repro_torch.obs calib`` CLI gate.

Scenario-batched replays score every scenario out of the ONE replay: the
cube carries an N axis, so per-scenario-family calibration distributions
(``scenario_coverage()``) come for free next to the pooled summary.

All arithmetic here is float64 numpy; this module imports only numpy
(core imports obs, never the reverse).
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

SCHEMA_VERSION = 1
HOURS_PER_WEEK = 168


@dataclasses.dataclass
class CalibrationCube:
    """Per (week x scenario x pool x fractile) forecast-calibration scores.

    Axes: ``weeks`` (S,) absolute week indices, scenario axis N (1 on
    unbatched replays), ``entities`` (P,) pool names, ``fractiles`` (Q,)
    nominal coverage levels."""

    weeks: np.ndarray             # (S,)
    entities: tuple[str, ...]     # (P,)
    fractiles: tuple[float, ...]  # (Q,)
    levels: np.ndarray            # (S, N, P, Q) forecast fractile levels
    hits: np.ndarray              # (S, N, P, Q) in-week coverage share
    pinball: np.ndarray           # (S, N, P, Q) pinball loss, float64
    realized_mean: np.ndarray     # (S, N, P) realized weekly mean demand
    realized_peak: np.ndarray     # (S, N, P) realized weekly peak demand
    meta: dict = dataclasses.field(default_factory=dict)

    # -- shape -------------------------------------------------------------

    @property
    def n_scenarios(self) -> int:
        return int(self.levels.shape[1])

    def _scen(self, scenario: "int | None") -> np.ndarray:
        """Hit cube restricted to one scenario, or all pooled."""
        if scenario is None:
            return self.hits
        n = self.n_scenarios
        if not 0 <= scenario < n:
            raise ValueError(
                f"scenario index {scenario} out of range for a cube of "
                f"{n} scenario(s)"
            )
        return self.hits[:, scenario:scenario + 1]

    # -- coverage ----------------------------------------------------------

    def coverage(self, scenario: "int | None" = None) -> np.ndarray:
        """(Q,) empirical coverage per fractile: mean hit share over weeks
        x pools (x scenarios when ``scenario`` is None) — a calibrated
        band lands on the nominal fractile."""
        return self._scen(scenario).mean(axis=(0, 1, 2))

    def coverage_error(self, scenario: "int | None" = None) -> np.ndarray:
        """(Q,) signed empirical - nominal coverage."""
        return self.coverage(scenario) - np.asarray(self.fractiles)

    @property
    def max_coverage_drift(self) -> float:
        """max_q |empirical - nominal| pooled over every scenario — the
        scalar the ``--fail-above`` CLI gate compares."""
        return float(np.abs(self.coverage_error()).max())

    def scenario_coverage(self) -> np.ndarray:
        """(N, Q) per-scenario empirical coverage — the per-family
        calibration distribution a batched replay yields from one replay."""
        return self.hits.mean(axis=(0, 2))

    def interval_width(
        self, lo: "float | None" = None, hi: "float | None" = None
    ) -> float:
        """Mean forecast-band width between two carried fractiles
        (default: the outermost pair) in demand units."""
        lo = self.fractiles[0] if lo is None else lo
        hi = self.fractiles[-1] if hi is None else hi
        qi = {q: i for i, q in enumerate(self.fractiles)}
        if lo not in qi or hi not in qi:
            raise KeyError(
                f"fractile pair ({lo}, {hi}) not carried; cube has "
                f"{self.fractiles}"
            )
        return float(
            (self.levels[..., qi[hi]] - self.levels[..., qi[lo]]).mean()
        )

    def pinball_mean(self) -> np.ndarray:
        """(Q,) mean pinball loss per fractile over all cells."""
        return self.pinball.mean(axis=(0, 1, 2))

    def summary(self) -> dict:
        cov = self.coverage()
        err = self.coverage_error()
        worst = int(np.abs(err).argmax())
        out = {
            "weeks": int(len(self.weeks)),
            "entities": int(len(self.entities)),
            "n_scenarios": self.n_scenarios,
            "fractiles": list(self.fractiles),
            "coverage": [float(c) for c in cov],
            "coverage_error": [float(e) for e in err],
            "max_coverage_drift": self.max_coverage_drift,
            "worst_fractile": float(self.fractiles[worst]),
            "pinball_mean": [float(p) for p in self.pinball_mean()],
            "interval_width": self.interval_width(),
        }
        out.update({k: v for k, v in self.meta.items()
                    if k in ("policy", "scenario_family")})
        return out

    def report(self) -> str:
        lines = [
            f"calibration: {len(self.weeks)} weeks x "
            f"{len(self.entities)} pools x {self.n_scenarios} scenario(s)",
            f"{'fractile':>10s} {'coverage':>10s} {'error':>9s} "
            f"{'pinball':>12s}",
        ]
        cov, err, pb = (
            self.coverage(), self.coverage_error(), self.pinball_mean()
        )
        for i, q in enumerate(self.fractiles):
            lines.append(
                f"{q:10.3f} {cov[i]:10.3f} {err[i]:+9.3f} {pb[i]:12.4f}"
            )
        lines.append(
            f"max |coverage drift| {self.max_coverage_drift:.4f}; "
            f"mean band width {self.interval_width():.3f}"
        )
        return "\n".join(lines)

    # -- regression comparison ---------------------------------------------

    def diff(self, other: "CalibrationCube") -> "CalibrationDiff":
        """``self - other`` as a regression comparator on the pooled
        per-fractile coverage and pinball scores (cubes must carry the
        same fractile set; week/pool axes may differ)."""
        if tuple(self.fractiles) != tuple(other.fractiles):
            raise ValueError(
                f"fractile axes disagree: {self.fractiles} vs "
                f"{other.fractiles}"
            )
        cov_d = self.coverage() - other.coverage()
        pb_d = self.pinball_mean() - other.pinball_mean()
        return CalibrationDiff(
            fractiles=tuple(self.fractiles),
            coverage_delta={
                float(q): float(d) for q, d in zip(self.fractiles, cov_d)
            },
            pinball_delta={
                float(q): float(d) for q, d in zip(self.fractiles, pb_d)
            },
            max_abs_coverage_delta=float(np.abs(cov_d).max()),
            drift_a=self.max_coverage_drift,
            drift_b=other.max_coverage_drift,
        )

    # -- serialization -----------------------------------------------------

    def to_jsonl(self, path: str) -> None:
        """Header line, then one row per (week, scenario, entity) cell
        carrying the full fractile vectors.  Floats serialize via json's
        repr round-trip, so ``from_jsonl`` is exact — the ledger's
        guarantee."""
        with open(path, "w") as f:
            f.write(json.dumps({
                "kind": "header",
                "schema_version": SCHEMA_VERSION,
                "weeks": [int(w) for w in self.weeks],
                "entities": list(self.entities),
                "fractiles": list(self.fractiles),
                "n_scenarios": self.n_scenarios,
                "meta": self.meta,
            }) + "\n")
            for si in range(len(self.weeks)):
                for ni in range(self.n_scenarios):
                    for ei in range(len(self.entities)):
                        f.write(json.dumps({
                            "kind": "row",
                            "week": int(self.weeks[si]),
                            "scenario": ni,
                            "entity": self.entities[ei],
                            "levels": [
                                float(v) for v in self.levels[si, ni, ei]
                            ],
                            "hits": [
                                float(v) for v in self.hits[si, ni, ei]
                            ],
                            "pinball": [
                                float(v) for v in self.pinball[si, ni, ei]
                            ],
                            "realized_mean": float(
                                self.realized_mean[si, ni, ei]
                            ),
                            "realized_peak": float(
                                self.realized_peak[si, ni, ei]
                            ),
                        }) + "\n")

    @classmethod
    def from_jsonl(cls, path: str) -> "CalibrationCube":
        with open(path) as f:
            header = json.loads(f.readline())
            if header.get("kind") != "header":
                raise ValueError(
                    f"{path}: first line is not a calibration header"
                )
            if header["schema_version"] != SCHEMA_VERSION:
                raise ValueError(
                    f"{path}: schema v{header['schema_version']} != "
                    f"v{SCHEMA_VERSION}"
                )
            weeks = np.asarray(header["weeks"])
            entities = tuple(header["entities"])
            fractiles = tuple(header["fractiles"])
            n = int(header["n_scenarios"])
            widx = {int(w): i for i, w in enumerate(weeks)}
            eidx = {e: i for i, e in enumerate(entities)}
            shape = (len(weeks), n, len(entities), len(fractiles))
            cube = cls(
                weeks=weeks, entities=entities, fractiles=fractiles,
                levels=np.zeros(shape), hits=np.zeros(shape),
                pinball=np.zeros(shape),
                realized_mean=np.zeros(shape[:3]),
                realized_peak=np.zeros(shape[:3]),
                meta=header.get("meta", {}),
            )
            for line in f:
                rec = json.loads(line)
                si = widx[rec["week"]]
                ni = rec["scenario"]
                ei = eidx[rec["entity"]]
                cube.levels[si, ni, ei] = rec["levels"]
                cube.hits[si, ni, ei] = rec["hits"]
                cube.pinball[si, ni, ei] = rec["pinball"]
                cube.realized_mean[si, ni, ei] = rec["realized_mean"]
                cube.realized_peak[si, ni, ei] = rec["realized_peak"]
        return cube


@dataclasses.dataclass
class CalibrationDiff:
    """Calibration deltas between two cubes (A - B)."""

    fractiles: tuple[float, ...]
    coverage_delta: dict[float, float]
    pinball_delta: dict[float, float]
    max_abs_coverage_delta: float
    drift_a: float
    drift_b: float

    def to_dict(self) -> dict:
        return {
            "fractiles": list(self.fractiles),
            "coverage_delta": {
                str(q): d for q, d in self.coverage_delta.items()
            },
            "pinball_delta": {
                str(q): d for q, d in self.pinball_delta.items()
            },
            "max_abs_coverage_delta": self.max_abs_coverage_delta,
            "drift_a": self.drift_a,
            "drift_b": self.drift_b,
        }

    def report(self) -> str:
        lines = [
            f"coverage drift: A {self.drift_a:.4f} vs B {self.drift_b:.4f}",
            f"{'fractile':>10s} {'d-coverage':>11s} {'d-pinball':>12s}",
        ]
        for q in self.fractiles:
            lines.append(
                f"{q:10.3f} {self.coverage_delta[q]:+11.4f} "
                f"{self.pinball_delta[q]:+12.4f}"
            )
        lines.append(
            f"max |coverage delta| {self.max_abs_coverage_delta:.4f}"
        )
        return "\n".join(lines)


def calibration_from_arrays(
    weeks,
    entities,
    fractiles,
    levels,
    realized,
    *,
    n_scenarios: int = 1,
    meta: "dict | None" = None,
) -> CalibrationCube:
    """Score replay-emitted fractile ``levels`` (S, N*P, Q) against the
    ``realized`` weekly demand hours (S, N*P, H) and build the cube.

    All scoring runs in float64 so the cube is exactly reproducible from
    its JSONL export; the arithmetic is the JAX package's, bit for bit.
    The rolling replay scores on its own device instead (the same algebra
    week by week, see ``core.replan``) and calls
    :func:`calibration_from_scores`."""
    levels = np.asarray(levels, np.float64)
    realized = np.asarray(realized, np.float64)
    if realized.shape[:2] != levels.shape[:2]:
        raise ValueError(
            f"levels {levels.shape} and realized {realized.shape} "
            "disagree on (weeks, rows)"
        )
    q = np.asarray(fractiles, np.float64)
    d = realized[:, :, :, None]                      # (S, R, H, 1)
    lv = levels[:, :, None, :]                       # (S, R, 1, Q)
    hits = (d <= lv).mean(axis=2)                    # (S, R, Q)
    over = np.maximum(d - lv, 0.0)
    under = np.maximum(lv - d, 0.0)
    pinball = (q * over + (1.0 - q) * under).mean(axis=2)
    return calibration_from_scores(
        weeks, entities, fractiles, levels, hits, pinball,
        realized.mean(axis=-1), realized.max(axis=-1),
        n_scenarios=n_scenarios, meta=meta,
    )


def calibration_from_scores(
    weeks,
    entities,
    fractiles,
    levels,
    hits,
    pinball,
    realized_mean,
    realized_peak,
    *,
    n_scenarios: int = 1,
    meta: "dict | None" = None,
) -> CalibrationCube:
    """The cube of scores already computed: ``levels``, ``hits`` and
    ``pinball`` (S, N*P, Q), ``realized_mean`` and ``realized_peak``
    (S, N*P), rows scenario-major."""
    levels = np.asarray(levels, np.float64)
    s_n, r_n, _ = levels.shape
    p_n = r_n // n_scenarios
    if p_n * n_scenarios != r_n or p_n != len(entities):
        raise ValueError(
            f"{r_n} rows do not factor into {n_scenarios} scenario(s) x "
            f"{len(entities)} entities"
        )

    def cube_axes(a):                                # (S, R, ...) -> (S, N, P, ...)
        a = np.asarray(a, np.float64)
        return a.reshape(s_n, n_scenarios, p_n, *a.shape[2:])

    return CalibrationCube(
        weeks=np.asarray(weeks),
        entities=tuple(entities),
        fractiles=tuple(float(v) for v in fractiles),
        levels=cube_axes(levels),
        hits=cube_axes(hits),
        pinball=cube_axes(pinball),
        realized_mean=cube_axes(realized_mean),
        realized_peak=cube_axes(realized_peak),
        meta=dict(meta or {}),
    )
