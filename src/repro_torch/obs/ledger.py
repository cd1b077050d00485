"""Cost-attribution ledger: the rolling replay's bill, decomposed.

A :class:`CostLedger` is a dense (week x entity x source) spend cube
materialized from a telemetry-enabled ``RollingPlanReport``:

    entities   the P planned pools ("cloud/region/family") plus, when the
               convertible band is on, one "cloud:<name>" pseudo-entity
               per cloud — convertible tranches bill at cloud level and
               are re-pinned weekly, so attributing them to a single pool
               would be fiction; the ledger bills them where the invoice
               does and reconciliation stays exact.
    sources    "commit:<sku>" per standard SKU band, "on_demand"
               overflow, the spot band split into "spot_market" /
               "spot_requeue" (the priced requeue penalty) /
               "spot_fallback" (the unavailable-capacity on-demand
               share), and "convertible:<sku>" per convertible SKU.

All arithmetic is float64 over arrays the replay itself emitted (per-SKU
committed spend, usage hours, on-demand volume — see
``core.replan``'s telemetry outputs), so ledger row-sums reconcile with
``RollingPlanReport.weekly_cost()`` to float32 machine precision: the
only divergence is f32 in the replay vs f64 here in summation order, ~1e-7
relative (:meth:`CostLedger.reconcile` enforces 1e-5).

On scenario-batched reports the ledger covers **scenario 0** — the
realized trace — by default, matching the tranche books;
``ledger_from_report(report, scenario=k)`` bills any sampled future
instead, and :meth:`CostLedger.reconcile` then compares against
``weekly_cost[:, k]`` automatically.

This module imports only numpy: it duck-types the report (core imports
obs, never the reverse), so it can also round-trip ledgers from JSONL in
environments where the planner never loads.  Its JSONL format is the JAX
package's (``repro.obs.ledger``), so either package reads the other's
export.  The report's spot lines may be tensors on a card; they are
copied to the host through their ``cpu()`` method.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

SCHEMA_VERSION = 1
HOURS_PER_WEEK = 168


def _host(a) -> np.ndarray:
    """float64 host copy of an array or of a tensor (anything with
    ``cpu()``, duck-typed so that this module imports no torch)."""
    if hasattr(a, "cpu"):
        a = a.cpu().numpy()
    return np.asarray(a, np.float64)


def _sview(a, nd: int, scenario: int = 0):
    """Scenario-``scenario`` view of a per-week report array: batched
    reports carry an N axis at position 1 (nd is the unbatched rank)."""
    if a is None:
        return None
    a = np.asarray(a)
    return a if a.ndim == nd else a[:, scenario]


@dataclasses.dataclass
class CostLedger:
    """Per-week x per-entity x per-source billing decomposition."""

    weeks: np.ndarray            # (S,) absolute week indices
    entities: tuple[str, ...]    # (E,) pools then cloud pseudo-entities
    sources: tuple[str, ...]     # (M,) billing sources
    cost: np.ndarray             # (S, E, M) spend, float64
    volume: np.ndarray           # (S, E, M) attributed chip-hours
    used_hours: np.ndarray       # (S, E) demand served under the level
    idle_hours: np.ndarray       # (S, E) committed-but-unused chip-hours
    utilization: np.ndarray      # (S, E) used / committed chip-hours
    meta: dict = dataclasses.field(default_factory=dict)

    # -- selection ---------------------------------------------------------

    def _sel(self, week, pool, sku, source):
        wsel = np.ones(len(self.weeks), bool)
        if week is not None:
            wsel = self.weeks == week
            if not wsel.any():
                raise KeyError(f"week {week} not in ledger "
                               f"({self.weeks[0]}..{self.weeks[-1]})")
        esel = np.ones(len(self.entities), bool)
        if pool is not None:
            esel = np.asarray([e == pool for e in self.entities])
            if not esel.any():
                raise KeyError(f"unknown entity {pool!r}")
        msel = np.ones(len(self.sources), bool)
        if sku is not None:
            wanted = {sku, f"commit:{sku}", f"convertible:{sku}"}
            msel = np.asarray([s in wanted for s in self.sources])
            if not msel.any():
                raise KeyError(f"unknown sku {sku!r}")
        if source is not None:
            msel = msel & np.asarray([s == source for s in self.sources])
            if not msel.any():
                raise KeyError(f"unknown source {source!r}")
        return wsel, esel, msel

    def attribute(self, *, week=None, pool=None, sku=None,
                  source=None) -> float:
        """Spend for any (week, pool, sku/source) slice; None = marginal.

        ``attribute()`` with no selector is the grand total;
        ``attribute(week=30, pool="aws/us-east-1/c7", sku="3yr_all")``
        is one cell of the bill."""
        wsel, esel, msel = self._sel(week, pool, sku, source)
        return float(self.cost[np.ix_(wsel, esel, msel)].sum())

    def volume_of(self, *, week=None, pool=None, sku=None,
                  source=None) -> float:
        """Chip-hours for the same selectors as :meth:`attribute`."""
        wsel, esel, msel = self._sel(week, pool, sku, source)
        return float(self.volume[np.ix_(wsel, esel, msel)].sum())

    # -- summaries ---------------------------------------------------------

    @property
    def total(self) -> float:
        return float(self.cost.sum())

    def weekly_totals(self) -> np.ndarray:
        """(S,) all-source all-entity spend per week — the reconciliation
        row-sums."""
        return self.cost.sum(axis=(1, 2))

    def by_source(self) -> dict[str, float]:
        tot = self.cost.sum(axis=(0, 1))
        return {s: float(t) for s, t in zip(self.sources, tot)}

    def by_entity(self) -> dict[str, float]:
        tot = self.cost.sum(axis=(0, 2))
        return {e: float(t) for e, t in zip(self.entities, tot)}

    def unit_economics(self) -> dict:
        """The waste/efficiency summary the serving-loop roadmap item
        reports in: where the money went, how much bought capacity sat
        idle, and what a served chip-hour actually cost."""
        by = self.by_source()
        committed = sum(v for s, v in by.items() if s.startswith("commit:"))
        conv = sum(v for s, v in by.items()
                   if s.startswith("convertible:"))
        spot = sum(v for s, v in by.items() if s.startswith("spot_"))
        commit_srcs = [
            i for i, s in enumerate(self.sources)
            if s.startswith(("commit:", "convertible:"))
        ]
        committed_hours = float(self.volume[:, :, commit_srcs].sum())
        used = float(self.used_hours.sum())
        idle = float(self.idle_hours.sum())
        # Utilization is a pool-level quantity; cloud pseudo-entities
        # carry none (their capacity bills where it is re-pinned).
        p_n = self.meta.get("num_pools", len(self.entities))
        return {
            "total_cost": self.total,
            "committed_cost": committed,
            "convertible_cost": conv,
            "on_demand_cost": by.get("on_demand", 0.0),
            "spot_cost": spot,
            "committed_chip_hours": committed_hours,
            "used_chip_hours": used,
            "idle_committed_hours": idle,
            "idle_fraction": (
                idle / committed_hours if committed_hours > 0 else 0.0
            ),
            "utilization_mean": float(self.utilization[:, :p_n].mean()),
            # Zero served hours (a fleet that only ever idled) must not
            # poison downstream aggregation with inf/NaN: report 0.0 and
            # flag the degenerate case instead.
            "cost_per_used_chip_hour": (
                self.total / used if used > 0 else 0.0
            ),
            "idle_only": bool(used <= 0.0),
        }

    # -- reconciliation ----------------------------------------------------

    def reconcile(
        self, report, *, rtol: float = 1e-5,
        scenario: "int | None" = None,
    ) -> dict:
        """Check ledger row-sums against ``report.weekly_cost`` week by
        week.  The ledger re-sums the replay's own f32 billing terms in
        f64, so the residual is pure summation-order noise — ``max_rel``
        lands around 1e-7 and the default 1e-5 gate (f32 machine
        precision across a K-term sum) is generous.

        ``scenario`` picks which column of a batched report's (S, N)
        weekly cost to reconcile against; the default is the scenario
        this ledger was materialized from (``meta["scenario"]``, 0 for
        pre-scenario ledgers), so a ``ledger_from_report(rep, scenario=k)``
        ledger reconciles against its own scenario automatically."""
        k = (
            int(self.meta.get("scenario", 0))
            if scenario is None else int(scenario)
        )
        wc = np.asarray(report.weekly_cost, np.float64)
        if wc.ndim == 2:           # scenario-batched: slice the N axis
            if not 0 <= k < wc.shape[1]:
                raise ValueError(
                    f"scenario index {k} out of range for a report of "
                    f"{wc.shape[1]} scenario(s)"
                )
            wc = wc[:, k]
        elif k != 0:
            raise ValueError(
                f"scenario index {k} out of range for an unbatched report"
            )
        mine = self.weekly_totals()
        if mine.shape != wc.shape:
            raise ValueError(
                f"week axes disagree: ledger {mine.shape}, "
                f"report {wc.shape}"
            )
        err = np.abs(mine - wc)
        rel = err / np.maximum(np.abs(wc), 1.0)
        return {
            "ok": bool(rel.max() <= rtol),
            "rtol": rtol,
            "scenario": k,
            "max_abs": float(err.max()),
            "max_rel": float(rel.max()),
            "worst_week": int(self.weeks[int(rel.argmax())]),
            "total_ledger": float(mine.sum()),
            "total_report": float(wc.sum()),
        }

    # -- serialization -----------------------------------------------------

    def to_jsonl(self, path: str) -> None:
        """Header line, then one row per nonzero (week, entity, source)
        cell, then one usage line per (week, entity)."""
        with open(path, "w") as f:
            f.write(json.dumps({
                "kind": "header",
                "schema_version": SCHEMA_VERSION,
                "weeks": [int(w) for w in self.weeks],
                "entities": list(self.entities),
                "sources": list(self.sources),
                "meta": self.meta,
            }) + "\n")
            nz = np.argwhere((self.cost != 0) | (self.volume != 0))
            for si, ei, mi in nz:
                f.write(json.dumps({
                    "kind": "row",
                    "week": int(self.weeks[si]),
                    "entity": self.entities[ei],
                    "source": self.sources[mi],
                    "cost": float(self.cost[si, ei, mi]),
                    "volume": float(self.volume[si, ei, mi]),
                }) + "\n")
            for si in range(len(self.weeks)):
                for ei in range(len(self.entities)):
                    f.write(json.dumps({
                        "kind": "usage",
                        "week": int(self.weeks[si]),
                        "entity": self.entities[ei],
                        "used_hours": float(self.used_hours[si, ei]),
                        "idle_hours": float(self.idle_hours[si, ei]),
                        "utilization": float(self.utilization[si, ei]),
                    }) + "\n")

    @classmethod
    def from_jsonl(cls, path: str) -> "CostLedger":
        with open(path) as f:
            header = json.loads(f.readline())
            if header.get("kind") != "header":
                raise ValueError(f"{path}: first line is not a ledger "
                                 "header")
            if header["schema_version"] != SCHEMA_VERSION:
                raise ValueError(
                    f"{path}: schema v{header['schema_version']} != "
                    f"v{SCHEMA_VERSION}"
                )
            weeks = np.asarray(header["weeks"])
            entities = tuple(header["entities"])
            sources = tuple(header["sources"])
            widx = {int(w): i for i, w in enumerate(weeks)}
            eidx = {e: i for i, e in enumerate(entities)}
            midx = {s: i for i, s in enumerate(sources)}
            shape = (len(weeks), len(entities), len(sources))
            led = cls(
                weeks=weeks, entities=entities, sources=sources,
                cost=np.zeros(shape), volume=np.zeros(shape),
                used_hours=np.zeros(shape[:2]),
                idle_hours=np.zeros(shape[:2]),
                utilization=np.zeros(shape[:2]),
                meta=header.get("meta", {}),
            )
            for line in f:
                rec = json.loads(line)
                si, ei = widx[rec["week"]], eidx[rec["entity"]]
                if rec["kind"] == "row":
                    mi = midx[rec["source"]]
                    led.cost[si, ei, mi] = rec["cost"]
                    led.volume[si, ei, mi] = rec["volume"]
                elif rec["kind"] == "usage":
                    led.used_hours[si, ei] = rec["used_hours"]
                    led.idle_hours[si, ei] = rec["idle_hours"]
                    led.utilization[si, ei] = rec["utilization"]
        return led

    # -- regression comparison ---------------------------------------------

    def diff(self, other: "CostLedger") -> "LedgerDiff":
        """``self - other`` as a regression comparator: per-source totals
        and per-(entity, source) spend movers, aligned on the union of
        axes (a week/entity/source absent on one side contributes 0)."""
        def cells(led):
            out: dict[tuple[str, str], float] = {}
            tot = led.cost.sum(axis=0)
            for ei, e in enumerate(led.entities):
                for mi, s in enumerate(led.sources):
                    if tot[ei, mi] != 0.0:
                        out[(e, s)] = float(tot[ei, mi])
            return out

        a, b = cells(self), cells(other)
        keys = sorted(set(a) | set(b))
        deltas = {k: a.get(k, 0.0) - b.get(k, 0.0) for k in keys}
        by_source: dict[str, float] = {}
        for (_, s), d in deltas.items():
            by_source[s] = by_source.get(s, 0.0) + d
        return LedgerDiff(
            total_a=self.total, total_b=other.total,
            total_delta=self.total - other.total,
            max_abs_delta=max(
                (abs(d) for d in deltas.values()), default=0.0
            ),
            by_source=by_source,
            cell_deltas=deltas,
        )


@dataclasses.dataclass
class LedgerDiff:
    """Spend deltas between two ledgers (A - B)."""

    total_a: float
    total_b: float
    total_delta: float
    max_abs_delta: float
    by_source: dict[str, float]
    cell_deltas: dict[tuple[str, str], float]

    def top_movers(self, n: int = 10) -> list[tuple[str, str, float]]:
        """The n largest |spend delta| (entity, source) cells.  Zero
        deltas are dropped BEFORE ranking so an empty or all-equal diff
        returns [] instead of zero-padded rows."""
        movers = [
            (e, s, d) for (e, s), d in self.cell_deltas.items()
            if d != 0.0
        ]
        movers.sort(key=lambda t: -abs(t[2]))
        return movers[:n]

    def to_dict(self) -> dict:
        return {
            "total_a": self.total_a,
            "total_b": self.total_b,
            "total_delta": self.total_delta,
            "max_abs_delta": self.max_abs_delta,
            "by_source": self.by_source,
            "top_movers": [
                {"entity": e, "source": s, "delta": d}
                for e, s, d in self.top_movers()
            ],
        }

    def report(self) -> str:
        lines = [
            f"total: {self.total_a:,.2f} vs {self.total_b:,.2f} "
            f"(delta {self.total_delta:+,.2f})",
            "by source:",
        ]
        for s, d in sorted(self.by_source.items(), key=lambda kv: kv[0]):
            lines.append(f"  {s:24s} {d:+14.2f}")
        movers = self.top_movers()
        if movers:
            lines.append("top movers:")
            for e, s, d in movers:
                lines.append(f"  {e:28s} {s:24s} {d:+14.2f}")
        return "\n".join(lines)


def ledger_from_report(report, *, scenario: int = 0) -> CostLedger:
    """Materialize the ledger off a telemetry-enabled rolling report.

    Needs the replay's telemetry outputs (``committed_by_sku``,
    ``used_hours``, ``od_volume``); a report replayed with
    ``telemetry=None`` has none and raises.  ``scenario`` slices the N
    axis of a scenario-batched report the way ``replay_spot_plan``'s
    ``scenario=`` does — the default 0 is the realized trace; nonzero
    indices bill one sampled future."""
    if getattr(report, "committed_by_sku", None) is None:
        raise ValueError(
            "report carries no telemetry outputs — re-run the plan with "
            "telemetry=True (or a TelemetryConfig) to build a CostLedger"
        )
    n = int(getattr(report, "n_scenarios", 1) or 1)
    if not 0 <= scenario < n:
        raise ValueError(
            f"scenario index {scenario} out of range for a report of "
            f"{n} scenario(s)"
        )

    def _sv(a, nd):
        return _sview(a, nd, scenario)

    weeks = np.asarray(report.weeks)
    s_n = len(weeks)
    pool_names = ["/".join(k) for k in report.keys]
    p_n, k_n = len(pool_names), len(report.options)
    entities = list(pool_names)
    sources = [f"commit:{o.name}" for o in report.options] + ["on_demand"]
    has_spot = report.spot_cost is not None
    if has_spot:
        sources += ["spot_market", "spot_requeue", "spot_fallback"]
    has_conv = report.conv_committed_cost is not None
    if has_conv:
        entities += [f"cloud:{c}" for c in report.conv_clouds]
        sources += [f"convertible:{o.name}" for o in report.conv_options]

    e_n, m_n = len(entities), len(sources)
    cost = np.zeros((s_n, e_n, m_n))
    volume = np.zeros((s_n, e_n, m_n))
    src_i = {s: i for i, s in enumerate(sources)}

    # Standard commitment bands: the replay's own per-SKU weekly spend.
    committed_k = _sv(report.committed_by_sku, 3).astype(np.float64)
    active = _sv(report.active, 3).astype(np.float64)
    cost[:, :p_n, :k_n] = committed_k
    volume[:, :p_n, :k_n] = active * HOURS_PER_WEEK

    # On-demand overflow: the report arrays verbatim.
    od_cost = _sv(report.on_demand_cost, 2).astype(np.float64)
    cost[:, :p_n, src_i["on_demand"]] = od_cost
    od_vol = _sv(report.od_volume, 2)
    if od_vol is not None:
        volume[:, :p_n, src_i["on_demand"]] = od_vol

    level = active.sum(-1)
    if has_spot:
        # Decompose the effective spot rate back into its pricing terms:
        #   rate = a * (market + hazard * requeue_hours * od) + (1-a) * od
        # (see ``core.spot.effective_spot_rate``) — fallback is the
        # unavailability share billed at on-demand, requeue the priced
        # preemption penalty, market the residual so the three sum to the
        # reported spot spend exactly.
        lines = report.spot_lines
        a = _host(lines.availability)
        hazard = _host(lines.params.hazard)
        if a.shape[0] == n * p_n:
            # Batched replays keep spot lines per flattened (N x P) row;
            # take this scenario's block to match the (S, P) views above.
            a = a[scenario * p_n:(scenario + 1) * p_n]
            hazard = hazard[scenario * p_n:(scenario + 1) * p_n]
        od = float(report.od_rate)
        rq = float(report.spot_config.requeue_hours)
        vol = _sv(report.spot_volume, 2).astype(np.float64)
        spot_cost = _sv(report.spot_cost, 2).astype(np.float64)
        fallback = (1.0 - a)[None, :] * od * vol
        requeue = (a * hazard)[None, :] * rq * od * vol
        market = spot_cost - fallback - requeue
        cost[:, :p_n, src_i["spot_market"]] = market
        cost[:, :p_n, src_i["spot_requeue"]] = requeue
        cost[:, :p_n, src_i["spot_fallback"]] = fallback
        volume[:, :p_n, src_i["spot_market"]] = vol

    if has_conv:
        conv_k = _sv(report.conv_committed_by_sku, 3).astype(np.float64)
        conv_active = _sv(report.conv_active, 3).astype(np.float64)
        for ci in range(len(report.conv_clouds)):
            for ki, o in enumerate(report.conv_options):
                mi = src_i[f"convertible:{o.name}"]
                cost[:, p_n + ci, mi] = conv_k[:, ci, ki]
                volume[:, p_n + ci, mi] = (
                    conv_active[:, ci, ki] * HOURS_PER_WEEK
                )
        # A pool's effective level includes its re-pinned allocation.
        level = level + _sv(report.conv_alloc, 2).astype(np.float64)

    used = np.zeros((s_n, e_n))
    idle = np.zeros((s_n, e_n))
    util = np.zeros((s_n, e_n))
    used[:, :p_n] = _sv(report.used_hours, 2)
    idle[:, :p_n] = np.maximum(level * HOURS_PER_WEEK - used[:, :p_n], 0.0)
    util[:, :p_n] = _sv(report.utilization, 2)

    meta = {
        "policy": report.policy_name,
        "cadence_weeks": int(report.cadence_weeks),
        "start_weeks": int(report.start_weeks),
        "horizon_weeks": int(report.horizon_weeks),
        "od_rate": float(report.od_rate),
        "n_scenarios": int(report.n_scenarios),
        "scenario": int(scenario),
        "num_pools": p_n,
    }
    if getattr(report, "kernel_stats", None) is not None:
        meta["kernel_stats"] = report.kernel_stats.to_dict()
    return CostLedger(
        weeks=weeks, entities=tuple(entities), sources=tuple(sources),
        cost=cost, volume=volume,
        used_hours=used, idle_hours=idle, utilization=util,
        meta=meta,
    )
