"""Rolling weekly re-planning over pool portfolios (paper §3.3.3-§3.3.4).

Algorithm 1 as the paper operates it: re-run the purchase decision every
week as new demand history arrives, buying only increments on top of what
is already committed (commitments are added any week and only expire):

    for each week w (from ``start_weeks``):
        roll off tranches whose term ends at w
        re-fit the forecaster on the demand prefix [0, w·168)
        forecast ``horizon_weeks`` ahead; solve the per-horizon portfolio
            thresholds (Algorithm 1 steps 2-4) for every pool
        on decision weeks (every ``cadence_weeks``): buy, per pool per
            option, the increment that lifts the active width to target
        bill the week: every active tranche at its committed rate,
            demand above the stack top at the on-demand rate (with a spot
            band: on-demand up to the week's spot floor, the effective
            spot rate above it)

The reference runs this as one ``lax.scan``.  Here it is a Python loop over
weeks that carries ``(active (P, K), rolloff (P, K, W), pstate)`` as tensors
on the replay's device.  Nothing inside the loop reads a device value back
on the host: the weekly cadence rule is host arithmetic on the week number,
the breach cadence's per-row decision stays a device tensor that masks the
buys, and the per-week outputs are stacked on the device and copied to the
host in one buffer after the loop (:func:`_to_host`).

``telemetry=`` adds outputs to the same loop (per-SKU spend, usage,
on-demand volume; each week's fractile levels and their calibration
scores; roll-offs and binding flags) and materializes the
``repro_torch.obs`` records from them; it changes nothing that is bought
or billed.  ``cadence="breach"`` re-solves only when last week's demand
left the band held since the last decision, ``irls_carry=True`` carries
the IRLS moments in the policy state (:mod:`repro_torch.core.policy`).

``solver="grid"`` solves each week's per-horizon prefixes with the grid
solver on the commitment sweep; on the card that is the hand-written CUDA
kernel, one launch per replayed week of each replay.  ``solver="quantile"``
uses sorts and gathers.  ``backend="scan"`` refits from prefix sums of the
normal equations, ``backend="loop"`` re-accumulates them every week (the
independent implementation the reference's python-loop replay is).

The report compares three operating points on the same evaluation window:
the rolling replay; the one-shot baseline (the same replay with a single
decision week, with the same spot band); and hindsight (the optimal
constant stack on the realized demand, short tranches repurchased
back-to-back; commitments only).

``spot=`` adds the spot band, the fast half of the capacity split: every
week the forecast's per-horizon spot floors (the envelope entry against
the chance-constraint volume cap, sorts and gathers only) truncate the
per-horizon committed levels, and the horizon-1 floor is that week's
spot decision, never carried.

``migration=`` makes the weekly forecasts turnover-aware
(``core.migration``): the structural state fits pair totals in
old-equivalent units, a share prefix state rides beside it, and each
week's per-pool forecasts are recomposed from total x logistic share by
the policy's ``compose_forecast`` hook.  ``convertible=`` adds the
cloud-level exchangeable SKUs, carried as ``(active_c, rolloff_c)``
(C, Kc): each week rolls off, sizes the cloud-level stack on the cloud
totals of the forecast (truncated below the pools' pinned stacks), buys
increments, re-pins the live width onto the pools by the coming week's
forecast-peak excess, suppresses the standard buys pro rata, and bills the
pools at their level plus that allocation.  Under ``solver="grid"`` the
cloud rows are a second sweep launch each replayed week.

``scenarios=`` batches the replay over N demand futures
(``data.scenarios.ScenarioConfig``): the (N, P) block is flattened into
the row axis, scenario-major, so scenario 0 (the realized trace) is the
first P rows and every band rides the same weekly loop, the same sweep
launch included.  Cost lines, spot lines and policy state tile per
scenario; migration edges re-index into each scenario's rows
(:func:`_tile_edges`); each scenario owns its copy of the cloud axis, its
cloud totals and allocations computed block by block with the base (C, P)
membership.  Every operation whose rounding could depend on the number of
rows (the forecaster's products and solves, the share state, the spot
floors' suffix sums, the membership products) runs block by block, one
scenario's P rows at a time, so scenario 0 of a batch, a one-scenario
batch and a chunked batch (``ScenarioConfig.chunk``: sequential
sub-replays merged by :func:`_merge_scenario_reports`) give the unbatched
replay's bits.  Ladders are built from scenario 0; report arrays gain an N
axis only on a true batch.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Literal

import numpy as np
import torch

from repro_torch.capacity import generations as gn
from repro_torch.capacity import pricing
from repro_torch.core import demand as dm
from repro_torch.core import forecast as fc
from repro_torch.core import ladder as ld
from repro_torch.core import migration as mg
from repro_torch.core import policy as pol
from repro_torch.core import portfolio as pf
from repro_torch.core import spot as spot_mod
from repro_torch.core.demand import HOURS_PER_WEEK
from repro_torch.core.planner import (
    _monotone_stack,
    _prefix_weighted_quantiles,
    _spot_floors,
)
from repro_torch.data import scenarios as sc
from repro_torch.device import resolve_device
from repro_torch.obs import calibration as obs_calib
from repro_torch.obs import config as obs_config
from repro_torch.obs import kernelstats as obs_kstats
from repro_torch.obs import ledger as obs_ledger
from repro_torch.obs import provenance as obs_prov

pricing.validate_tables()


@dataclasses.dataclass
class RollingPlanReport:
    """Replay of the rolling re-planning loop plus its two baselines.

    Per-week arrays are aligned with ``weeks`` (absolute week indices into
    the trace, starting at ``start_weeks``); per-pool axes align with
    ``keys``; option axes with ``options``.  All arrays are host numpy."""

    keys: tuple[dm.PoolKey, ...]
    options: list[pf.PurchaseOption]
    cadence_weeks: int
    start_weeks: int
    horizon_weeks: int
    weeks: np.ndarray                 # (S,) absolute week index
    targets: np.ndarray               # (S, P, K) per-week solver targets
    increments: np.ndarray            # (S, P, K) tranches actually bought
    active: np.ndarray                # (S, P, K) committed stack after buys
    committed_cost: np.ndarray        # (S, P) weekly committed spend
    on_demand_cost: np.ndarray        # (S, P) weekly shortfall spend
    utilization: np.ndarray           # (S, P) used / committed chip-hours
    ladders: ld.PoolLadderBook        # the purchases as a tranche book
    total_cost: float
    all_on_demand_cost: float
    savings_vs_on_demand: float
    # one-shot baseline: buy the week-``start_weeks`` plan, never re-plan
    one_shot_weekly_cost: np.ndarray | None = None    # (S,)
    one_shot_cost: float | None = None
    savings_vs_one_shot: float | None = None
    # hindsight baseline: optimal constant stack on the realized demand
    hindsight_widths: np.ndarray | None = None        # (P, K)
    hindsight_weekly_cost: np.ndarray | None = None   # (S,)
    hindsight_cost: float | None = None
    regret_vs_hindsight: float | None = None
    # Spot band (None on spot-free replays): re-decided every week from
    # that week's forecast, no tranche, no term.  ``spot_floor`` is clamped
    # to the committed stack top; demand above it bills at the effective
    # spot rate, between stack top and floor at on-demand.
    spot_config: "spot_mod.SpotConfig | None" = None
    spot_lines: "spot_mod.SpotLines | None" = None    # (P,) per pool
    spot_floor: np.ndarray | None = None              # (S, P) weekly floors
    spot_cost: np.ndarray | None = None               # (S, P) weekly spend
    spot_volume: np.ndarray | None = None             # (S, P) chip-hours
    spot_ladders: ld.PoolLadderBook | None = None     # 1-week audit tranches
    # Migration awareness (None on migration-blind replays): the successor
    # table and the edges it matched onto the fleet.
    migration_config: "gn.MigrationConfig | None" = None
    migration_edges: "gn.MigrationEdges | None" = None
    # Convertible band (None on convertible-free replays): cloud-level
    # tranches carried per cloud, re-pinned onto that cloud's pools every
    # week (``conv_alloc``).  Cloud axes align with ``conv_clouds``, option
    # axes with ``conv_options``.
    conv_options: "list[pf.PurchaseOption] | None" = None
    conv_clouds: tuple[str, ...] | None = None
    conv_targets: np.ndarray | None = None            # (S, C, Kc) targets
    conv_increments: np.ndarray | None = None         # (S, C, Kc) buys
    conv_active: np.ndarray | None = None             # (S, C, Kc) stack
    conv_alloc: np.ndarray | None = None              # (S, P) re-pinned
    conv_committed_cost: np.ndarray | None = None     # (S, C) weekly spend
    conv_ladders: ld.PoolLadderBook | None = None     # cloud-level book
    # Which policy drove the weekly decisions (``core.policy``).
    policy_name: str = "rolling_portfolio"
    # Scenario batch (None / axis absent on single-path replays): with
    # n_scenarios > 1 every per-week array above gains an N axis at
    # position 1 ((S, N, P, K), cloud axes (S, N, C, Kc)),
    # ``hindsight_widths`` becomes (N, P, K), the baseline weekly costs
    # (S, N), and the scalar aggregates are means over scenarios.  Ladders
    # come from scenario 0, the realized trace.
    n_scenarios: int = 1
    scenario_family: str | None = None
    scenario_cost: np.ndarray | None = None            # (N,) replay cost
    scenario_one_shot_cost: np.ndarray | None = None   # (N,)
    scenario_hindsight_cost: np.ndarray | None = None  # (N,)
    scenario_cr: np.ndarray | None = None              # (N,) cost/hindsight
    scenario_regret: np.ndarray | None = None          # (N,) cost-hindsight
    # The resolved on-demand rate and scenario config, so the spot replay
    # needs no side channel.
    od_rate: float | None = None
    scenario_config: "sc.ScenarioConfig | None" = None
    # Telemetry (``repro_torch.obs``; all None when telemetry is off, and
    # the replay then emits no extra outputs).  The usage arrays are replay
    # outputs; ``ledger`` and ``kernel_stats`` the materialized records.
    telemetry: "obs_config.TelemetryConfig | None" = None
    committed_by_sku: np.ndarray | None = None         # (S, P, K) spend
    conv_committed_by_sku: np.ndarray | None = None    # (S, C, Kc) spend
    used_hours: np.ndarray | None = None               # (S, P) chip-hours
    od_volume: np.ndarray | None = None                # (S, P) chip-hours
    ledger: "obs_ledger.CostLedger | None" = None
    kernel_stats: "obs_kstats.KernelStats | None" = None
    # Decision cadence: "weekly" (the harness grid) or "breach" (re-solve
    # only in weeks whose realized demand left the band held since the
    # last decision).  ``decision_mask`` records which evaluated weeks
    # decided: (S,), or (S, N) on a breach scenario batch (uniform within
    # a scenario); the breach bands ride along so a host loop can replay
    # the mask exactly.
    cadence: str = "weekly"
    decision_mask: np.ndarray | None = None            # (S,) / (S, N)
    breach_band_lo: np.ndarray | None = None           # (S, P) / (S, N, P)
    breach_band_hi: np.ndarray | None = None
    # Calibration telemetry: the weekly forecast fractile levels and their
    # scores against realized demand.
    fractile_levels: np.ndarray | None = None      # (S, P, Q) / (S, N, P, Q)
    calibration: "obs_calib.CalibrationCube | None" = None
    # Decision provenance: per-week buys, roll-offs and binding constraints
    # of scenario 0.
    decision_log: "obs_prov.DecisionLog | None" = None

    @property
    def weekly_cost(self) -> np.ndarray:
        """(S,) fleet-total spend per week ((S, N) on a scenario batch)."""
        total = self.committed_cost + self.on_demand_cost
        if self.spot_cost is not None:
            total = total + self.spot_cost
        total = total.sum(-1)
        if self.conv_committed_cost is not None:
            total = total + self.conv_committed_cost.sum(-1)
        return total

    def summary(self) -> dict:
        out = {
            "weeks_evaluated": int(len(self.weeks)),
            "cadence_weeks": self.cadence_weeks,
            "total_cost": self.total_cost,
            "savings_vs_on_demand": self.savings_vs_on_demand,
        }
        if self.cadence != "weekly":
            out["cadence"] = self.cadence
        if self.decision_mask is not None:
            dm0 = (self.decision_mask if self.decision_mask.ndim == 1
                   else self.decision_mask[:, 0])
            out["decision_weeks"] = int(dm0.sum())
        if self.spot_cost is not None:
            out["spot_cost"] = float(self.spot_cost.sum())
            out["spot_chip_hours"] = float(self.spot_volume.sum())
        if self.conv_committed_cost is not None:
            out["convertible_cost"] = float(self.conv_committed_cost.sum())
            out["convertible_final_width"] = float(
                self.conv_active[-1].sum()
            )
        if self.one_shot_cost is not None:
            out["one_shot_cost"] = self.one_shot_cost
            out["savings_vs_one_shot"] = self.savings_vs_one_shot
        if self.hindsight_cost is not None:
            out["hindsight_cost"] = self.hindsight_cost
            out["regret_vs_hindsight"] = self.regret_vs_hindsight
        if self.n_scenarios > 1:
            out["n_scenarios"] = self.n_scenarios
            out["scenario_cost_mean"] = float(self.scenario_cost.mean())
            out["scenario_cost_p95"] = float(
                np.quantile(self.scenario_cost, 0.95))
            if self.scenario_cr is not None:
                out["scenario_cr_mean"] = float(self.scenario_cr.mean())
                out["scenario_cr_p95"] = float(
                    np.quantile(self.scenario_cr, 0.95))
                out["scenario_regret_mean"] = float(
                    self.scenario_regret.mean())
                out["scenario_regret_p95"] = float(
                    np.quantile(self.scenario_regret, 0.95))
        return out


def _tile_edges(edges: gn.MigrationEdges, n: int, p: int) -> gn.MigrationEdges:
    """One fleet's migration edges replicated onto the flattened (N
    scenarios x P pools) row axis: scenario s's copy of edge g joins rows
    ``src[g] + s p -> dst[g] + s p``, so scenarios never exchange demand."""
    off = (torch.arange(n, dtype=edges.src.dtype, device=edges.device)
           * p)[:, None]
    return dataclasses.replace(
        edges,
        src=(edges.src[None, :] + off).reshape(-1),
        dst=(edges.dst[None, :] + off).reshape(-1),
        uplift=edges.uplift.repeat(n),
        inv_gain=edges.inv_gain.repeat(n),
        midpoint_hours=edges.midpoint_hours.repeat(n),
        rate_per_hour=edges.rate_per_hour.repeat(n),
    )


def _merge_scenario_reports(
    parts: list[RollingPlanReport],
) -> RollingPlanReport:
    """Stitch chunked scenario replays (``ScenarioConfig.chunk``) into one
    report: per-week arrays concatenate along the scenario axis,
    per-scenario distributions along N, and the scalar aggregates are
    recomputed as means over the whole scenario set.  Ladders (built from
    scenario 0) come from the first chunk."""
    first = parts[0]

    def cat(name: str, axis: int):
        vals = [getattr(p, name) for p in parts]
        return None if vals[0] is None else np.concatenate(vals, axis=axis)

    ns = np.asarray([p.n_scenarios for p in parts], np.float64)
    per_week = ("targets", "increments", "active", "committed_cost",
                "on_demand_cost", "utilization", "spot_floor", "spot_cost",
                "spot_volume", "conv_targets", "conv_increments",
                "conv_active", "conv_alloc", "conv_committed_cost",
                "committed_by_sku", "conv_committed_by_sku", "used_hours",
                "od_volume", "breach_band_lo", "breach_band_hi",
                "fractile_levels", "one_shot_weekly_cost",
                "hindsight_weekly_cost")
    per_scen = ("hindsight_widths", "scenario_cost", "scenario_one_shot_cost",
                "scenario_hindsight_cost", "scenario_cr", "scenario_regret")
    rep = dataclasses.replace(
        first,
        **{name: cat(name, 1) for name in per_week},
        **{name: cat(name, 0) for name in per_scen},
        n_scenarios=int(ns.sum()),
    )
    if first.decision_mask.ndim == 2:
        # Breach masks carry the scenario axis; weekly masks are (S,) and
        # the same in every chunk.
        rep.decision_mask = cat("decision_mask", 1)
    if first.calibration is not None:
        cubes = [p.calibration for p in parts]
        rep.calibration = dataclasses.replace(cubes[0], **{
            name: np.concatenate([getattr(c, name) for c in cubes], axis=1)
            for name in ("levels", "hits", "pinball", "realized_mean",
                         "realized_peak")})
    rep.total_cost = float(rep.scenario_cost.mean())
    rep.all_on_demand_cost = float(np.average(
        [p.all_on_demand_cost for p in parts], weights=ns))
    rep.savings_vs_on_demand = (
        1.0 - rep.total_cost / rep.all_on_demand_cost
        if rep.all_on_demand_cost > 0 else 0.0
    )
    if rep.scenario_one_shot_cost is not None:
        rep.one_shot_cost = float(rep.scenario_one_shot_cost.mean())
        rep.savings_vs_one_shot = (
            1.0 - rep.total_cost / rep.one_shot_cost
            if rep.one_shot_cost > 0 else 0.0
        )
    if rep.scenario_hindsight_cost is not None:
        rep.hindsight_cost = float(rep.scenario_hindsight_cost.mean())
        rep.regret_vs_hindsight = (
            rep.total_cost / rep.hindsight_cost - 1.0
            if rep.hindsight_cost > 0 else 0.0
        )
    return rep


def _validate(total_weeks: int, start_weeks: int, cadence_weeks: int):
    if cadence_weeks < 1:
        raise ValueError(f"cadence_weeks must be >= 1, got {cadence_weeks}")
    if not 1 <= start_weeks < total_weeks:
        raise ValueError(
            f"start_weeks={start_weeks} must leave history and an "
            f"evaluation window inside {total_weeks} whole trace weeks"
        )


def _to_host(outs: dict[str, list]) -> dict[str, np.ndarray]:
    """The per-week device outputs, each key's weeks stacked, as host numpy
    arrays, copied through one buffer per carrier type (float64 for the
    float64 outputs, float32 for the rest; bool outputs come back as bool)
    and so one copy each: the number of host syncs does not grow with the
    number of outputs."""
    ys = {}
    for carrier in (torch.float32, torch.float64):
        keys = [k for k, v in outs.items()
                if (v[0].dtype == torch.float64) == (carrier == torch.float64)]
        if not keys:
            continue
        shapes = {k: (len(outs[k]), *outs[k][0].shape) for k in keys}
        sizes = {k: int(np.prod(shapes[k])) for k in keys}
        flat = torch.empty(sum(sizes.values()), dtype=carrier,
                           device=outs[keys[0]][0].device)
        i = 0
        for k in keys:
            torch.stack([x.to(carrier) for x in outs[k]],
                        out=flat[i:i + sizes[k]].view(shapes[k]))
            i += sizes[k]
        host = flat.cpu().numpy()
        i = 0
        for k in keys:
            a = host[i:i + sizes[k]].reshape(shapes[k])
            ys[k] = a.astype(bool) if outs[k][0].dtype == torch.bool else a
            i += sizes[k]
    return {k: ys[k] for k in outs}


def _calibration_scores(d: torch.Tensor, levels: torch.Tensor,
                        fractiles) -> dict[str, torch.Tensor]:
    """One week's calibration scores on the replay's device, in float64:
    the share of the realized hours ``d`` (R, H) at or below each fractile
    level (R, Q), the pinball loss of each level, and the hours' mean and
    peak.  The algebra of ``obs.calibration.calibration_from_arrays``;
    the hours' sums run in another order, so the pinball loss may differ
    from the host's in its last bits.  Hits (exact counts) and the mean of
    float32 hours (an exact float64 sum) do not: every mean is a sum
    divided by the hours as a tensor, a correctly rounded division on any
    device (a division by a host scalar multiplies by its reciprocal on
    the card)."""
    dh = d.double()[:, :, None]                        # (R, H, 1)
    lv = levels.double()[:, None, :]                   # (R, 1, Q)
    over = torch.clamp(dh - lv, min=0.0)
    under = torch.clamp(lv - dh, min=0.0)

    def mean_hours(x):
        total = x.sum(1)
        return total / torch.full_like(total, float(x.shape[1]))

    # one fractile at a time with host scalars: no tensor is copied to
    # the device, so the loop stays free of host syncs
    pinball = torch.stack([
        mean_hours(q * over[..., j] + (1.0 - q) * under[..., j])
        for j, q in enumerate(map(float, fractiles))], dim=-1)
    return {
        "calib_hits": mean_hours((dh <= lv).double()),
        "calib_pinball": pinball,
        "calib_mean": mean_hours(dh[:, :, 0]),
        "calib_peak": dh[:, :, 0].amax(-1),
    }


def _block_sum(a: np.ndarray, s: int, rows: int) -> np.float32:
    """The float32 sum of row block ``s`` (``rows`` wide) of a per-week
    (S, R) array, summed as the contiguous (S, rows) array an unbatched
    replay holds, so scenario 0 sums to the unbatched bits."""
    return np.ascontiguousarray(a[:, s * rows:(s + 1) * rows]).sum()


def _attach_telemetry(report: RollingPlanReport, tele, ys: dict,
                      dec: np.ndarray, *, solver: str, sweep_shape: tuple,
                      num_pools: int, num_scen: int, rep, conv,
                      spot: bool) -> None:
    """Materialize the telemetry records of ``tele`` on ``report`` from the
    replay's host outputs ``ys``: the kernel stats of the grid solver's
    weekly sweep launch (horizon prefixes folded into the rows), the
    ledger, the calibration cube of every scenario (scored by the replay
    against the demand it billed) and the decision log of scenario 0.
    ``rep`` is the report's view of a per-week (S, R, ...) array, ``conv``
    (options, clouds, count) of the convertible band or None."""
    report.telemetry = tele
    names = ["/".join(k) for k in report.keys]
    if tele.kernel_stats and solver == "grid":
        report.kernel_stats = obs_kstats.sweep_kernel_stats(*sweep_shape)
    if tele.ledger:
        report.committed_by_sku = rep(ys["committed_k"])
        report.used_hours = rep(ys["used"])
        report.od_volume = rep(ys["od_vol"])
        if conv is not None:
            report.conv_committed_by_sku = rep(ys["conv_committed_k"],
                                               conv[2])
        report.ledger = obs_ledger.ledger_from_report(report)
    if tele.calibration:
        report.fractile_levels = rep(ys["calib_levels"])
        report.calibration = obs_calib.calibration_from_scores(
            report.weeks, names, tele.fractiles, ys["calib_levels"],
            ys["calib_hits"], ys["calib_pinball"], ys["calib_mean"],
            ys["calib_peak"], n_scenarios=num_scen,
            meta={"policy": report.policy_name, "cadence": report.cadence,
                  "scenario_family": report.scenario_family},
        )
    if tele.provenance:
        prov_kw = {}
        if spot:
            prov_kw["spot_bound"] = ys["prov_spot_bound"][:, :num_pools]
        if conv is not None:
            conv_opts, conv_clouds, num_clouds = conv
            prov_kw.update(
                conv_suppressed=ys["prov_conv_sup"][:, :num_pools],
                conv_clouds=conv_clouds,
                conv_skus=[o.name for o in conv_opts],
                conv_term_weeks=[o.term_weeks for o in conv_opts],
                conv_increments=ys["conv_inc"][:, :num_clouds],
                conv_rolloffs=ys["prov_conv_expired"][:, :num_clouds],
                conv_active=ys["conv_active"][:, :num_clouds],
            )
        report.decision_log = obs_prov.decision_log_from_arrays(
            report.weeks, names, [o.name for o in report.options],
            [o.term_weeks for o in report.options],
            is_decision=dec,
            targets=ys["target"][:, :num_pools],
            increments=ys["inc"][:, :num_pools],
            rolloffs=ys["prov_expired"][:, :num_pools],
            active=ys["active"][:, :num_pools],
            purchase_eps=float(ld.PURCHASE_EPS),
            meta={"policy": report.policy_name, "cadence": report.cadence},
            **prov_kw,
        )


def replan_fleet_pools(
    pools: dm.PoolSet,
    options: list[pf.PurchaseOption] | None = None,
    *,
    cadence_weeks: int = 1,
    start_weeks: int | None = None,
    horizon_weeks: int = 8,
    od_rate: float | None = None,
    term_weighting: float = 0.0,
    cfg: fc.ForecastConfig = fc.ForecastConfig(),
    solver: Literal["quantile", "grid"] = "quantile",
    num_grid: int = 128,
    use_kernel: bool = False,
    irls_iters: int = 0,
    backend: Literal["scan", "loop"] = "scan",
    compare: bool = True,
    spot=None,
    migration=None,
    convertible=None,
    policy: "pol.Policy | str | None" = None,
    scenarios: "sc.ScenarioConfig | int | None" = None,
    irls_carry: bool = False,
    telemetry=None,
    cadence: str = "weekly",
    breach_band: tuple = (0.05, 0.95),
    breach_tolerance: float = 4.0,
    device: "torch.device | str | None" = None,
) -> RollingPlanReport:
    """Replay the rolling re-planning loop over ``pools`` on ``device``
    (``None`` = ``"cuda"``; without a card pass ``device="cpu"``).

    The first ``start_weeks`` weeks are pure history (default: a quarter of
    the trace, at least ``horizon_weeks``); every week after that is
    forecast, (on cadence weeks) re-planned, and billed.  ``irls_iters``
    adds asymmetric-error IRLS passes to each weekly refit.  With
    ``compare`` the one-shot and hindsight baselines are replayed on the
    same window.  ``use_kernel`` is accepted for the reference's spelling:
    on the card the grid solver always runs the CUDA kernel (see
    ``portfolio.optimal_portfolio_grid``).

    ``spot`` (True, a :class:`~repro_torch.core.spot.SpotConfig` or a
    (SpotConfig, SpotLines) pair) adds the spot band, ``migration`` (True
    or a ``generations.MigrationConfig``) the turnover-aware forecasts,
    ``convertible`` (True or a list of convertible options) the
    cloud-level band; each needs a forecasting policy.  ``scenarios`` (an
    int or a :class:`~repro_torch.data.scenarios.ScenarioConfig`) batches
    the replay over N demand futures (module docstring); the report then
    carries per-scenario cost, competitive-ratio and regret distributions.
    ``irls_carry`` (with ``irls_iters > 0``) carries the asymmetric-weight
    moments in the policy state (frozen-weights incremental IRLS) instead
    of ``irls_iters`` full masked passes every week.

    ``telemetry`` (None or False, True, or a
    :class:`~repro_torch.obs.config.TelemetryConfig`) makes the replay
    emit per-SKU committed spend, usage hours and on-demand volume and
    attaches a :class:`~repro_torch.obs.ledger.CostLedger` (plus, under the
    grid solver, the :class:`~repro_torch.obs.kernelstats.KernelStats` of
    its sweep launch); ``calibration=True`` emits each week's forecast
    fractile levels, scored as a
    :class:`~repro_torch.obs.calibration.CalibrationCube`;
    ``provenance=True`` emits roll-offs and binding-constraint flags,
    materialized as a :class:`~repro_torch.obs.provenance.DecisionLog`.
    None of it changes what is bought or billed, and with
    ``telemetry=None`` the replay emits nothing extra.

    ``cadence="breach"`` (with ``cadence_weeks=1``) re-solves only in weeks
    where last week's realized demand spent more than ``breach_tolerance``
    x the nominal miss mass of its hours outside the ``breach_band``
    fractile pair of the band anchored at the last decision (and in the
    start week), fleet-wide per scenario.  The mask is decided on the
    device, so the weekly loop still reads nothing back.  Calibration and
    the breach cadence need a forecasting policy."""
    del use_kernel
    if solver not in ("quantile", "grid"):
        raise ValueError(
            f"unknown solver {solver!r}; known: ('quantile', 'grid')"
        )
    if backend not in ("scan", "loop"):
        raise ValueError(
            f"unknown backend {backend!r}; known: ('scan', 'loop')"
        )
    dev = resolve_device(device)
    options = options if options is not None else pf.options_from_pricing()
    od = od_rate if od_rate is not None else pricing.on_demand_premium()
    total_weeks = pools.num_hours // HOURS_PER_WEEK
    if start_weeks is None:
        start_weeks = min(max(horizon_weeks, total_weeks // 4),
                          max(total_weeks - 1, 1))
    _validate(total_weeks, start_weeks, cadence_weeks)
    if cadence not in ("weekly", "breach"):
        raise ValueError(
            f"unknown cadence {cadence!r}; known: ('weekly', 'breach')"
        )
    if cadence == "breach" and cadence_weeks != 1:
        raise ValueError(
            "cadence='breach' evaluates every week and masks decisions "
            f"itself; use cadence_weeks=1, got {cadence_weeks}"
        )
    tele = obs_config.resolve_telemetry(telemetry)

    scen = sc.resolve_scenarios(scenarios)
    block = functools.partial(
        _replay_block, pools=pools, options=options,
        cadence_weeks=cadence_weeks, start_weeks=start_weeks,
        horizon_weeks=horizon_weeks, od=od, term_weighting=term_weighting,
        cfg=cfg, solver=solver, num_grid=num_grid, irls_iters=irls_iters,
        backend=backend, compare=compare, spot=spot, migration=migration,
        convertible=convertible, pcy=pol.get_policy(policy), scen=scen,
        irls_carry=irls_carry, tele=tele, cadence=cadence,
        breach_band=tuple(breach_band), breach_tolerance=breach_tolerance,
        dev=dev,
    )
    if scen is None:
        return block(0, 1)
    n = scen.n_scenarios
    step = scen.chunk or n
    if step >= n:
        return block(0, n)
    # Sequential sub-replays over scenario chunks, merged into one.
    return _merge_scenario_reports([
        block(lo, min(lo + step, n)) for lo in range(0, n, step)
    ])


def _replay_block(
    lo: int,
    hi: int,
    *,
    pools: dm.PoolSet,
    options: list[pf.PurchaseOption],
    cadence_weeks: int,
    start_weeks: int,
    horizon_weeks: int,
    od: float,
    term_weighting: float,
    cfg: fc.ForecastConfig,
    solver: str,
    num_grid: int,
    irls_iters: int,
    backend: str,
    compare: bool,
    spot,
    migration,
    convertible,
    pcy: pol.Policy,
    scen: "sc.ScenarioConfig | None",
    irls_carry: bool,
    tele: "obs_config.TelemetryConfig | None",
    cadence: str,
    breach_band: tuple,
    breach_tolerance: float,
    dev: torch.device,
) -> RollingPlanReport:
    """The replay of scenarios ``lo .. hi - 1`` of ``scen`` (the realized
    trace alone when ``scen`` is None) on resolved arguments.  The report
    carries an N axis whenever the whole batch has more than one scenario,
    so the chunks of a chunked batch concatenate along it."""
    total_weeks = pools.num_hours // HOURS_PER_WEEK
    num_pools, num_opts = pools.num_pools, len(options)
    horizon_hours = horizon_weeks * HOURS_PER_WEEK
    t_hist = total_weeks * HOURS_PER_WEEK
    demand_np = np.ascontiguousarray(pools.demand[:, :t_hist])
    if scen is None:
        demand = torch.as_tensor(demand_np, dtype=torch.float32).to(dev)
    else:
        demand = sc.scenario_block(demand_np, scen, lo, hi,
                                   device=dev).reshape(-1, t_hist)
    # Rows are scenario-major (N, P) flattened: scenario 0 is the first P.
    num_scen = demand.shape[0] // num_pools
    num_rows = demand.shape[0]
    # The N axis appears on report arrays only for a true batch.
    scen_axis = scen is not None and scen.n_scenarios > 1
    clouds = pools.clouds
    row_clouds = clouds * num_scen
    blocks = [slice(s * num_pools, (s + 1) * num_pools)
              for s in range(num_scen)]

    def tile(x: torch.Tensor) -> torch.Tensor:
        """Per-pool rows (P, ...) repeated once per scenario."""
        return x.repeat(num_scen, *([1] * (x.dim() - 1)))

    def by_block(fn, *rows, width=num_pools):
        """fn on each scenario's block of the row tensors (``width`` rows
        each), concatenated: each block runs at the unbatched shape."""
        return torch.cat([
            fn(*(r[s * width:(s + 1) * width] for r in rows))
            for s in range(num_scen)
        ])

    al_p, be_p, avail_np = pf.pool_option_lines(
        options, clouds, term_weighting=term_weighting, od_rate=od,
        device=dev,
    )
    qs = tile(pf.handover_fractiles(al_p, be_p, od_rate=od))  # (R, K)
    sp_res = spot_mod.resolve_spot(spot, clouds, od_rate=od, device=dev)
    if sp_res is not None:
        s_cfg, base_lines = sp_res
        u_env = tile(spot_mod.spot_entry_fractile(
            al_p, be_p, base_lines.rate, od_rate=od))         # (R,)
        s_lines = base_lines.map(tile)
    al_p, be_p = tile(al_p), tile(be_p)
    avail = tile(torch.as_tensor(avail_np, device=dev))
    rates = torch.tensor(
        [o.rate for o in options], dtype=torch.float32, device=dev
    )
    term_list = [o.term_weeks for o in options]
    term_weeks = torch.tensor(term_list, dtype=torch.int64, device=dev)

    # Migration awareness: the structural state fits pair totals, a share
    # prefix state rides along, the policy recomposes each week's forecast.
    mig_cfg = gn.resolve_migration(migration)
    edges = (gn.migration_edges(pools.keys, mig_cfg, device=dev)
             if mig_cfg is not None else None)
    use_mig = edges is not None and edges.num_edges > 0
    row_edges = (_tile_edges(edges, num_scen, num_pools)
                 if use_mig and num_scen > 1 else edges)

    # Convertible band: cloud-level SKUs beside the pool-pinned options,
    # a private copy of the cloud axis per scenario.
    conv_opts = pf.resolve_convertible(convertible, clouds)
    max_term = max(term_list)
    if conv_opts is not None:
        conv_clouds, member, al_c, be_c, qs_c, conv_terms = (
            pf.convertible_cloud_setup(
                conv_opts, clouds, term_weighting=term_weighting,
                od_rate=od, device=dev,
            )
        )
        al_c, be_c, qs_c = tile(al_c), tile(be_c), tile(qs_c)
        num_clouds, num_conv = len(conv_clouds), len(conv_opts)
        num_cloud_rows = num_clouds * num_scen
        conv_rates = torch.tensor([o.rate for o in conv_opts],
                                  dtype=torch.float32, device=dev)
        conv_idx = torch.arange(num_conv, device=dev)
        max_term = max(max_term, max(o.term_weeks for o in conv_opts))

        def pool_to_cloud(v):
            """Per-pool rows (R, ...) summed onto each scenario's cloud
            rows (N*C, ...), one (C, P) membership product per scenario."""
            return by_block(lambda blk: member @ blk, v)
    sched_len = total_weeks + max_term + 1

    bands = [name for name, on in (("spot", sp_res is not None),
                                   ("migration", use_mig),
                                   ("convertible", conv_opts is not None))
             if on]
    if not pcy.forecasting:
        if bands:
            raise ValueError(
                f"policy {pcy.name!r} does not forecast, but "
                f"{'/'.join(bands)} bands key on the weekly forecast; use a "
                "forecasting policy or disable the bands"
            )
        if tele is not None and tele.calibration:
            raise ValueError(
                f"policy {pcy.name!r} does not forecast, but "
                "TelemetryConfig(calibration=True) scores the weekly "
                "forecast fractiles; use a forecasting policy"
            )
        if cadence == "breach":
            raise ValueError(
                f"policy {pcy.name!r} does not forecast, but "
                "cadence='breach' triggers on the forecast band; use a "
                "forecasting policy"
            )
    w_hours = torch.arange(1, horizon_weeks + 1, device=dev) * HOURS_PER_WEEK
    opt_idx = torch.arange(num_opts, device=dev)

    fit_demand = (mg.transform_for_fit(demand, row_edges) if use_mig
                  else demand)
    state = fc.prefix_fit_state(
        fit_demand, cfg, horizon_hours=horizon_hours,
        min_prefix_hours=start_weeks * HOURS_PER_WEEK, row_block=num_pools,
    )
    del fit_demand
    demand_wk = demand.reshape(num_rows, total_weeks, HOURS_PER_WEEK)
    # Horizon prefix masks of the grid solver, (R*Wh, H): row r's horizon
    # h keeps the first h weeks of the forecast.
    t_h = torch.arange(horizon_hours, device=dev)
    prefix_masks = (t_h[None, :] < w_hours[:, None]).to(torch.float32)
    pool_masks = cloud_masks = None
    if solver == "grid":
        pool_masks = prefix_masks.repeat(num_rows, 1)
        if conv_opts is not None:
            cloud_masks = prefix_masks.repeat(num_cloud_rows, 1)

    def grid_prefix_levels(yhat, alphas, betas, masks):
        """Per-horizon stack tops via the over/under sweep on prefix-mask
        weights: horizon prefixes fold into the row axis, so the whole
        (R x Wh, H, G) problem is one sweep launch (rows R are pools for
        the standard options, clouds for the convertible band; ``masks``
        is ``prefix_masks`` repeated once per row)."""
        plan = pf.optimal_portfolio_grid(
            yhat.repeat_interleave(horizon_weeks, dim=0),
            alphas.repeat_interleave(horizon_weeks, dim=0),
            betas.repeat_interleave(horizon_weeks, dim=0),
            od_rate=od, num_grid=num_grid, weights=masks,
        )
        return plan.levels.reshape(yhat.shape[0], horizon_weeks,
                                   alphas.shape[-1])

    def targets_for(yhat):
        """Algorithm 1 steps 2-4 on one week's forecast: per-horizon prefix
        thresholds -> min within each option's term -> monotone stack
        widths (R, K).  With spot, the per-horizon levels truncate at the
        spot floors first (their suffix sums run per scenario block), and
        the horizon-1 floor (R,) rides along as the week's spot decision
        (None without spot)."""
        if solver == "grid":
            per_h = grid_prefix_levels(yhat, al_p, be_p, pool_masks)
        else:
            per_h = _prefix_weighted_quantiles(yhat, w_hours, qs)
        floor = None
        if sp_res is not None:
            floors = by_block(
                lambda y, u, cap: _spot_floors(y, w_hours, u, cap),
                yhat, u_env, s_lines.cap)
            per_h = torch.minimum(per_h, floors[..., None])
            floor = floors[:, 0]
        widths, _ = _monotone_stack(per_h, qs, term_weeks, horizon_weeks)
        return widths, floor

    def conv_targets_for(yhat, pool_top):
        """Cloud-level convertible targets (N*C, Kc) on one week's
        forecast.  A cloud's total is turnover-invariant (demand moves
        between its families, not out of it), so the safe cloud-level stack
        comes from the same prefix thresholds -> term minima -> monotone
        stack on the cloud totals with the convertible lines, truncated
        below the cloud's summed pool stacks ``pool_top`` (R,): convertible
        buys the band that is safe at cloud level but pinnable to no one
        family."""
        total_c = pool_to_cloud(yhat)                          # (N*C, H)
        if solver == "grid":
            per_h = grid_prefix_levels(total_c, al_c, be_c, cloud_masks)
        else:
            per_h = _prefix_weighted_quantiles(total_c, w_hours, qs_c)
        widths_c, tops_c = _monotone_stack(per_h, qs_c, conv_terms,
                                           horizon_weeks)
        return pf.truncate_convertible_stack(tops_c, widths_c,
                                             pool_to_cloud(pool_top))

    compose_forecast = None
    if use_mig:
        # One share state per scenario block on the base edges, stacked in
        # the tiled edges' order.
        share_states = [
            mg.share_prefix_state(demand[blk], edges, t_max=state.t_max,
                                  prior_weight=mig_cfg.share_prior_weight)
            for blk in blocks
        ]
        share_state = mg.SharePrefixState(
            cum=torch.cat([st.cum for st in share_states]),
            t_max=share_states[0].t_max)
        del share_states

        def compose_forecast(yhat, w):
            """Pair totals x the week-``w`` prefix's logistic share fits
            -> per-pool forecasts (the policy's hook)."""
            sa, sb = mg.solve_share_prefix(share_state, w)
            sh = mg.predict_share(sa, sb, w * HOURS_PER_WEEK + t_h,
                                  share_state.t_max)
            return mg.compose_forecast(yhat, sh, row_edges)

    def convertible_week(w, dec, dec_p, dec_c, active, active_c, rolloff_c,
                         tele_w):
        """The convertible pass of week ``w``, decided before the standard
        buys: roll off, size the cloud band (truncated below the higher of
        this week's pool targets and the carried pool stacks, so surplus
        standard tranches are not covered twice), buy its increments,
        re-pin the live width onto each scenario's pools by the coming
        week's forecast peak above their stacks (allocating sunk capacity
        is free; a mean need would leave the diurnal peaks on demand), and
        scale the standard buys down pro rata by that allocation.
        ``dec_p`` and ``dec_c`` are the decision flags of the pool and
        cloud rows, ``tele_w`` the telemetry of this replay (or None).
        Returns (the standard increments (R, K), active_c, the cloud
        outputs)."""
        expired_c = rolloff_c[:, :, w]
        active_c = active_c - expired_c
        widths = dec.targets
        pool_top = torch.maximum(widths.sum(-1), active.sum(-1))
        widths_c = conv_targets_for(dec.yhat, pool_top)
        inc_c = torch.clamp(widths_c - active_c, min=0.0)
        inc_c = torch.where((inc_c > ld.PURCHASE_EPS) & dec_c, inc_c, 0.0)
        active_c = active_c + inc_c
        rolloff_c[:, conv_idx, w + conv_terms] += inc_c
        need = torch.clamp(
            dec.yhat[:, :HOURS_PER_WEEK].amax(-1) - active.sum(-1), min=0.0)
        width_c = active_c.sum(-1)
        alloc = torch.cat([
            pf.allocate_convertible(
                width_c[s * num_clouds:(s + 1) * num_clouds], need[blk],
                member)
            for s, blk in enumerate(blocks)
        ])
        desired = torch.clamp(widths - active, min=0.0)
        lift = desired.sum(-1)                                   # (R,)
        scale = torch.where(
            lift > ld.PURCHASE_EPS,
            torch.clamp(lift - alloc, min=0.0) / torch.clamp(lift, min=1e-9),
            0.0)
        inc = desired * scale[:, None]
        inc = torch.where((inc > ld.PURCHASE_EPS) & dec_p, inc, 0.0)
        outs = {"conv_target": widths_c, "conv_inc": inc_c,
                "conv_active": active_c, "conv_alloc": alloc,
                "conv_committed":
                    (conv_rates * active_c).sum(-1) * HOURS_PER_WEEK}
        if tele_w is not None and tele_w.ledger:
            outs["conv_committed_k"] = conv_rates * active_c * HOURS_PER_WEEK
        if tele_w is not None and tele_w.provenance:
            # Convertible suppression: the pool wanted a standard buy and
            # live convertible capacity was allocated over it.
            outs["prov_conv_expired"] = expired_c
            outs["prov_conv_sup"] = ((alloc > ld.PURCHASE_EPS)
                                     & (lift > ld.PURCHASE_EPS))
        return inc, active_c, outs

    def replay(cadence_wk: int, solve_fn, step_policy: pol.Policy,
               mode: str = "weekly", tele_w=None):
        """One pass over the evaluation weeks under cadence ``mode``, with
        the telemetry outputs of ``tele_w`` (None: none); returns the
        per-week outputs as host numpy arrays and the decision flags, a
        host (S,) array, or (S, R) under the breach cadence."""
        ctx = pol.PolicyContext(
            demand=demand, options=options, clouds=row_clouds, od=od,
            rates=rates, term_weeks=term_weeks, avail=avail, qs=qs,
            w_hours=w_hours, start_weeks=start_weeks,
            cadence_weeks=cadence_wk, horizon_weeks=horizon_weeks,
            total_weeks=total_weeks, state=state, solve_fn=solve_fn,
            irls_iters=irls_iters, irls_carry=irls_carry,
            targets_for=targets_for, compose_forecast=compose_forecast,
            cadence_mode=mode, breach_band=breach_band,
            breach_tolerance=breach_tolerance, scenario_blocks=num_scen,
        )
        pstate, decide = step_policy.setup(ctx)
        needs_prev = step_policy.needs_prev_demand or mode == "breach"
        # The trailing realized window of the fractile bands, gathered only
        # under the breach cadence or calibration; its start clamps into
        # the trace, so the first weeks of an early start see a shifted
        # window.
        needs_trail = mode == "breach" or (tele_w is not None
                                           and tele_w.calibration)
        active = torch.zeros((num_rows, num_opts), device=dev)
        rolloff = torch.zeros((num_rows, num_opts, sched_len), device=dev)
        if conv_opts is not None:
            active_c = torch.zeros((num_cloud_rows, num_conv), device=dev)
            rolloff_c = torch.zeros((num_cloud_rows, num_conv, sched_len),
                                    device=dev)
        outs: dict[str, list] = {}
        is_dec = []
        for w in range(start_weeks, total_weeks):
            # 1. tranches whose term ends at week w roll off the stack
            expired = rolloff[:, :, w]
            active = active - expired
            # 2-4. the policy decides this week's target stack; buys happen
            # only on decision weeks and only as increments
            d_prev = demand_wk[:, w - 1] if needs_prev else None
            d_trail = None
            if needs_trail:
                t0 = min(max(w - fc.TRAIL_WEEKS, 0),
                         total_weeks - fc.TRAIL_WEEKS)
                d_trail = demand_wk[:, t0:t0 + fc.TRAIL_WEEKS].reshape(
                    num_rows, -1)
            pstate, dec = decide(pstate, pol.Observation(
                week=w, active=active, d_prev=d_prev, d_trail=d_trail))
            widths = dec.targets
            # A breach decision is a per-row tensor, uniform within each
            # scenario block: a column for the pool rows, each scenario's
            # flag repeated onto its cloud rows.
            vec_dec = isinstance(dec.is_decision, torch.Tensor)
            dec_p = dec.is_decision[:, None] if vec_dec else dec.is_decision
            if conv_opts is None:
                inc = torch.clamp(widths - active, min=0.0)
                buy = (inc > ld.PURCHASE_EPS) & dec_p
                inc = torch.where(buy, inc, 0.0)
            else:
                dec_c = dec_p
                if vec_dec:
                    dec_c = dec.is_decision.reshape(num_scen, num_pools)[
                        :, :1].expand(num_scen, num_clouds).reshape(-1, 1)
                inc, active_c, conv_vals = convertible_week(
                    w, dec, dec_p, dec_c, active, active_c, rolloff_c,
                    tele_w)
            active = active + inc
            # The tranche bought at w expires at w + term.  The schedule
            # has total_weeks + max_term + 1 columns and w < total_weeks,
            # so the index is in range by construction; each option owns
            # one (option, column) cell, so the add has no collisions.
            rolloff[:, opt_idx, w + term_weeks] += inc
            # 5. bill the week: committed rates regardless of use, the
            # shortfall above the stack top at the on-demand rate; with a
            # spot band, on-demand only up to the floor and the effective
            # spot rate above it.  A convertible allocation lifts each
            # pool's level for the week (its tranches bill at cloud level).
            d = demand_wk[:, w]                                # (R, 168)
            level = active.sum(-1)
            committed = (rates * active).sum(-1) * HOURS_PER_WEEK
            if conv_opts is not None:
                level = level + conv_vals["conv_alloc"]
            used = torch.minimum(d, level[:, None]).sum(-1)
            util = torch.where(
                level > 0, used / (level * HOURS_PER_WEEK), 0.0
            )
            vals = {"target": widths, "inc": inc, "active": active,
                    "committed": committed, "util": util}
            if sp_res is None:
                over = torch.clamp(d - level[:, None], min=0.0).sum(-1)
            else:
                fl = torch.maximum(dec.floor, level)
                over = torch.clamp(
                    torch.minimum(d, fl[:, None]) - level[:, None], min=0.0
                ).sum(-1)
                spot_over = torch.clamp(d - fl[:, None], min=0.0)
                spot_vol = spot_over.sum(-1)
                vals.update(floor=fl, spot_vol=spot_vol,
                            spot=s_lines.rate * spot_vol,
                            spot_peak=spot_over.amax(-1))
            vals["od"] = od * over
            if tele_w is not None and tele_w.ledger:
                vals.update(committed_k=rates * active * HOURS_PER_WEEK,
                            used=used, od_vol=over)
            if tele_w is not None and tele_w.calibration:
                # the levels for the coming week, scored against it
                levels = fc.anchored_fractile_levels(d_trail,
                                                     tele_w.fractiles)
                vals["calib_levels"] = levels
                vals.update(_calibration_scores(d, levels, tele_w.fractiles))
            if tele_w is not None and tele_w.provenance:
                # The roll-offs, and whether the stack top reached the spot
                # floor (the floor, not the envelope, sized it).
                vals["prov_expired"] = expired
                if sp_res is not None:
                    vals["prov_spot_bound"] = (
                        widths.sum(-1) >= dec.floor - 1e-3)
            if dec.extras is not None:
                vals.update(dec.extras)
            if conv_opts is not None:
                vals.update(conv_vals)
            if vec_dec:
                vals["is_dec"] = dec.is_decision
            else:
                is_dec.append(dec.is_decision)
            for key, val in vals.items():
                outs.setdefault(key, []).append(val)
        ys = _to_host(outs)
        if "is_dec" in ys:
            return ys, ys.pop("is_dec")
        return ys, np.asarray(is_dec, bool)

    ys, dec_raw = replay(
        cadence_weeks,
        fc.solve_prefix if backend == "scan" else fc.solve_prefix_direct,
        pcy, cadence, tele,
    )
    weeks = np.arange(start_weeks, total_weeks)
    # Books and baselines key on scenario 0, the first P rows.
    dec = dec_raw[:, 0] if dec_raw.ndim == 2 else dec_raw

    # The purchases as a tranche book, from scenario 0 (the first P rows):
    # per-week targets (0 outside decision weeks, so the ladder planner's
    # "never below active" rule buys exactly the replay's increments)
    # threaded through the portfolio ladder.  With the convertible band the
    # targets are not what was bought (live convertible capacity suppresses
    # standard buys), so the book replays the realized stack instead.
    targets_full = np.zeros((num_pools, total_weeks, num_opts), np.float32)
    book = (ys["target"] if conv_opts is None else ys["active"])[:, :num_pools]
    targets_full[:, weeks[dec]] = np.swapaxes(book[dec], 0, 1)
    term_hours = np.asarray(term_list) * HOURS_PER_WEEK
    ladders = ld.plan_pool_portfolio_purchases(
        targets_full, term_hours, pools.keys
    )

    def scen_total(s: int) -> float:
        """Scenario s's replay cost, summed block by block in the
        unbatched order (so scenario 0 is the unbatched total's bits)."""
        cs = float(_block_sum(ys["committed"], s, num_pools)
                   + _block_sum(ys["od"], s, num_pools))
        if sp_res is not None:
            cs += float(_block_sum(ys["spot"], s, num_pools))
        if conv_opts is not None:
            cs += float(_block_sum(ys["conv_committed"], s, num_clouds))
        return cs

    scen_cost = np.asarray([scen_total(s) for s in range(num_scen)])
    t0 = start_weeks * HOURS_PER_WEEK
    # every scenario's all-on-demand bill, one float64 sum per block
    scen_all_od = od * torch.stack([
        demand[blk, t0:].double().sum() for blk in blocks]).cpu().numpy()
    total = float(scen_cost.mean()) if scen is not None else scen_cost[0]
    all_od = (float(scen_all_od.mean()) if scen is not None
              else float(scen_all_od[0]))

    def _rep(a, rows=num_pools):
        """Report view of a per-week (S, R, ...) array: the N axis inserted
        on true scenario batches, passed through otherwise."""
        if not scen_axis:
            return a
        return a.reshape(a.shape[0], num_scen, rows, *a.shape[2:])

    report = RollingPlanReport(
        keys=pools.keys,
        options=options,
        cadence_weeks=cadence_weeks,
        start_weeks=start_weeks,
        horizon_weeks=horizon_weeks,
        weeks=weeks,
        targets=_rep(ys["target"]),
        increments=_rep(ys["inc"]),
        active=_rep(ys["active"]),
        committed_cost=_rep(ys["committed"]),
        on_demand_cost=_rep(ys["od"]),
        utilization=_rep(ys["util"]),
        ladders=ladders,
        total_cost=float(total),
        all_on_demand_cost=all_od,
        savings_vs_on_demand=1.0 - total / all_od if all_od > 0 else 0.0,
        policy_name=pcy.name,
        cadence=cadence,
        decision_mask=dec,
        n_scenarios=num_scen,
        scenario_family=scen.family if scen is not None else None,
        scenario_cost=scen_cost if scen is not None else None,
        od_rate=float(od),
        scenario_config=scen,
    )
    if dec_raw.ndim == 2 and scen_axis:
        # one flag per (week, scenario): the mask is uniform in a block
        report.decision_mask = dec_raw.reshape(
            len(weeks), num_scen, num_pools)[:, :, 0]
    if "band_lo" in ys:
        report.breach_band_lo = _rep(ys["band_lo"])
        report.breach_band_hi = _rep(ys["band_hi"])
    if sp_res is not None:
        report.spot_config = s_cfg
        report.spot_lines = base_lines
        report.spot_floor = _rep(ys["floor"])
        report.spot_cost = _rep(ys["spot"])
        report.spot_volume = _rep(ys["spot_vol"])
        # The fast half of the split as a tranche book: every spot tranche
        # lasts exactly one week, sized at the week's peak spot usage.
        report.spot_ladders = ld.spot_ladder_book(
            ys["spot_peak"][:, :num_pools], pools.keys,
            start_week=start_weeks,
        )
    if use_mig:
        report.migration_config = mig_cfg
        report.migration_edges = row_edges
    if conv_opts is not None:
        report.conv_options = conv_opts
        report.conv_clouds = tuple(conv_clouds)
        report.conv_targets = _rep(ys["conv_target"], num_clouds)
        report.conv_increments = _rep(ys["conv_inc"], num_clouds)
        report.conv_active = _rep(ys["conv_active"], num_clouds)
        report.conv_alloc = _rep(ys["conv_alloc"])
        report.conv_committed_cost = _rep(ys["conv_committed"], num_clouds)
        # The cloud-level tranche book (scenario 0's clouds), with the pool
        # book's increment-only semantics: its live widths reconcile with
        # the carried stack.
        conv_full = np.zeros((num_clouds, total_weeks, num_conv), np.float32)
        conv_full[:, weeks[dec]] = np.swapaxes(
            ys["conv_target"][:, :num_clouds][dec], 0, 1)
        report.conv_ladders = ld.convertible_ladder_book(
            conv_full,
            np.asarray([o.term_weeks for o in conv_opts]) * HOURS_PER_WEEK,
            conv_clouds,
        )
    if tele is not None:
        _attach_telemetry(
            report, tele, ys, dec, solver=solver,
            sweep_shape=(num_rows * horizon_weeks, num_grid, horizon_hours),
            num_pools=num_pools, num_scen=num_scen, rep=_rep,
            conv=(None if conv_opts is None
                  else (conv_opts, conv_clouds, num_clouds)),
            spot=sp_res is not None)
    if not compare:
        return report

    # One-shot baseline: identical replay (the same spot, migration and
    # convertible bands, if any), single decision week, always the standard
    # rolling policy on the prefix-sum refit.  Per scenario, its weekly
    # bills (S, N) and their sums in the unbatched order.
    one, _ = replay(0, fc.solve_prefix, pol.RollingPortfolioPolicy())
    num_weeks = len(weeks)
    one_weekly = (one["committed"] + one["od"]).reshape(
        num_weeks, num_scen, num_pools).sum(-1)
    if sp_res is not None:
        one_weekly = one_weekly + one["spot"].reshape(
            num_weeks, num_scen, num_pools).sum(-1)
    if conv_opts is not None:
        one_weekly = one_weekly + one["conv_committed"].reshape(
            num_weeks, num_scen, num_clouds).sum(-1)
    scen_one = np.asarray([
        float(np.ascontiguousarray(one_weekly[:, s]).sum())
        for s in range(num_scen)])
    report.one_shot_weekly_cost = (one_weekly if scen_axis
                                   else one_weekly[:, 0])
    report.one_shot_cost = (float(scen_one.mean()) if scen is not None
                            else float(scen_one[0]))
    if scen is not None:
        report.scenario_one_shot_cost = scen_one
    report.savings_vs_one_shot = (
        1.0 - total / report.one_shot_cost
        if report.one_shot_cost > 0 else 0.0
    )

    # Hindsight baseline: the optimal constant stack on realized demand
    # (billing lines, term_weighting=0: every active tranche bills its
    # rate; expiring short tranches are repurchased back-to-back), per row
    # on the device, each scenario's bill summed as its own block.
    al0, be0, _ = pf.pool_option_lines(
        options, clouds, term_weighting=0.0, od_rate=od, device=dev
    )
    eval_demand = demand[:, t0:]
    hs = pf.optimal_portfolio_stack(eval_demand, tile(al0), tile(be0),
                                    od_rate=od)
    hs_level = hs.widths.sum(-1)
    hs_over = torch.clamp(
        eval_demand.reshape(num_rows, num_weeks, HOURS_PER_WEEK)
        - hs_level[:, None, None], min=0.0).sum(-1)            # (R, S)
    hs_committed = (rates * hs.widths).sum(-1) * HOURS_PER_WEEK
    hs_weekly = (hs_committed[:, None] + od * hs_over).cpu().numpy()
    hs_widths = hs.widths.cpu().numpy()
    del hs, hs_over
    scen_hind = np.asarray([
        float(hs_weekly[blk].sum()) for blk in blocks])
    if scen_axis:
        report.hindsight_widths = hs_widths.reshape(num_scen, num_pools,
                                                    num_opts)
        report.hindsight_weekly_cost = hs_weekly.reshape(
            num_scen, num_pools, num_weeks).sum(1).T          # (S, N)
    else:
        report.hindsight_widths = hs_widths
        report.hindsight_weekly_cost = hs_weekly.sum(0)
    if scen is not None:
        report.scenario_hindsight_cost = scen_hind
        report.hindsight_cost = float(scen_hind.mean())
        report.scenario_cr = scen_cost / scen_hind
        report.scenario_regret = scen_cost - scen_hind
    else:
        report.hindsight_cost = float(scen_hind[0])
    report.regret_vs_hindsight = (
        total / report.hindsight_cost - 1.0
        if report.hindsight_cost > 0 else 0.0
    )
    return report
