"""The port's telemetry package (``repro_torch.obs``) against the JAX
package's (``repro.obs``): the weekly fractile levels, the cost ledger,
the calibration cube, the decision log, the span recorder, the sweep's
kernel stats and the ``python -m repro_torch.obs`` CLI.

Fleets: 4 pools x 52 weeks of the steady and unpredictable scenario
families, start 24, horizon 4, cadence 1 (the JAX package's
tests/test_obs.py sizes), and the all-bands fleet of test_torch_replan.py
(4 pools x 30 weeks, seed 3, the planted two-edge table, spot, migration
and convertible, cadence 2, start 8, horizon 6).

* Fractile levels: bit for bit with ``jnp.quantile`` (ties and n = 1
  included), which makes the calibration cube's levels, hits and pinball
  losses equal too.
* Ledger: under the quantile solver each cell within rtol 1e-3 / atol
  1e-2 of the JAX ledger (the replay's stack tolerance) and the total
  within rel 1e-4; under the grid solver the totals within rel 1e-3 (a
  target may move by a grid cell); with every band, each source's total
  within rel 1e-4 of the bill.  Within the port the ledger's on-demand
  and usage columns are the report's arrays and its weekly totals
  reconcile with the report's float32 weekly costs to the float32 sum's
  rounding (rel 1e-6).  Each package reads the other's JSONL export.
"""

import ast
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.capacity import generations as jgn  # noqa: E402
from repro.capacity import pricing as jpr  # noqa: E402
from repro.core import forecast as jfc  # noqa: E402
from repro.core import replan as jrp  # noqa: E402
from repro.data import scenarios as jsc  # noqa: E402
from repro.data import traces as jtr  # noqa: E402
from repro import obs as jobs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import obs as tobs  # noqa: E402
from repro_torch.core import api as tapi  # noqa: E402
from repro_torch.core import demand as tdm  # noqa: E402
from repro_torch.core import forecast as tfc  # noqa: E402
from repro_torch.core import planner as tpl  # noqa: E402
from repro_torch.core import replan as trp  # noqa: E402
from repro_torch.data import scenarios as tsc  # noqa: E402
from repro_torch.kernels.commitment_sweep import (  # noqa: E402
    commitment_sweep as tck,
)
from repro_torch.obs.__main__ import main as obs_cli  # noqa: E402

WK = 168
NUM_GRID = 128
KW = dict(cadence_weeks=1, start_weeks=24, horizon_weeks=4, compare=False)
TELE = dict(calibration=True, provenance=True)


@pytest.fixture(scope="module", autouse=True)
def _full_f32_matmuls():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_float32_matmul_precision(prev)


def _pools(family, num_pools=4, num_weeks=52):
    jp = jsc.scenario_pool_set(family, num_pools=num_pools,
                               num_weeks=num_weeks)
    return jp, tdm.PoolSet(keys=tuple(tuple(k) for k in jp.keys),
                           demand=np.array(jp.demand, np.float32))


@pytest.fixture(scope="module")
def steady():
    """(JAX, port) reports of the steady fleet with every telemetry layer,
    quantile solver."""
    jp, tp = _pools("steady")
    return (jrp.replan_fleet_pools(jp, telemetry=jobs.TelemetryConfig(**TELE),
                                   **KW),
            trp.replan_fleet_pools(tp, telemetry=tobs.TelemetryConfig(**TELE),
                                   device="cpu", **KW))


@pytest.fixture(scope="module")
def cubes(steady):
    """family -> (JAX cube, port cube) of the calibration telemetry."""
    jp, tp = _pools("unpredictable")
    tele = dict(calibration=True)
    rough = (
        jrp.replan_fleet_pools(jp, telemetry=jobs.TelemetryConfig(**tele),
                               **KW).calibration,
        trp.replan_fleet_pools(tp, telemetry=tobs.TelemetryConfig(**tele),
                               device="cpu", **KW).calibration)
    return {"steady": (steady[0].calibration, steady[1].calibration),
            "unpredictable": rough}


MIG_PLANT = jgn.MigrationConfig(generations=(
    jpr.Generation("aws", "C6i", "C7i", 8, 12.0, 0.25),
    jpr.Generation("gcp", "N2-Standard", "N4-Standard", 16, 10.0, 0.50),
))
BANDS_KW = dict(cadence_weeks=2, start_weeks=8, horizon_weeks=6,
                compare=False, spot=True, convertible=True)


@pytest.fixture(scope="module")
def bands():
    """(JAX, port) reports with spot, migration and convertible on and
    every telemetry layer."""
    jpools = jtr.synthetic_pool_set(num_pools=4, num_hours=30 * WK, seed=3,
                                    migration=MIG_PLANT)
    tpools = convert.pool_set_from_reference(jpools)
    tplant = convert.migration_config_from_reference(MIG_PLANT)
    return (
        jrp.replan_fleet_pools(jpools, migration=MIG_PLANT,
                               telemetry=jobs.TelemetryConfig(**TELE),
                               **BANDS_KW),
        trp.replan_fleet_pools(tpools, migration=tplant,
                               telemetry=tobs.TelemetryConfig(**TELE),
                               device="cpu", **BANDS_KW))


# -- configuration ---------------------------------------------------------

def test_telemetry_config_matches_reference():
    names = lambda cls: [f.name for f in dataclasses.fields(cls)]  # noqa
    assert names(tobs.TelemetryConfig) == names(jobs.TelemetryConfig)
    assert tobs.config.DEFAULT_FRACTILES == jobs.config.DEFAULT_FRACTILES
    assert tobs.resolve_telemetry(None) is None
    assert tobs.resolve_telemetry(False) is None
    assert tobs.resolve_telemetry(True) == tobs.TelemetryConfig()
    same = tobs.TelemetryConfig(ledger=True, kernel_stats=False)
    assert tobs.resolve_telemetry(same) is same
    assert tobs.resolve_telemetry(
        tobs.TelemetryConfig(ledger=False, kernel_stats=False)) is None
    with pytest.raises(TypeError):
        tobs.resolve_telemetry(1.5)


@pytest.mark.parametrize("fractiles", [(), (0.5, 0.25), (0.0, 0.5),
                                       (0.5, 1.0), (0.5, 0.5)])
def test_fractile_validation_matches(fractiles):
    with pytest.raises(ValueError, match="fractiles") as want:
        jobs.TelemetryConfig(fractiles=fractiles)
    with pytest.raises(ValueError, match="fractiles") as got:
        tobs.TelemetryConfig(fractiles=fractiles)
    assert str(got.value) == str(want.value)


def test_one_shot_telemetry_is_a_construction_error():
    _, tp = _pools("steady", num_weeks=12)
    with pytest.raises(ValueError, match="rolling"):
        tapi.PlanRequest(pools=tp, mode="one_shot", telemetry=True)
    with pytest.raises(TypeError, match="rolling"):
        tpl.plan_fleet_pools(tp, mode="one_shot", telemetry=True,
                             device="cpu")
    with pytest.raises(TypeError, match="telemetry"):
        tapi.PlanRequest(pools=tp, mode="rolling", telemetry="yes")


# -- fractile levels --------------------------------------------------------

def _level_cases():
    rng = np.random.default_rng(0)
    gamma = rng.gamma(2.0, 50.0, (64, 4 * WK)).astype(np.float32)
    ties = np.round(gamma[:8] / 40.0).astype(np.float32)
    return {"gamma": gamma, "ties": ties, "constant": np.full((2, 7), 3.5,
                                                              np.float32),
            "one_hour": gamma[:3, :1], "two_hours": gamma[:3, :2]}


@pytest.mark.parametrize("case", sorted(_level_cases()))
@pytest.mark.parametrize("fractiles", [jobs.config.DEFAULT_FRACTILES,
                                       (0.05, 0.95), (0.01, 0.333, 0.999)])
def test_anchored_fractile_levels_bit_for_bit(case, fractiles):
    x = _level_cases()[case]
    want = np.asarray(jfc.anchored_fractile_levels(jnp.asarray(x),
                                                   fractiles))
    got = tfc.anchored_fractile_levels(torch.from_numpy(x), fractiles)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_weekly_fractile_levels_bit_for_bit():
    x = _level_cases()["gamma"][:, None, :]                # (P, 1, T)
    fr = jobs.config.DEFAULT_FRACTILES
    want = np.asarray(jfc.weekly_fractile_levels(jnp.asarray(x), fr))
    got = tfc.weekly_fractile_levels(torch.from_numpy(x), fr).numpy()
    assert got.shape == want.shape == (64, 1, 5)
    np.testing.assert_array_equal(got, want)
    assert tfc.TRAIL_WEEKS == jfc.TRAIL_WEEKS


# -- ledger -------------------------------------------------------------------

def test_ledger_cells_match_reference(steady):
    jrep, trep = steady
    jl, tl = jrep.ledger, trep.ledger
    assert tl.entities == jl.entities and tl.sources == jl.sources
    np.testing.assert_array_equal(tl.weeks, jl.weeks)
    np.testing.assert_allclose(tl.cost, jl.cost, rtol=1e-3, atol=1e-2)
    np.testing.assert_allclose(tl.volume, jl.volume, rtol=1e-3, atol=1e-2)
    np.testing.assert_allclose(tl.used_hours, jl.used_hours, rtol=1e-3,
                               atol=1e-2)
    assert tl.total == pytest.approx(jl.total, rel=1e-4)
    assert tl.meta == {k: v for k, v in jl.meta.items()}


def test_ledger_reconciles_with_its_report(steady):
    rep = steady[1]
    led = rep.ledger
    res = led.reconcile(rep)
    assert res["ok"] and res["max_rel"] <= 1e-6, res
    od = led.sources.index("on_demand")
    np.testing.assert_array_equal(led.cost[:, :, od],
                                  rep.on_demand_cost.astype(np.float64))
    np.testing.assert_array_equal(led.volume[:, :, od], rep.od_volume)
    np.testing.assert_array_equal(led.used_hours, rep.used_hours)
    np.testing.assert_array_equal(
        led.cost[:, :, :len(rep.options)], rep.committed_by_sku)
    assert led.total == pytest.approx(rep.total_cost, rel=1e-6)


def test_ledger_grid_totals_match_reference():
    jp, tp = _pools("unpredictable")
    kw = dict(KW, solver="grid", num_grid=NUM_GRID, telemetry=True)
    jl = jrp.replan_fleet_pools(jp, **kw).ledger
    trep = trp.replan_fleet_pools(tp, device="cpu", **kw)
    tl = trep.ledger
    assert tl.total == pytest.approx(jl.total, rel=1e-3)
    for src, val in jl.by_source().items():
        assert tl.by_source()[src] == pytest.approx(val, rel=1e-3,
                                                    abs=1e-3 * jl.total)
    assert tl.reconcile(trep)["ok"]
    # the meta carries the CUDA launch's stats, not the reference's tile
    assert tl.meta["kernel_stats"] == trep.kernel_stats.to_dict()
    assert {k: v for k, v in tl.meta.items() if k != "kernel_stats"} == {
        k: v for k, v in jl.meta.items() if k != "kernel_stats"}


def test_ledger_with_every_band_matches_reference(bands):
    jrep, trep = bands
    jl, tl = jrep.ledger, trep.ledger
    assert tl.entities == jl.entities and tl.sources == jl.sources
    assert {"spot_market", "spot_requeue", "spot_fallback"} <= set(tl.sources)
    assert any(e.startswith("cloud:") for e in tl.entities)
    for src, val in jl.by_source().items():
        assert tl.by_source()[src] == pytest.approx(val, abs=1e-4 * jl.total)
    for ent, val in jl.by_entity().items():
        assert tl.by_entity()[ent] == pytest.approx(val, abs=1e-4 * jl.total)
    assert tl.total == pytest.approx(jl.total, rel=1e-4)
    res = tl.reconcile(trep)
    assert res["ok"] and res["max_rel"] <= 1e-6, res
    # the spot band's three parts sum to the report's spot spend
    spot = [tl.sources.index(s) for s in ("spot_market", "spot_requeue",
                                          "spot_fallback")]
    np.testing.assert_allclose(tl.cost[:, :4, spot].sum(-1),
                               trep.spot_cost, rtol=1e-9, atol=1e-6)


def test_ledger_slices_and_economics(bands):
    led = bands[1].ledger
    total = led.attribute()
    np.testing.assert_allclose(total, led.total, rtol=1e-12)
    np.testing.assert_allclose(sum(led.attribute(week=int(w))
                                   for w in led.weeks), total, rtol=1e-9)
    np.testing.assert_allclose(sum(led.attribute(pool=e)
                                   for e in led.entities), total, rtol=1e-9)
    for kw in ({"pool": "not/a/pool"}, {"source": "nope"},
               {"week": 10 ** 6}, {"sku": "nope"}):
        with pytest.raises(KeyError):
            led.attribute(**kw)
    econ = led.unit_economics()
    parts = (econ["committed_cost"] + econ["convertible_cost"]
             + econ["on_demand_cost"] + econ["spot_cost"])
    np.testing.assert_allclose(parts, econ["total_cost"], rtol=1e-9)
    assert 0.0 <= econ["idle_fraction"] <= 1.0
    assert econ["cost_per_used_chip_hour"] > 0.0
    assert econ == pytest.approx(bands[0].ledger.unit_economics(), rel=1e-3)
    idle = dataclasses.replace(led, used_hours=np.zeros_like(led.used_hours))
    assert idle.unit_economics()["idle_only"] is True
    assert idle.unit_economics()["cost_per_used_chip_hour"] == 0.0


def test_ledger_diff_and_movers(bands):
    led = bands[1].ledger
    cost2 = led.cost.copy()
    od = led.sources.index("on_demand")
    cost2[:, 0, od] += 100.0
    diff = dataclasses.replace(led, cost=cost2).diff(led)
    np.testing.assert_allclose(diff.total_delta, 100.0 * len(led.weeks))
    e, s, d = diff.top_movers(1)[0]
    assert (e, s) == (led.entities[0], "on_demand")
    assert "on_demand" in diff.report()
    assert led.diff(led).top_movers(10) == []


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_ledger_jsonl_reads_across_packages(bands, tmp_path, writer):
    """Each package's CostLedger.from_jsonl reads the other's export to
    the same cells, bit for bit."""
    jl, tl = bands[0].ledger, bands[1].ledger
    src = tl if writer == "port" else jl
    path = str(tmp_path / "ledger.jsonl")
    src.to_jsonl(path)
    for cls in (tobs.CostLedger, jobs.CostLedger):
        back = cls.from_jsonl(path)
        assert back.entities == src.entities and back.sources == src.sources
        np.testing.assert_array_equal(back.cost, src.cost)
        np.testing.assert_array_equal(back.volume, src.volume)
        np.testing.assert_array_equal(back.used_hours, src.used_hours)
        np.testing.assert_array_equal(back.utilization, src.utilization)
        assert back.meta == json.loads(json.dumps(src.meta))


def test_ledger_scenarios():
    """A scenario batch bills scenario 0 by default; any scenario's ledger
    reconciles with its own column, as the reference's does."""
    jpools = jtr.synthetic_pool_set(num_pools=2, num_hours=WK * 12)
    tp = convert.pool_set_from_reference(jpools)
    kw = dict(spot=True, cadence_weeks=2, start_weeks=4, horizon_weeks=4,
              compare=False, telemetry=True)
    rep = trp.replan_fleet_pools(
        tp, scenarios=tsc.ScenarioConfig(n_scenarios=3, family="growth"),
        device="cpu", **kw)
    want = jrp.replan_fleet_pools(
        jpools, scenarios=jsc.ScenarioConfig(n_scenarios=3, family="growth"),
        **kw)
    assert rep.ledger.meta["scenario"] == 0 and rep.ledger.reconcile(rep)["ok"]
    led1 = tobs.ledger_from_report(rep, scenario=1)
    res = led1.reconcile(rep)
    assert res["ok"] and res["scenario"] == 1
    assert led1.total == pytest.approx(
        jobs.ledger_from_report(want, scenario=1).total, rel=1e-4)
    assert not led1.reconcile(rep, scenario=0)["ok"]
    with pytest.raises(ValueError, match="out of range"):
        tobs.ledger_from_report(rep, scenario=3)
    solo = trp.replan_fleet_pools(tp, device="cpu", **kw)
    with pytest.raises(ValueError, match="out of range"):
        tobs.ledger_from_report(solo, scenario=1)
    plain = dataclasses.replace(solo, committed_by_sku=None)
    with pytest.raises(ValueError, match="telemetry"):
        tobs.ledger_from_report(plain)


# -- calibration ----------------------------------------------------------------

@pytest.mark.parametrize("family", ["steady", "unpredictable"])
def test_calibration_cube_matches_reference(cubes, family):
    """Levels, hits, the realized mean and peak bit for bit; the pinball
    loss, whose 168-hour float64 sums the replay runs in another order,
    to rel 1e-12."""
    jc, tc = cubes[family]
    assert tc.entities == jc.entities and tc.fractiles == jc.fractiles
    np.testing.assert_array_equal(tc.weeks, jc.weeks)
    for name in ("levels", "hits", "realized_mean", "realized_peak"):
        np.testing.assert_array_equal(getattr(tc, name), getattr(jc, name),
                                      err_msg=name)
    np.testing.assert_allclose(tc.pinball, jc.pinball, rtol=1e-12)
    summ, jsumm = tc.summary(), jc.summary()
    assert summ.keys() == jsumm.keys()
    for key, val in jsumm.items():
        assert summ[key] == pytest.approx(val, rel=1e-12), key


def test_calibration_from_arrays_bit_for_bit():
    """The host-side scoring is the reference's arithmetic, bit for bit,
    including the pinball loss; the replay's device scoring agrees to
    rel 1e-12."""
    rng = np.random.default_rng(1)
    levels = np.sort(rng.gamma(2.0, 50.0, (6, 8, 5)), -1).astype(np.float32)
    realized = rng.gamma(2.0, 50.0, (6, 8, WK)).astype(np.float32)
    fr = jobs.config.DEFAULT_FRACTILES
    args = (np.arange(6), [f"p{i}" for i in range(4)], fr, levels, realized)
    got = tobs.calibration_from_arrays(*args, n_scenarios=2)
    want = jobs.calibration_from_arrays(*args, n_scenarios=2)
    for name in ("levels", "hits", "pinball", "realized_mean",
                 "realized_peak"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)
    scores = [trp._calibration_scores(torch.from_numpy(realized[s]),
                                      torch.from_numpy(levels[s]), fr)
              for s in range(6)]
    dev = tobs.calibration_from_scores(
        *args[:4], *(np.stack([sc[k].numpy() for sc in scores])
                     for k in ("calib_hits", "calib_pinball", "calib_mean",
                               "calib_peak")), n_scenarios=2)
    for name in ("levels", "hits", "realized_peak"):
        np.testing.assert_array_equal(getattr(dev, name),
                                      getattr(want, name), err_msg=name)
    np.testing.assert_allclose(dev.pinball, want.pinball, rtol=1e-12)
    np.testing.assert_allclose(dev.realized_mean, want.realized_mean,
                               rtol=1e-12)
    with pytest.raises(ValueError, match="factor") as got_err:
        tobs.calibration_from_arrays(*args, n_scenarios=3)
    with pytest.raises(ValueError, match="factor") as want_err:
        jobs.calibration_from_arrays(*args, n_scenarios=3)
    assert str(got_err.value) == str(want_err.value)


def test_calibration_properties(cubes):
    steady, rough = cubes["steady"][1], cubes["unpredictable"][1]
    assert steady.max_coverage_drift <= 0.03, steady.report()
    assert rough.max_coverage_drift > steady.max_coverage_drift
    diff = rough.diff(steady)
    assert diff.drift_a > diff.drift_b and "d-coverage" in diff.report()
    with pytest.raises(KeyError, match="not carried"):
        steady.interval_width(0.123, 0.456)
    other = dataclasses.replace(steady, fractiles=(0.1, 0.5, 0.9),
                                levels=steady.levels[..., :3],
                                hits=steady.hits[..., :3],
                                pinball=steady.pinball[..., :3])
    with pytest.raises(ValueError, match="fractile") as got:
        steady.diff(other)
    with pytest.raises(ValueError, match="fractile") as want:
        cubes["steady"][0].diff(other)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="out of range"):
        steady.coverage(scenario=1)


def test_calibration_jsonl_reads_across_packages(cubes, tmp_path):
    jc, tc = cubes["unpredictable"]
    for src, name in ((tc, "port"), (jc, "jax")):
        path = str(tmp_path / f"{name}.jsonl")
        src.to_jsonl(path)
        for cls in (tobs.CalibrationCube, jobs.CalibrationCube):
            back = cls.from_jsonl(path)
            np.testing.assert_array_equal(back.hits, src.hits)
            np.testing.assert_array_equal(back.levels, src.levels)
            assert back.diff(src).max_abs_coverage_delta == 0.0


def test_calibration_needs_a_forecasting_policy():
    _, tp = _pools("steady", num_weeks=12)
    with pytest.raises(ValueError, match="forecast"):
        trp.replan_fleet_pools(
            tp, policy="deterministic_hedge", cadence_weeks=1, start_weeks=6,
            horizon_weeks=4, compare=False, device="cpu",
            telemetry=tobs.TelemetryConfig(calibration=True))


# -- provenance -----------------------------------------------------------------

def test_decision_log_matches_reference(bands):
    jlog, tlog = bands[0].decision_log, bands[1].decision_log
    assert tlog.entities == jlog.entities and tlog.skus == jlog.skus
    assert tlog.conv_clouds == jlog.conv_clouds
    np.testing.assert_array_equal(tlog.is_decision, jlog.is_decision)
    np.testing.assert_array_equal(tlog.binding, jlog.binding)
    np.testing.assert_allclose(tlog.increments, jlog.increments, rtol=1e-3,
                               atol=1e-2)
    np.testing.assert_allclose(tlog.rolloffs, jlog.rolloffs, rtol=1e-3,
                               atol=1e-2)
    assert tlog.binding_counts() == jlog.binding_counts()
    summ, jsumm = tlog.summary(), jlog.summary()
    assert summ.keys() == jsumm.keys()
    assert summ["binding_counts"] == jsumm["binding_counts"]


def test_decision_log_holdings_rebuild_active(bands):
    log = bands[1].decision_log
    mask = bands[1].decision_mask
    np.testing.assert_array_equal(log.decision_weeks, log.weeks[mask])
    assert float(log.increments[~log.is_decision].sum()) == 0.0
    for week in map(int, log.weeks[[0, len(log.weeks) // 2, -1]]):
        si = int(np.flatnonzero(log.weeks == week)[0])
        held = log.holdings(week)
        for pi, pool in enumerate(log.entities):
            np.testing.assert_allclose(
                sum(t["width"] for t in held[pool]), log.active[si, pi].sum(),
                rtol=1e-6, atol=1e-6)
            for t in held[pool]:
                assert t["bought_week"] <= week < t["expires_week"]
    rec = log.explain(int(log.decision_weeks[0]))
    assert set(rec["pools"][log.entities[0]]) == {
        "binding", "bought", "rolled_off", "target_top", "stack_top"}
    assert set(rec["clouds"][log.conv_clouds[0]]) == {
        "bought", "rolled_off", "stack_top"}
    with pytest.raises(KeyError, match="not in log"):
        log.explain(10 ** 6)


def test_spot_free_log_has_no_spot_cap(steady):
    counts = steady[1].decision_log.binding_counts()
    assert counts == steady[0].decision_log.binding_counts()
    assert counts["spot_cap"] == 0 and counts["envelope"] >= 1
    assert steady[1].decision_log.conv_clouds is None


# -- spans --------------------------------------------------------------------

def _fake_clock():
    state = {"t": 0.0}

    def clock():
        state["t"] += 1.0
        return state["t"]

    return clock


def test_spans_nest_with_a_caller_clock():
    rec = tobs.SpanRecorder(clock=_fake_clock())
    assert rec.timer == "clock"
    with rec.span("outer", phase="execute"):
        with rec.span("inner"):
            pass
    outer, inner = rec.spans
    assert (outer.depth, outer.parent, inner.depth, inner.parent) == (
        0, -1, 1, 0)
    assert (inner.duration_s, outer.duration_s, rec.total_s) == (1.0, 3.0,
                                                                3.0)
    assert rec.by_phase() == {"compile": 0.0, "execute": 2.0, "host": 1.0}
    summ = rec.summary()
    assert summ["outer"]["count"] == 1 and summ["inner"]["mean_s"] == 1.0
    assert "total execute" in rec.report()
    # the same clock through the reference's recorder gives the same tree
    ref = jobs.SpanRecorder(clock=_fake_clock())
    with ref.span("outer", phase="execute"):
        with ref.span("inner"):
            pass
    assert rec.to_dicts() == ref.to_dicts()


def test_spans_phase_json_and_noop(tmp_path):
    rec = tobs.SpanRecorder(clock=_fake_clock())
    with pytest.raises(ValueError, match="phase"):
        with rec.span("x", phase="gpu"):
            pass
    with rec.span("a"):
        pass
    path = tmp_path / "spans.json"
    rec.to_json(str(path))
    payload = json.loads(path.read_text())
    assert payload["spans"][-1]["name"] == "a"
    assert set(payload["by_phase"]) == {"compile", "execute", "host"}
    with tobs.span(None, "anything") as s:
        assert s is None


def test_span_recorder_without_a_clock_needs_the_card():
    with pytest.raises(ValueError, match="clock="):
        tobs.SpanRecorder(device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            tobs.SpanRecorder()


# -- kernel stats ---------------------------------------------------------------

def _shared_bytes_of_source() -> int:
    """Static shared memory of the sweep kernel, summed from the
    ``__shared__`` declarations of its CUDA source."""
    text = tck.SOURCE.read_text()
    consts = {"kTile": tck.CANDIDATE_TILE, "kWarps": tck.THREADS // 32}
    sizes = {"float": 4, "unsigned char": 1, "long long": 8}
    total = 0
    for line in text.splitlines():
        line = line.strip()
        if not line.startswith("__shared__"):
            continue
        decl = line[len("__shared__"):].rstrip(";").strip()
        ctype = next(t for t in sizes if decl.startswith(t + " "))
        dims = decl[decl.index("["):].strip("[]").split("][")
        count = 1
        for d in dims:
            count *= eval(d, {}, dict(consts))  # noqa: S307
        total += sizes[ctype] * count
    return total


def test_kernel_stats_match_the_launch():
    assert tck.SHARED_BYTES == _shared_bytes_of_source()
    assert f"kThreads = {tck.THREADS};" in tck.SOURCE.read_text()
    assert f"kTile = {tck.CANDIDATE_TILE};" in tck.SOURCE.read_text()
    ks = tobs.sweep_kernel_stats(8192, 128, 1344)
    assert (ks.p, ks.g, ks.t, ks.grid) == (8192, 128, 1344, (8192, 1))
    assert ks.threads_per_block == 128 and ks.blocks == 8192
    assert ks.shared_bytes_per_block == tck.SHARED_BYTES
    assert ks.bytes_moved == 4 * (2 * 8192 * 1344 + 3 * 8192 * 128)
    assert ks.flops == 4 * 8192 * 1344 * 128
    assert tobs.sweep_kernel_stats(3, 129, 5).grid == (3, 2)
    d = ks.to_dict()
    assert d["grid"] == [8192, 1] and d["blocks"] == 8192
    json.dumps(d)
    with pytest.raises(dataclasses.FrozenInstanceError):
        ks.p = 1


def test_grid_report_carries_kernel_stats():
    _, tp = _pools("steady", num_weeks=12)
    kw = dict(cadence_weeks=2, start_weeks=6, horizon_weeks=4, compare=False,
              device="cpu")
    rep = trp.replan_fleet_pools(tp, solver="grid", num_grid=NUM_GRID,
                                 telemetry=True, **kw)
    assert rep.kernel_stats == tobs.sweep_kernel_stats(4 * 4, NUM_GRID,
                                                       4 * WK)
    assert rep.ledger.meta["kernel_stats"] == rep.kernel_stats.to_dict()
    quantile = trp.replan_fleet_pools(tp, telemetry=True, **kw)
    assert quantile.kernel_stats is None
    assert "kernel_stats" not in quantile.ledger.meta


# -- CLI ------------------------------------------------------------------------

@pytest.fixture(scope="module")
def exported(bands, cubes, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("obs_cli")
    led = bands[1].ledger
    paths = {name: str(tmp / f"{name}.jsonl")
             for name in ("a", "b", "steady", "rough")}
    led.to_jsonl(paths["a"])
    dataclasses.replace(led, cost=led.cost + 1.0).to_jsonl(paths["b"])
    cubes["steady"][1].to_jsonl(paths["steady"])
    cubes["unpredictable"][1].to_jsonl(paths["rough"])
    return paths


def test_cli_report_diff_top(exported, tmp_path, capsys):
    a, b = exported["a"], exported["b"]
    out_json = str(tmp_path / "report.json")
    assert obs_cli(["report", a, "--json", out_json]) == 0
    assert "spend by source" in capsys.readouterr().out
    payload = json.loads(Path(out_json).read_text())
    assert "unit_economics" in payload and "by_source" in payload
    assert obs_cli(["diff", a, a]) == 0
    assert obs_cli(["diff", a, b]) == 0
    assert obs_cli(["diff", a, b, "--fail-above", "0.5"]) == 1
    assert "FAIL" in capsys.readouterr().err
    assert obs_cli(["top", a, "-n", "3"]) == 0
    assert obs_cli(["top", a, b, "--fail-above", "0.5"]) == 1
    assert "top 3 spend cells" in capsys.readouterr().out


def test_cli_calib(exported, tmp_path, capsys):
    a, b = exported["steady"], exported["rough"]
    out_json = str(tmp_path / "calib.json")
    assert obs_cli(["calib", a, "--json", out_json]) == 0
    assert "max_coverage_drift" in json.loads(Path(out_json).read_text())
    assert obs_cli(["calib", a, "--fail-above", "0.5"]) == 0
    assert obs_cli(["calib", a, "--fail-above", "0.0"]) == 1
    assert obs_cli(["calib", a, a]) == 0
    assert obs_cli(["calib", a, b, "--fail-above", "1.0"]) == 0
    assert obs_cli(["calib", a, b, "--fail-above", "0.0"]) == 1
    assert "FAIL" in capsys.readouterr().err


def test_cli_exit_codes_match_reference(exported):
    """The same arguments give the same exit codes through both CLIs."""
    from repro.obs.__main__ import main as ref_cli
    a, b = exported["a"], exported["b"]
    for argv in (["report", a], ["diff", a, b, "--fail-above", "0.5"],
                 ["top", a, b, "--fail-above", "1e9"],
                 ["calib", exported["steady"], "--fail-above", "0.0"]):
        assert obs_cli(list(argv)) == ref_cli(list(argv)), argv


def test_cli_module_source_reads_no_clock():
    """The CLI and every obs module read no clock of their own."""
    root = Path(tobs.__file__).parent
    for path in sorted(root.glob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                assert "time" not in [a.name for a in node.names], path
            if isinstance(node, ast.ImportFrom):
                assert node.module != "time", path
