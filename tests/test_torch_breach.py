"""The breach cadence, the carried IRLS moments and the telemetry-off
contract of the port's rolling replay, against the JAX package.

Fleets: 4 pools x 52 weeks of the steady and unpredictable scenario
families (the JAX package's ``scenario_pool_set`` demand, carried across
as numpy), start 24, horizon 4, cadence 1 (the reference's breach tests).

* Breach bands are empirical fractiles of realized demand alone, so the
  port's bands equal the JAX package's bit for bit, and with them the
  decision mask.  The bills agree within rel 1e-4 (quantile solver) and
  rel 1e-3 (grid solver), the tolerances of test_torch_replan.py.  A host
  python loop over the emitted bands reproduces the port's mask bit for
  bit, as the reference's tests/test_obs.py holds its own.
* The carried moments agree with the reference at the refit tolerance of
  test_torch_forecast.py (forecasts within rel 1e-4), and a carried plan
  keeps the reference's properties (tests/test_api.py::TestIrlsCarry).
* Scenario batches decide per scenario; scenario 0 and a chunked batch
  equal the unbatched and the unchunked replays bit for bit.
* Telemetry leaves what is bought and billed as it was, bit for bit.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import api as japi  # noqa: E402
from repro.core import forecast as jfc  # noqa: E402
from repro.core import replan as jrp  # noqa: E402
from repro.data import scenarios as jsc  # noqa: E402
from repro.data import traces as jtr  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import api as tapi  # noqa: E402
from repro_torch.core import demand as tdm  # noqa: E402
from repro_torch.core import forecast as tfc  # noqa: E402
from repro_torch.core import replan as trp  # noqa: E402
from repro_torch.data import scenarios as tsc  # noqa: E402
from repro_torch.obs import TelemetryConfig  # noqa: E402

WK = 168
NUM_GRID = 128
START = 24
BREACH = dict(cadence_weeks=1, cadence="breach", start_weeks=START,
              horizon_weeks=4, compare=False)
WEEKLY = dict(BREACH, cadence="weekly")
FAMILIES = ("steady", "unpredictable")


@pytest.fixture(scope="module", autouse=True)
def _full_f32_matmuls():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_float32_matmul_precision(prev)


def _pools(family, num_pools=4, num_weeks=52):
    """The JAX package's scenario fleet and the port's PoolSet of the same
    demand."""
    jp = jsc.scenario_pool_set(family, num_pools=num_pools,
                               num_weeks=num_weeks)
    return jp, tdm.PoolSet(keys=tuple(tuple(k) for k in jp.keys),
                           demand=np.array(jp.demand, np.float32))


@pytest.fixture(scope="module")
def fleets():
    return {f: _pools(f) for f in FAMILIES}


@pytest.fixture(scope="module")
def breach_reports(fleets):
    """family -> (JAX report, port report) of the breach replay."""
    return {f: (jrp.replan_fleet_pools(jp, **BREACH),
                trp.replan_fleet_pools(tp, device="cpu", **BREACH))
            for f, (jp, tp) in fleets.items()}


def _oracle_mask(demand, lo_all, hi_all, start, band=(0.05, 0.95),
                 tol=4.0):
    """The breach mask replayed by a host python loop over the emitted
    bands: integer hour counts against integer budgets."""
    q_lo, q_hi = band
    allow_above = int(tol * (1.0 - q_hi) * WK)
    allow_below = int(tol * q_lo * WK)
    demand = np.asarray(demand).reshape(demand.shape[0], -1, WK)
    want = np.zeros(lo_all.shape[0], bool)
    lo = np.zeros(demand.shape[0], np.float32)
    hi = np.zeros(demand.shape[0], np.float32)
    for i in range(lo_all.shape[0]):
        w = start + i
        d_prev = demand[:, w - 1]
        above = (d_prev > hi[:, None]).sum(-1)
        below = (d_prev < lo[:, None]).sum(-1)
        want[i] = bool(((above > allow_above) | (below > allow_below)).any()
                       or w == start)
        if want[i]:
            lo, hi = lo_all[i], hi_all[i]
    return want


@pytest.mark.parametrize("family", FAMILIES)
def test_breach_bands_and_mask_bit_for_bit(breach_reports, family):
    jrep, trep = breach_reports[family]
    np.testing.assert_array_equal(trep.breach_band_lo,
                                  np.asarray(jrep.breach_band_lo))
    np.testing.assert_array_equal(trep.breach_band_hi,
                                  np.asarray(jrep.breach_band_hi))
    np.testing.assert_array_equal(trep.decision_mask,
                                  np.asarray(jrep.decision_mask))
    assert trep.decision_mask.dtype == bool
    assert trep.decision_mask.shape == (52 - START,)


@pytest.mark.parametrize("family", FAMILIES)
def test_breach_bills_match(breach_reports, family):
    jrep, trep = breach_reports[family]
    assert trep.total_cost == pytest.approx(jrep.total_cost, rel=1e-4)
    np.testing.assert_allclose(trep.active, np.asarray(jrep.active),
                               rtol=1e-3, atol=1e-2)
    np.testing.assert_allclose(trep.weekly_cost, jrep.weekly_cost,
                               rtol=1e-3)


@pytest.mark.parametrize("family", FAMILIES)
def test_python_loop_oracle_reproduces_mask(fleets, breach_reports, family):
    _, tpools = fleets[family]
    _, trep = breach_reports[family]
    want = _oracle_mask(tpools.demand, trep.breach_band_lo,
                        trep.breach_band_hi, START)
    np.testing.assert_array_equal(want, trep.decision_mask)
    # non-decision weeks buy nothing
    assert float(trep.increments[~trep.decision_mask].sum()) == 0.0


def test_breach_grid_solver_matches(fleets):
    jp, tp = fleets["steady"]
    kw = dict(BREACH, solver="grid", num_grid=NUM_GRID)
    jrep = jrp.replan_fleet_pools(jp, **kw)
    trep = trp.replan_fleet_pools(tp, device="cpu", **kw)
    np.testing.assert_array_equal(trep.decision_mask,
                                  np.asarray(jrep.decision_mask))
    np.testing.assert_array_equal(trep.breach_band_hi,
                                  np.asarray(jrep.breach_band_hi))
    assert trep.total_cost == pytest.approx(jrep.total_cost, rel=1e-3)


def test_breach_skips_decisions_at_tiny_cost_delta(fleets, breach_reports):
    """The reference's acceptance property, on the port: at most 40% of
    the weekly cadence's decision weeks on the steady fleet, within 1% of
    its bill."""
    _, tp = fleets["steady"]
    _, breach = breach_reports["steady"]
    weekly = trp.replan_fleet_pools(tp, device="cpu", **WEEKLY)
    assert int(breach.decision_mask.sum()) <= 0.4 * int(
        weekly.decision_mask.sum())
    assert abs(breach.total_cost - weekly.total_cost) <= (
        0.01 * weekly.total_cost)
    assert breach.summary()["cadence"] == "breach"
    assert breach.summary()["decision_weeks"] == int(
        breach.decision_mask.sum())
    assert "cadence" not in weekly.summary()
    assert weekly.cadence == "weekly" and weekly.breach_band_lo is None


def test_report_carries_cadence_and_bands(breach_reports):
    _, rep = breach_reports["unpredictable"]
    assert rep.cadence == "breach"
    s = len(rep.weeks)
    assert rep.breach_band_lo.shape == rep.breach_band_hi.shape == (s, 4)
    assert (rep.breach_band_hi >= rep.breach_band_lo).all()
    # the ladder books replay the breach decisions
    for i, w in enumerate(rep.weeks):
        np.testing.assert_allclose(
            rep.ladders.option_widths(int(w) * WK, len(rep.options)),
            rep.active[i], rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def scen_fleet():
    jpools = jtr.synthetic_pool_set(num_pools=2, num_hours=WK * 16)
    return jpools, convert.pool_set_from_reference(jpools)


SCEN_KW = dict(cadence_weeks=1, cadence="breach", start_weeks=8,
               horizon_weeks=4, compare=False)


@pytest.fixture(scope="module")
def scen_reports(scen_fleet):
    jp, tp = scen_fleet
    cfg = dict(n_scenarios=3, family="regime")
    tele = TelemetryConfig(calibration=True)
    return {
        "jax": jrp.replan_fleet_pools(
            jp, scenarios=jsc.ScenarioConfig(**cfg), **SCEN_KW),
        "port": trp.replan_fleet_pools(
            tp, scenarios=tsc.ScenarioConfig(**cfg), device="cpu",
            telemetry=tele, **SCEN_KW),
        "chunked": trp.replan_fleet_pools(
            tp, scenarios=tsc.ScenarioConfig(**cfg, chunk=2), device="cpu",
            telemetry=tele, **SCEN_KW),
        "solo": trp.replan_fleet_pools(tp, device="cpu", telemetry=tele,
                                       **SCEN_KW),
    }


def test_scenario_batched_breach_masks_per_scenario(scen_reports):
    rep = scen_reports["port"]
    mask = rep.decision_mask
    assert mask.shape == (len(rep.weeks), 3) and mask.dtype == bool
    np.testing.assert_array_equal(mask,
                                  np.asarray(scen_reports["jax"].decision_mask))
    np.testing.assert_array_equal(
        rep.breach_band_lo, np.asarray(scen_reports["jax"].breach_band_lo))
    # regime futures re-plan on another schedule than the realized trace
    assert (mask[:, 1:] != mask[:, :1]).any()
    np.testing.assert_allclose(rep.scenario_cost,
                               scen_reports["jax"].scenario_cost, rtol=1e-4)


def test_scenario_zero_is_the_unbatched_breach_replay(scen_reports):
    rep, solo = scen_reports["port"], scen_reports["solo"]
    np.testing.assert_array_equal(rep.decision_mask[:, 0],
                                  solo.decision_mask)
    for name in ("breach_band_lo", "breach_band_hi", "targets", "active",
                 "committed_cost", "fractile_levels"):
        np.testing.assert_array_equal(getattr(rep, name)[:, 0],
                                      getattr(solo, name), err_msg=name)
    assert float(rep.scenario_cost[0]) == solo.total_cost
    np.testing.assert_array_equal(rep.calibration.hits[:, :1],
                                  solo.calibration.hits)


def test_chunked_breach_batch_equals_unchunked(scen_reports):
    full, chunked = scen_reports["port"], scen_reports["chunked"]
    for name in ("decision_mask", "breach_band_lo", "breach_band_hi",
                 "targets", "active", "committed_cost", "on_demand_cost",
                 "fractile_levels", "used_hours", "committed_by_sku",
                 "scenario_cost"):
        np.testing.assert_array_equal(getattr(chunked, name),
                                      getattr(full, name), err_msg=name)
    assert chunked.total_cost == full.total_cost
    for name in ("levels", "hits", "pinball", "realized_mean",
                 "realized_peak"):
        np.testing.assert_array_equal(getattr(chunked.calibration, name),
                                      getattr(full.calibration, name))
    assert chunked.calibration.n_scenarios == 3


def test_breach_validation_errors(fleets):
    _, tp = fleets["steady"]
    with pytest.raises(ValueError, match="cadence"):
        trp.replan_fleet_pools(tp, device="cpu", **dict(BREACH,
                                                       cadence="hourly"))
    with pytest.raises(ValueError, match="cadence_weeks=1"):
        trp.replan_fleet_pools(tp, device="cpu", **dict(BREACH,
                                                       cadence_weeks=2))
    with pytest.raises(ValueError, match="forecast"):
        trp.replan_fleet_pools(tp, policy="deterministic_hedge",
                               device="cpu", **BREACH)
    with pytest.raises(ValueError, match="forecast"):
        trp.replan_fleet_pools(tp, policy="hindsight", device="cpu",
                               telemetry=TelemetryConfig(calibration=True),
                               **WEEKLY)
    with pytest.raises(ValueError, match="cadence"):
        tapi.RollingConfig(cadence="hourly")
    with pytest.raises(ValueError, match="cadence_weeks=1"):
        tapi.RollingConfig(cadence="breach", cadence_weeks=2)
    with pytest.raises(ValueError, match="breach_band"):
        tapi.RollingConfig(breach_band=(0.9, 0.1))
    with pytest.raises(ValueError, match="breach_tolerance"):
        tapi.RollingConfig(breach_tolerance=0.0)


def test_breach_through_the_request(fleets, breach_reports):
    """api.plan reaches the same replay, with a non-default band and
    tolerance threaded through as the reference threads them."""
    jp, tp = fleets["steady"]
    rolling = dict(cadence_weeks=1, cadence="breach", start_weeks=START,
                   compare=False)
    rep = tapi.plan(tapi.PlanRequest(
        pools=tp, mode="rolling", horizon_weeks=4,
        rolling=tapi.RollingConfig(**rolling)), device="cpu")
    _, direct = breach_reports["steady"]
    np.testing.assert_array_equal(rep.decision_mask, direct.decision_mask)
    assert rep.total_cost == direct.total_cost
    narrow = dict(rolling, breach_band=(0.25, 0.75), breach_tolerance=1.0)
    got = tapi.plan(tapi.PlanRequest(
        pools=tp, mode="rolling", horizon_weeks=4,
        rolling=tapi.RollingConfig(**narrow)), device="cpu")
    want = japi.plan(japi.PlanRequest(
        pools=jp, mode="rolling", horizon_weeks=4,
        rolling=japi.RollingConfig(**narrow)))
    np.testing.assert_array_equal(got.decision_mask,
                                  np.asarray(want.decision_mask))
    np.testing.assert_array_equal(got.breach_band_lo,
                                  np.asarray(want.breach_band_lo))
    assert got.decision_mask.sum() > direct.decision_mask.sum()


# The carried IRLS moments, on test_torch_forecast.py's fleet: 4 pools x
# 20 weeks of the JAX package's synthetic demand, start 6, horizon 3.
FC_START, FC_HORIZON = 6, 3 * WK
YHAT_RTOL = 1e-4


@pytest.fixture(scope="module")
def states():
    demand = np.asarray(
        jtr.synthetic_pool_set(num_pools=4, num_hours=20 * WK).demand)
    kw = dict(horizon_hours=FC_HORIZON, min_prefix_hours=FC_START * WK)
    return (
        jfc.prefix_fit_state(jnp.asarray(demand), jfc.ForecastConfig(), **kw),
        tfc.prefix_fit_state(torch.from_numpy(demand), tfc.ForecastConfig(),
                             **kw),
    )


def _yhat_j(js, beta, week):
    return np.asarray(jfc.predict_from_beta(js, beta, week * WK, FC_HORIZON))


def _yhat_t(ts, beta, week):
    return tfc.predict_from_beta(ts, beta, week * WK, FC_HORIZON).numpy()


@pytest.mark.parametrize("iters", [1, 2])
def test_irls_carry_init_matches(states, iters):
    js, ts = states
    jg, jr = jfc.irls_carry_init(js, FC_START, iters)
    tg, tr = tfc.irls_carry_init(ts, FC_START, iters)
    assert tg.shape == jg.shape and tr.shape == jr.shape
    scale = float(np.abs(np.asarray(jg)).max())
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-4,
                               atol=1e-4 * scale)
    want = _yhat_j(js, jfc.solve_prefix_adjusted(js, FC_START, jg, jr),
                   FC_START)
    got = _yhat_t(ts, tfc.solve_prefix_adjusted(ts, FC_START, tg, tr),
                  FC_START)
    np.testing.assert_allclose(got, want, rtol=YHAT_RTOL)


def test_solve_prefix_adjusted_matches(states):
    """The same carried moments through both solves; zero moments give the
    plain prefix fit."""
    js, ts = states
    jg, jr = jfc.irls_carry_init(js, FC_START, 1)
    tg, tr = (torch.from_numpy(np.array(a)) for a in (jg, jr))
    for week in (FC_START, 12):
        want = _yhat_j(js, jfc.solve_prefix_adjusted(js, week, jg, jr), week)
        got = _yhat_t(ts, tfc.solve_prefix_adjusted(ts, week, tg, tr), week)
        np.testing.assert_allclose(got, want, rtol=YHAT_RTOL)
    d = ts.x.shape[-1]
    zero = tfc.solve_prefix_adjusted(ts, 12, torch.zeros(4, d, d),
                                     torch.zeros(4, d))
    np.testing.assert_allclose(_yhat_t(ts, zero, 12),
                               _yhat_t(ts, tfc.solve_prefix(ts, 12), 12),
                               rtol=YHAT_RTOL)


def test_irls_carry_extend_matches(states):
    js, ts = states
    jg, jr = jfc.irls_carry_init(js, FC_START, 1)
    jbeta = jfc.solve_prefix_adjusted(js, FC_START, jg, jr)
    tg, tr = (torch.from_numpy(np.array(a)) for a in (jg, jr))
    tbeta = torch.from_numpy(np.array(jbeta))
    for week in (FC_START, FC_START + 1):
        jg, jr = jfc.irls_carry_extend(js, jbeta, jg, jr, week)
        tg, tr = tfc.irls_carry_extend(ts, tbeta, tg, tr, week)
        scale = float(np.abs(np.asarray(jg)).max())
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-4,
                                   atol=1e-4 * scale)
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-4,
                                   atol=1e-4 * float(np.abs(jr).max()))
    want = _yhat_j(js, jfc.solve_prefix_adjusted(js, FC_START + 2, jg, jr),
                   FC_START + 2)
    got = _yhat_t(ts, tfc.solve_prefix_adjusted(ts, FC_START + 2, tg, tr),
                  FC_START + 2)
    np.testing.assert_allclose(got, want, rtol=YHAT_RTOL)


def test_irls_carry_moments_are_per_row_block(states):
    """With a row block the moments of a row do not depend on the rows
    beside it: two stacked copies give each copy's bits."""
    _, ts = states
    two = dataclasses.replace(
        ts, rhs_prefix=ts.rhs_prefix.repeat(2, 1, 1),
        logy=ts.logy.repeat(2, 1), row_block=4)
    one = dataclasses.replace(ts, row_block=4)
    g1, r1 = tfc.irls_carry_init(one, FC_START, 2)
    g2, r2 = tfc.irls_carry_init(two, FC_START, 2)
    assert torch.equal(g2[4:], g1) and torch.equal(r2[:4], r1)


# The carried plan's properties (the reference's TestIrlsCarry, on its
# golden fleet: 3 pools x 20 weeks, cadence 2, start 6, horizon 4).
CARRY_KW = dict(cadence_weeks=2, start_weeks=6, horizon_weeks=4,
                compare=False)


@pytest.fixture(scope="module")
def carry_fleet():
    jpools = jtr.synthetic_pool_set(num_pools=3, num_hours=20 * WK)
    return jpools, convert.pool_set_from_reference(jpools)


@pytest.mark.parametrize("iters", [1, 2])
def test_carry_tracks_exact_refit(carry_fleet, iters):
    jp, tp = carry_fleet
    base = trp.replan_fleet_pools(tp, device="cpu", **CARRY_KW)
    exact = trp.replan_fleet_pools(tp, irls_iters=iters, device="cpu",
                                   **CARRY_KW)
    carry = trp.replan_fleet_pools(tp, irls_iters=iters, irls_carry=True,
                                   device="cpu", **CARRY_KW)
    rel = abs(carry.total_cost - exact.total_cost) / exact.total_cost
    assert rel < 2e-3
    assert rel < abs(base.total_cost - exact.total_cost) / exact.total_cost
    want = jrp.replan_fleet_pools(jp, irls_iters=iters, irls_carry=True,
                                  **CARRY_KW)
    assert carry.total_cost == pytest.approx(want.total_cost, rel=1e-4)
    np.testing.assert_allclose(carry.active, np.asarray(want.active),
                               rtol=1e-3, atol=1e-2)


def test_carry_at_zero_iters_is_base(carry_fleet):
    _, tp = carry_fleet
    base = trp.replan_fleet_pools(tp, device="cpu", **CARRY_KW)
    carry = trp.replan_fleet_pools(tp, irls_carry=True, device="cpu",
                                   **CARRY_KW)
    assert base.total_cost == carry.total_cost
    np.testing.assert_array_equal(base.targets, carry.targets)


def test_carry_with_breach_and_scenarios(fleets):
    """Carry, breach and a scenario batch together: scenario 0 is the
    unbatched replay bit for bit, and the batch runs through the request
    API chunked and unchunked to the same bits."""
    _, tp = fleets["unpredictable"]
    kw = dict(BREACH, irls_iters=1, irls_carry=True)
    solo = trp.replan_fleet_pools(tp, device="cpu", **kw)
    rolling = tapi.RollingConfig(**{k: v for k, v in kw.items()
                                    if k != "horizon_weeks"})
    reps = [tapi.plan(tapi.PlanRequest(
        pools=tp, mode="rolling", horizon_weeks=4, rolling=rolling,
        scenarios=tsc.ScenarioConfig(n_scenarios=3, family="growth",
                                     chunk=chunk)), device="cpu")
        for chunk in (None, 2)]
    for name in ("decision_mask", "targets", "active", "breach_band_lo"):
        np.testing.assert_array_equal(getattr(reps[0], name)[:, 0],
                                      getattr(solo, name), err_msg=name)
        np.testing.assert_array_equal(getattr(reps[1], name),
                                      getattr(reps[0], name), err_msg=name)
    assert float(reps[0].scenario_cost[0]) == solo.total_cost


# Telemetry on leaves the plan as it was: every per-week array and bill of
# the telemetry replay equals the plain replay's bits.
PER_WEEK = ("targets", "increments", "active", "committed_cost",
            "on_demand_cost", "utilization", "decision_mask")


@pytest.mark.parametrize("solver", ["quantile", "grid"])
def test_telemetry_leaves_the_plan_unchanged(fleets, solver):
    _, tp = fleets["unpredictable"]
    kw = dict(WEEKLY, solver=solver, num_grid=NUM_GRID, compare=True,
              spot=True)
    off = trp.replan_fleet_pools(tp, device="cpu", **kw)
    on = trp.replan_fleet_pools(
        tp, device="cpu",
        telemetry=TelemetryConfig(calibration=True, provenance=True), **kw)
    for name in PER_WEEK + ("spot_floor", "spot_cost",
                            "one_shot_weekly_cost", "hindsight_weekly_cost"):
        np.testing.assert_array_equal(getattr(on, name), getattr(off, name),
                                      err_msg=name)
    for name in ("total_cost", "one_shot_cost", "hindsight_cost"):
        assert getattr(on, name) == getattr(off, name)
    for name in ("telemetry", "ledger", "committed_by_sku", "used_hours",
                 "od_volume", "kernel_stats", "calibration", "decision_log",
                 "fractile_levels", "breach_band_lo"):
        assert getattr(off, name) is None, name
    assert on.ledger is not None and on.calibration is not None
    assert (on.kernel_stats is not None) == (solver == "grid")
