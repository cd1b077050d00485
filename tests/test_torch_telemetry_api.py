"""Telemetry, the breach cadence and the carried IRLS moments through the
request API, ``repro_torch.core.api.plan`` in rolling mode, against the
JAX package's ``repro.core.api.plan`` on the same request: alone, over a
scenario batch, and over the same batch chunked.

Fleet: 2 pools x 16 weeks of the JAX package's synthetic demand (its
tests/test_obs.py breach-batch fleet), start 8, horizon 4, cadence 1,
the quantile solver, 3 regime futures.  Bills within rel 1e-4 of each
scenario's (test_torch_replan.py's quantile tolerance); breach masks and
bands, fractile levels and calibration hits bit for bit (they come from
realized demand alone); ledger totals within rel 1e-4.  A chunked batch
equals the unchunked one bit for bit within the port.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import api as japi  # noqa: E402
from repro.data import scenarios as jsc  # noqa: E402
from repro.data import traces as jtr  # noqa: E402
from repro import obs as jobs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import obs as tobs  # noqa: E402
from repro_torch.core import api as tapi  # noqa: E402
from repro_torch.data import scenarios as tsc  # noqa: E402

WK = 168
ROLLING = dict(cadence_weeks=1, start_weeks=8, compare=False)
OPTIONS = {
    "telemetry": (dict(telemetry="both"), {}),
    "breach": ({}, dict(cadence="breach")),
    "irls_carry": ({}, dict(irls_iters=1, irls_carry=True)),
}
BATCHES = ("none", "scenarios", "chunked")


@pytest.fixture(scope="module", autouse=True)
def _full_f32_matmuls():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_float32_matmul_precision(prev)


@pytest.fixture(scope="module")
def fleet():
    jpools = jtr.synthetic_pool_set(num_pools=2, num_hours=WK * 16)
    return jpools, convert.pool_set_from_reference(jpools)


def _request(api, obs, sc, pools, option, batch):
    req_kw, rolling_kw = OPTIONS[option]
    kw = {}
    if req_kw.get("telemetry") == "both":
        kw["telemetry"] = obs.TelemetryConfig(calibration=True,
                                              provenance=True)
    if batch != "none":
        kw["scenarios"] = sc.ScenarioConfig(
            n_scenarios=3, family="regime",
            chunk=2 if batch == "chunked" else None)
    return api.PlanRequest(
        pools=pools, mode="rolling", horizon_weeks=4,
        rolling=api.RollingConfig(**ROLLING, **rolling_kw), **kw)


@pytest.fixture(scope="module")
def reports(fleet):
    """(option, batch) -> (JAX report, port report); the JAX package runs
    each option once alone and once over the unchunked batch."""
    jpools, tpools = fleet
    out, jax_reports = {}, {}
    for option in OPTIONS:
        for batch in BATCHES:
            jbatch = "none" if batch == "none" else "scenarios"
            if (option, jbatch) not in jax_reports:
                jax_reports[option, jbatch] = japi.plan(_request(
                    japi, jobs, jsc, jpools, option, jbatch))
            out[option, batch] = (
                jax_reports[option, jbatch],
                tapi.plan(_request(tapi, tobs, tsc, tpools, option, batch),
                          device="cpu"))
    return out


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_plan_matches_reference(reports, option, batch):
    jrep, trep = reports[option, batch]
    if batch == "none":
        assert trep.total_cost == pytest.approx(jrep.total_cost, rel=1e-4)
        assert trep.n_scenarios == 1
    else:
        assert trep.n_scenarios == 3
        np.testing.assert_allclose(trep.scenario_cost,
                                   np.asarray(jrep.scenario_cost), rtol=1e-4)
    np.testing.assert_allclose(trep.weekly_cost, np.asarray(jrep.weekly_cost),
                               rtol=1e-3)
    np.testing.assert_array_equal(trep.decision_mask,
                                  np.asarray(jrep.decision_mask))
    assert trep.cadence == jrep.cadence
    if option == "breach":
        for name in ("breach_band_lo", "breach_band_hi"):
            np.testing.assert_array_equal(getattr(trep, name),
                                          np.asarray(getattr(jrep, name)))
    if option == "telemetry":
        assert trep.ledger.total == pytest.approx(jrep.ledger.total,
                                                  rel=1e-4)
        assert trep.ledger.reconcile(trep)["ok"]
        np.testing.assert_array_equal(trep.fractile_levels,
                                      np.asarray(jrep.fractile_levels))
        np.testing.assert_array_equal(trep.calibration.hits,
                                      jrep.calibration.hits)
        assert trep.calibration.n_scenarios == jrep.calibration.n_scenarios
        assert (trep.decision_log.binding_counts()
                == jrep.decision_log.binding_counts())
    else:
        assert trep.ledger is None and trep.calibration is None


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_chunked_batch_equals_unchunked(reports, option):
    full, chunked = reports[option, "scenarios"][1], reports[option,
                                                             "chunked"][1]
    for name in ("targets", "active", "committed_cost", "on_demand_cost",
                 "decision_mask", "scenario_cost", "breach_band_lo",
                 "fractile_levels", "committed_by_sku"):
        a, b = getattr(chunked, name), getattr(full, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert chunked.total_cost == full.total_cost
