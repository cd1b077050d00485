"""The spot replay (``capacity.simulator.replay_spot_plan``): the PyTorch
port (on the CPU, so the revocation walk runs its plain version) against
the JAX package.

* The floors' broadcast to hours and the billing of sampled paths, on the
  JAX package's own paths and plan: every field of ``SpotReplayReport`` within rel 1e-5 (float32 sums over
  draws, pools and hours in another order).
* The reference's acceptance properties on the port's own draws and plan
  (``tests/test_spot.py::TestSpotReplayAcceptance``, 4 pools x 156 weeks):
  spot cuts the rolling bill by more than 2%, every pool's mean
  availability meets the 0.95 target, and the realized bill is within 10%
  of the planned one.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.capacity import preemption as jpe  # noqa: E402
from repro.capacity import simulator as jsim  # noqa: E402
from repro.core import planner as jpl  # noqa: E402
from repro.data import traces as jtr  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.capacity import preemption as tpe  # noqa: E402
from repro_torch.capacity import simulator as tsim  # noqa: E402
from repro_torch.core import replan as trp  # noqa: E402
from repro_torch.core import spot as tsp  # noqa: E402

WK = 168
BILL_RTOL = 1e-5
KW = dict(cadence_weeks=2, start_weeks=8, horizon_weeks=4, compare=False)


@pytest.fixture(scope="module", autouse=True)
def _full_f32_matmuls():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_float32_matmul_precision(prev)


@pytest.fixture(scope="module")
def plans():
    jpools = jtr.synthetic_pool_set(num_pools=3, num_hours=30 * WK)
    tpools = convert.pool_set_from_reference(jpools)
    jrep = jpl.plan_fleet_pools(jpools, mode="rolling", spot=True, **KW)
    trep = trp.replan_fleet_pools(tpools, spot=True, device="cpu", **KW)
    return jpools, tpools, jrep, trep


def _assert_report_close(got, want):
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, (bool, np.bool_, int)):
            assert a == b, f.name
        else:
            np.testing.assert_allclose(np.asarray(a, np.float64),
                                       np.asarray(b, np.float64),
                                       rtol=BILL_RTOL, err_msg=f.name)


@pytest.mark.parametrize("draws,seed", [(4, 0), (8, 1)])
def test_billing_of_reference_paths_equals_reference(plans, draws, seed):
    """The port's replay helpers on the reference's own plan and paths:
    the report's floors broadcast to the replayed hours, then the bill."""
    jpools, _, jrep, _ = plans
    want = jsim.replay_spot_plan(jpools, jrep, num_draws=draws, seed=seed)
    s = jrep.spot_floor.shape[0]
    paths = jpe.simulate_revocations(jrep.spot_lines.params, s * WK,
                                     num_draws=draws,
                                     key=jax.random.PRNGKey(seed))
    tpaths = tpe.RevocationPaths(*(
        torch.tensor(np.asarray(getattr(paths, f)))
        for f in ("available", "interrupted", "price")))
    demand, spot_dem = tsim._spot_demand(
        np.asarray(jpools.demand), np.asarray(jrep.spot_floor),
        jrep.start_weeks, torch.device("cpu"))
    assert spot_dem.shape == (jpools.num_pools, s * WK)
    lines = convert.spot_lines_from_reference(jrep.spot_lines)
    base = float(jrep.committed_cost.sum() + jrep.on_demand_cost.sum())
    got = tsim._bill_paths(
        tpaths, demand, spot_dem, lines.market_rate,
        jrep.spot_config.requeue_hours,
        jrep.spot_config.availability_target, base, jrep.total_cost)
    _assert_report_close(got, want)


def test_replay_of_the_port_report(plans):
    """The port's own replay: the same seed gives the same report, the
    fields have the reference's shapes, and the realized bill sits near
    the planned one."""
    _, tpools, _, trep = plans
    a = tsim.replay_spot_plan(tpools, trep, num_draws=8, seed=3)
    b = tsim.replay_spot_plan(tpools, trep, num_draws=8, seed=3)
    for f in dataclasses.fields(a):
        np.testing.assert_array_equal(getattr(a, f.name),
                                      getattr(b, f.name))
    assert a.availability.shape == (8, tpools.num_pools)
    assert a.planned_cost == trep.total_cost
    assert a.realized_cost == pytest.approx(a.planned_cost, rel=0.1)
    assert a.realized_spot_cost > 0 and a.requeue_cost > 0


def test_replay_refuses_what_it_cannot_replay(plans):
    _, tpools, _, trep = plans
    with pytest.raises(ValueError, match="scenario"):
        tsim.replay_spot_plan(tpools, trep, scenario=1)
    base = trp.replan_fleet_pools(tpools, device="cpu", **KW)
    with pytest.raises(ValueError, match="spot"):
        tsim.replay_spot_plan(tpools, base)


@pytest.fixture(scope="module")
def acceptance():
    pools = convert.pool_set_from_reference(
        jtr.synthetic_pool_set(num_pools=4, num_hours=WK * 156))
    kw = dict(cadence_weeks=4, start_weeks=26, horizon_weeks=8,
              compare=False, device="cpu")
    cfg = tsp.SpotConfig(availability_target=0.95)
    base = trp.replan_fleet_pools(pools, **kw)
    rep = trp.replan_fleet_pools(pools, spot=cfg, **kw)
    replay = tsim.replay_spot_plan(pools, rep, num_draws=32, seed=0)
    return base, rep, replay


def test_acceptance_spot_cuts_cost(acceptance):
    base, rep, _ = acceptance
    assert 1.0 - rep.total_cost / base.total_cost > 0.02


def test_acceptance_availability_meets_target(acceptance):
    _, rep, replay = acceptance
    target = rep.spot_config.availability_target
    assert replay.num_draws == 32 and replay.meets_target
    assert (replay.mean_availability >= target).all()
    assert replay.fleet_availability >= target


def test_acceptance_realized_tracks_planned(acceptance):
    _, _, replay = acceptance
    assert replay.realized_cost == pytest.approx(replay.planned_cost,
                                                 rel=0.10)
    assert replay.realized_spot_cost > 0
    assert replay.fallback_on_demand_cost > 0
