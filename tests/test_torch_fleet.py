"""The fleet simulator of the PyTorch port (``capacity/simulator.py``'s
fleet entry points, on the CPU) against the JAX package, and the
parameter counts ``default_fleet`` sizes its replicas by.

The serving fleets' request traces are ``jax.random`` draws in the
reference and ``torch.Generator`` draws in the port, so parity feeds the
reference's traces to the port's attribution helper
(``simulator._pools_from_requests``) and, for the entry points built on
it, stands that helper in for ``fleet_pool_demand``.  Tolerances:

* parameter counts, spec tables, ``default_fleet`` and the catalog: equal;
* attributed pools: bit for bit without migration (the same float32
  numpy operations); with migration the turnover pass within the bound
  of ``tests/test_torch_generations.py``, rel 1e-6 or 2^-22 of the row's
  base peak (the packages' ``exp`` differ);
* bills (``plan_fleet``, ``plan_fleet_portfolio`` with ``shiftable_frac``
  0 and 0.3, one-shot and rolling per-pool plans): rel 1e-3, the planner
  parity tolerance (the forecaster's float32 sums run in another order).
  The histories are 12-20 weeks, below the forecaster's yearly guard, so
  the reference's float32 conditioning with yearly terms (ROADMAP, "The
  one-shot fit") does not arise.
"""

import dataclasses
import warnings

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.capacity import simulator as jsim  # noqa: E402
from repro.core import demand as jdm  # noqa: E402
from repro.core import planner as jpl  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.capacity import simulator as tsim  # noqa: E402
from repro_torch.core import planner as tpl  # noqa: E402
from repro_torch.core import replan as trp  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402

WK = 168
WEEKS = 20
BILL_RTOL = 1e-3
SCAN_RTOL, ROW_ATOL = 1e-6, 2.0 ** -22   # the turnover parity bound
BUILT = ("internlm2-20b", "phi3-medium-14b", "rwkv6-3b", "stablelm-1.6b")


@pytest.fixture(scope="module", autouse=True)
def _full_f32_matmuls():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_float32_matmul_precision(prev)


def _specs_flat(tree, path=""):
    """{path: (shape, axes, init, fan_in, dtype name)} of a Spec tree."""
    if hasattr(tree, "shape") and hasattr(tree, "axes"):
        dtype = tree.dtype and (getattr(tree.dtype, "__name__", None)
                                or str(tree.dtype).split(".")[-1])
        return {path: (tuple(tree.shape), tuple(tree.axes), tree.init,
                       tree.fan_in, dtype)}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_specs_flat(v, f"{path}/{k}"))
    return out


@pytest.mark.parametrize("arch", sorted(jconfigs.ARCHS))
def test_num_params_and_spec_tables_equal_reference(arch):
    cfg = configs.get(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jconfigs.get(arch))
    ref = jmodel.build(jconfigs.get(arch))
    assert tmodel.num_params(cfg) == ref.num_params()
    assert _specs_flat(tmodel.param_specs(cfg)) == _specs_flat(
        ref.param_specs)
    if arch in BUILT:
        assert (tmodel.build(cfg, device="meta").num_params()
                == tmodel.num_params(cfg))


def test_default_fleet_and_catalog_equal_reference():
    assert tsim.default_pool_catalog() == jsim.default_pool_catalog()
    (tf, tj), (jf, jj) = tsim.default_fleet(), jsim.default_fleet()
    assert [dataclasses.asdict(f) for f in tf] == [
        dataclasses.asdict(f) for f in jf]
    assert [dataclasses.asdict(j) for j in tj] == [
        dataclasses.asdict(j) for j in jj]
    chips = {f.arch: f.chips_per_replica for f in tf}
    assert chips == {
        "deepseek-v2-lite-16b": 3, "granite-moe-1b-a400m": 1,
        "internlm2-20b": 4, "jamba-v0.1-52b": 9, "minicpm3-4b": 1,
        "phi3-medium-14b": 3, "qwen2-vl-7b": 2, "rwkv6-3b": 1,
        "stablelm-1.6b": 1, "whisper-small": 1}
    assert all(j.chips >= 64 for j in tj)


@pytest.fixture(scope="module")
def ref_fleet():
    """The reference's default fleet, its request traces (seed 0) and its
    pools over WEEKS weeks, with and without migration."""
    fleets, jobs = jsim.default_fleet()
    t = WEEKS * WK
    reqs = [np.asarray(jdm.synth_demand(t, fl.demand_cfg,
                                        key=jax.random.PRNGKey(i)))
            for i, fl in enumerate(fleets)]
    return dict(
        reqs=reqs, hours=t,
        pools=jsim.fleet_pool_demand(fleets, jobs, t, seed=0),
        migrated=jsim.fleet_pool_demand(fleets, jobs, t, seed=0,
                                        migration=True),
    )


@pytest.fixture(scope="module")
def port_pools(ref_fleet):
    fleets, jobs = tsim.default_fleet()
    return tsim._pools_from_requests(fleets, jobs, ref_fleet["reqs"],
                                     ref_fleet["hours"])


def test_attribution_bit_for_bit_on_reference_traces(ref_fleet, port_pools):
    want = ref_fleet["pools"]
    assert port_pools.keys == want.keys and len(want.keys) == 12
    np.testing.assert_array_equal(port_pools.demand, want.demand)
    fleets, jobs = tsim.default_fleet()
    mig = tsim._pools_from_requests(fleets, jobs, ref_fleet["reqs"],
                                    ref_fleet["hours"], migration=True,
                                    device="cpu")
    want = ref_fleet["migrated"]
    assert mig.keys == want.keys
    scale = ROW_ATOL * np.abs(port_pools.demand).max(-1, keepdims=True)
    bad = (np.abs(mig.demand - want.demand)
           > SCAN_RTOL * np.abs(want.demand) + scale)
    assert not bad.any(), int(bad.sum())


def test_fleet_pool_demand_on_own_draws():
    """``tests/test_pools.py::test_fleet_pool_demand_partitions_aggregate``
    on the port's draws, which are the helper's pools of the
    ``torch.Generator`` traces seeded ``seed + i``."""
    fleets, jobs = tsim.default_fleet()
    t = 4 * WK
    pools = tsim.fleet_pool_demand(fleets, jobs, t, seed=3)
    reqs = [tsim.dm.synth_demand(t, fl.demand_cfg, generator=torch.Generator(
        ).manual_seed(3 + i)).numpy() for i, fl in enumerate(fleets)]
    np.testing.assert_array_equal(
        pools.demand, tsim._pools_from_requests(fleets, jobs, reqs, t).demand)
    assert pools.num_pools == 12 and pools.num_hours == t
    np.testing.assert_allclose(
        pools.aggregate(), tsim.fleet_chip_demand(fleets, jobs, t, seed=3),
        rtol=1e-6)
    assert (pools.demand >= 0).all()
    assert not np.array_equal(
        pools.demand, tsim.fleet_pool_demand(fleets, jobs, t, seed=4).demand)
    job = jobs[0]
    assert pools.pool(job.pool)[job.start_hour + 1] >= job.chips
    # a lone fleet plus a training block (tests/test_capacity.py)
    d = tsim.fleet_chip_demand(
        [tsim.ServingFleet("stablelm-1.6b", 1, 5e4, 50.0)],
        [tsim.TrainingJob("stablelm-1.6b", chips=100, start_hour=48,
                          duration_hours=24)], WK)
    assert d[50] >= d[20] + 99


@pytest.fixture(scope="module")
def aggregate(ref_fleet, port_pools):
    jagg = ref_fleet["pools"].aggregate().astype(np.float64)
    agg = port_pools.aggregate().astype(np.float64)
    np.testing.assert_array_equal(agg, jagg)
    return agg


@pytest.mark.parametrize("frac", [0.0, 0.3])
def test_plan_fleet_matches_reference(aggregate, frac):
    want = jsim.plan_fleet(aggregate, shiftable_frac=frac)
    got = tsim.plan_fleet(aggregate, shiftable_frac=frac, device="cpu")
    assert got.commitment == pytest.approx(want.commitment, rel=BILL_RTOL)
    for f in dataclasses.fields(want):
        assert getattr(got, f.name) == pytest.approx(
            getattr(want, f.name), rel=BILL_RTOL, abs=1e-6), f.name
    assert got.total_cost < got.all_on_demand_cost


@pytest.mark.parametrize("frac", [0.0, 0.3])
def test_plan_fleet_portfolio_matches_reference(aggregate, frac):
    want = jsim.plan_fleet_portfolio(aggregate, shiftable_frac=frac)
    got = tsim.plan_fleet_portfolio(aggregate, shiftable_frac=frac,
                                    device="cpu")
    assert isinstance(got, tsim.PortfolioFleetPlan)
    assert [o.name for o in got.options] == [o.name for o in want.options]
    np.testing.assert_allclose(got.widths, want.widths, rtol=BILL_RTOL,
                               atol=1e-2)
    assert set(got.breakdown) == set(want.breakdown)
    for name, v in want.breakdown.items():
        assert got.breakdown[name] == pytest.approx(v, rel=BILL_RTOL), name
    for key in ("total_commitment", "committed_cost", "on_demand_cost",
                "total_cost", "all_on_demand_cost", "single_level_cost"):
        assert getattr(got, key) == pytest.approx(
            getattr(want, key), rel=BILL_RTOL), key
    for key in ("savings_vs_on_demand", "savings_vs_single_level"):
        assert getattr(got, key) == pytest.approx(
            getattr(want, key), abs=BILL_RTOL), key


@pytest.fixture
def on_reference_traces(monkeypatch, ref_fleet):
    """The port's ``fleet_pool_demand`` fed the reference's traces."""
    def pools(fleets, jobs, num_hours, *, seed=0, migration=None,
              device=None):
        assert num_hours == ref_fleet["hours"] and seed == 0
        return tsim._pools_from_requests(fleets, jobs, ref_fleet["reqs"],
                                         num_hours, migration=migration,
                                         device=device)
    monkeypatch.setattr(tsim, "fleet_pool_demand", pools)


def test_simulate_and_plan_pools_matches_reference(on_reference_traces,
                                                   ref_fleet):
    want = jpl.plan_fleet_pools(ref_fleet["pools"], horizon_weeks=8)
    pools, got = tsim.simulate_and_plan_pools(num_hours=ref_fleet["hours"],
                                              device="cpu")
    np.testing.assert_array_equal(pools.demand, ref_fleet["pools"].demand)
    assert isinstance(got, tpl.FleetPoolsPlan)
    for key in ("total_cost", "committed_cost", "on_demand_cost",
                "all_on_demand_cost", "aggregate_cost"):
        assert getattr(got, key) == pytest.approx(
            getattr(want, key), rel=BILL_RTOL), key
    assert got.total_cost < got.all_on_demand_cost


def test_simulate_and_replan_pools_matches_reference(on_reference_traces,
                                                     ref_fleet):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want = jpl.plan_fleet_pools(ref_fleet["pools"], horizon_weeks=8,
                                    mode="rolling", cadence_weeks=1)
    with pytest.warns(DeprecationWarning, match="cadence_weeks"):
        pools, got = tsim.simulate_and_replan_pools(
            num_hours=ref_fleet["hours"], device="cpu")
    assert isinstance(got, trp.RollingPlanReport)
    assert got.keys == tuple(want.keys)
    for key in ("total_cost", "one_shot_cost", "hindsight_cost"):
        assert getattr(got, key) == pytest.approx(
            getattr(want, key), rel=BILL_RTOL), key


def test_fleet_plans_on_own_draws():
    """The reference's properties (``tests/test_capacity.py``,
    ``tests/test_pools.py``, ``tests/test_portfolio.py``,
    ``tests/test_replan.py``) on the port's own draws."""
    fleets, jobs = tsim.default_fleet()
    demand = tsim.fleet_chip_demand(fleets, jobs, 12 * WK)
    single = tsim.plan_fleet(demand, horizon_weeks=4, device="cpu")
    assert single.commitment > 0
    assert 0.0 < single.savings_vs_on_demand < 0.6
    assert single.total_cost < single.all_on_demand_cost
    shifted = tsim.plan_fleet(demand, horizon_weeks=4, shiftable_frac=0.3,
                              device="cpu")
    assert shifted.on_demand_cost <= single.on_demand_cost
    port = tsim.plan_fleet_portfolio(demand, horizon_weeks=4, device="cpu")
    assert port.total_cost <= single.total_cost
    assert port.savings_vs_single_level >= 0.0 and port.breakdown
    assert port.total_cost < port.all_on_demand_cost

    pools, plan = tsim.simulate_and_plan_pools(
        num_hours=12 * WK, horizon_weeks=2, device="cpu")
    assert plan.widths.shape[0] == pools.num_pools == 12
    assert 0 < plan.total_cost < plan.all_on_demand_cost
    with pytest.warns(DeprecationWarning):
        pools, rep = tsim.simulate_and_replan_pools(
            num_hours=16 * WK, cadence_weeks=4, horizon_weeks=4,
            start_weeks=8, compare=False, device="cpu")
    assert isinstance(rep, trp.RollingPlanReport)
    assert len(rep.keys) == pools.num_pools and rep.total_cost > 0


def test_fleet_entry_points_default_to_the_card():
    fleets, jobs = tsim.default_fleet()
    demand = tsim.fleet_chip_demand(fleets, jobs, 12 * WK)
    if torch.cuda.is_available():
        return
    for call in (lambda: tsim.plan_fleet(demand, horizon_weeks=4),
                 lambda: tsim.plan_fleet_portfolio(demand, horizon_weeks=4),
                 lambda: tsim.simulate_and_plan_pools(num_hours=12 * WK,
                                                      horizon_weeks=2)):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
