"""The policy tournament (``core.tournament``): the PyTorch port (on the
CPU) against the JAX package, on the reference's own demand paths.

The port's paths draw their driver noise from ``torch.Generator`` and the
reference's from ``jax.random``, so parity runs the port's rig
(``tournament._run_on_paths``) on the reference's ``scenario_paths``; the
randomized hedge is fed the reference's ``jax.random`` thresholds.

* Cost, hindsight, competitive ratio and regret per (policy, family,
  seed): the forecasting policies within rel 1e-3 (the refits' float32
  sums, as in the replay's parity), the forecast-free ones (hindsight and
  both hedges) within rel 1e-5; regret within those shares of the cost.
  Where a tie moved a decision: a hedge tests a band's coverage as
  ``levels + dg <= stack_top + 1e-6`` in float32, and the two sides are
  equal to within an ulp every week (1e-6 is below a stack top's ulp), so
  the reference's compiled program, which rounds ``levels + dg`` its own
  way, can commit a band a week apart from its own op-by-op replay.  On
  these paths that happens once (randomized hedge, cyclic, seed 3: 0.34%
  of that path's bill); there the port equals the reference's op-by-op
  replay of the path within rel 1e-5, and no more than one path per
  policy may move.
* The scan backend against the loop backend: rel 1e-4.
* The reference's false property, ``tests/test_policy.py::
  TestPolicyProperties::test_hedge_cost_at_least_hindsight_property``
  (the deterministic hedge never beats the constant hindsight stack), is
  not copied: on its own setting at ``unpredictable`` seed 45 both
  packages put the hedge's ratio at 0.959.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.core  # noqa: E402,F401  (the reference package's import order)
from repro.capacity import pricing as jpr  # noqa: E402
from repro.core import policy as jpol  # noqa: E402
from repro.core import portfolio as jpf  # noqa: E402
from repro.core import tournament as jtn  # noqa: E402
from repro.data import scenarios as jsc  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.capacity import pricing as tpr  # noqa: E402
from repro_torch.core import forecast as tfc  # noqa: E402
from repro_torch.core import policy as tpol  # noqa: E402
from repro_torch.core import tournament as ttn  # noqa: E402

FAMILIES = ("steady", "cyclic", "declining", "unpredictable")
KW = dict(num_pools=3, num_weeks=30, num_seeds=4, start_weeks=12,
          cadence_weeks=2, horizon_weeks=4)
FORECASTING = ("rolling_portfolio", "one_shot")


@pytest.fixture(scope="module", autouse=True)
def _full_f32_matmuls():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_float32_matmul_precision(prev)


class _ReferenceDraws(tpol.RandomizedHedgePolicy):
    def _thresholds(self, num_pools):
        u = jax.random.uniform(jax.random.PRNGKey(self.seed),
                               (num_pools, self.grid_size))
        return torch.from_numpy(np.array(jpol._hedge_threshold(u)))


def _port_policies():
    return [tpol.get_policy(p) for p in sorted(jpol.POLICIES)
            if p != "randomized_hedge"] + [_ReferenceDraws()]


def _run(paths, backend):
    return ttn._run_on_paths(
        _port_policies(), FAMILIES, paths,
        start_weeks=KW["start_weeks"], cadence_weeks=KW["cadence_weeks"],
        horizon_weeks=KW["horizon_weeks"],
        options=convert.options_from_reference(jpf.options_from_pricing()),
        od=tpr.on_demand_premium(), cfg=tfc.ForecastConfig(),
        backend=backend, device=torch.device("cpu"))


@pytest.fixture(scope="module")
def reports():
    names = [p for p in sorted(jpol.POLICIES) if p != "randomized_hedge"]
    want = jtn.run_tournament(names + ["randomized_hedge"], FAMILIES, **KW)
    paths = np.stack([
        jsc.scenario_paths(f, num_pools=KW["num_pools"],
                           num_weeks=KW["num_weeks"],
                           num_seeds=KW["num_seeds"])
        for f in FAMILIES])
    return want, _run(paths, "scan"), _run(paths, "loop")


def _rtol(policy):
    return 1e-3 if policy in FORECASTING else 1e-5


def test_hindsight_matches_reference(reports):
    want, got, _ = reports
    np.testing.assert_allclose(got.hindsight_cost, want.hindsight_cost,
                               rtol=1e-5)


def _op_by_op_cost(policy, family, seed):
    """The reference's replay of one path outside its compiled tournament
    program (its own property tests' spelling)."""
    demand = jsc.scenario_paths(family, num_pools=KW["num_pools"],
                                num_weeks=KW["num_weeks"],
                                num_seeds=KW["num_seeds"])[seed]
    ctx = jpol.make_context(
        demand, jpf.options_from_pricing(),
        clouds=tuple(c for c, _, _ in jsc.scenario_keys(KW["num_pools"])),
        od_rate=jpr.on_demand_premium(), start_weeks=KW["start_weeks"],
        cadence_weeks=KW["cadence_weeks"], horizon_weeks=KW["horizon_weeks"])
    return float(jtn._lean_replay(jpol.get_policy(policy), ctx, "loop"))


@pytest.mark.parametrize("policy", sorted(jpol.POLICIES))
def test_policy_costs_match_reference(reports, policy):
    want, got, _ = reports
    assert got.policies == want.policies
    i = want.policies.index(policy)
    rtol = _rtol(policy)
    close = np.isclose(got.cost[i], want.cost[i], rtol=rtol, atol=0.0)
    moved = np.argwhere(~close)
    assert len(moved) <= (0 if policy in FORECASTING else 1), moved
    for f, n in moved:
        assert got.cost[i, f, n] == pytest.approx(
            _op_by_op_cost(policy, FAMILIES[f], n), rel=rtol)
    np.testing.assert_allclose(got.competitive_ratio[i][close],
                               want.competitive_ratio[i][close], rtol=rtol)
    assert (np.abs(got.regret[i] - want.regret[i])[close]
            <= rtol * want.cost[i][close]).all()


def test_scan_matches_loop(reports):
    _, scan, loop = reports
    np.testing.assert_allclose(scan.cost, loop.cost, rtol=1e-4)
    np.testing.assert_array_equal(scan.hindsight_cost, loop.hindsight_cost)


def test_report_helpers_match_reference(reports):
    want, got, _ = reports
    same = ttn.TournamentReport(**{
        f: getattr(want, f) for f in (
            "policies", "families", "num_seeds", "start_weeks",
            "cadence_weeks", "horizon_weeks", "cost", "hindsight_cost",
            "competitive_ratio", "regret")})
    assert same.summary() == want.summary()
    assert same.to_markdown() == want.to_markdown()
    assert got.cost.shape == (len(jpol.POLICIES), len(FAMILIES),
                              KW["num_seeds"])
    assert set(got.summary()) == set(want.policies)


def test_hindsight_policy_scores_one(reports):
    """A true bound on these paths: the hindsight policy holds the optimal
    constant stack every week, so it bills its own reference exactly."""
    _, got, _ = reports
    i = got.policies.index("hindsight")
    np.testing.assert_allclose(got.competitive_ratio[i], 1.0, rtol=1e-5)


def test_hedge_can_beat_the_constant_hindsight():
    """The reference's property test's own setting (2 pools, 12 weeks,
    start 6, cadence 1, horizon 2, grid 8) on its unpredictable path at
    seed 45: the deterministic hedge's stack varies over time and beats
    the best constant stack after a regime shift, ratio 0.959 in both
    packages."""
    demand = jsc.scenario_path("unpredictable", num_pools=2, num_weeks=12,
                               seed=45)
    clouds = tuple(c for c, _, _ in jsc.scenario_keys(2))
    jctx = jpol.make_context(demand, jpf.options_from_pricing(),
                             clouds=clouds, od_rate=jpr.on_demand_premium(),
                             start_weeks=6, cadence_weeks=1, horizon_weeks=2)
    want = float(jtn._lean_replay(jpol.DeterministicHedgePolicy(grid_size=8),
                                  jctx, "scan")) / float(jtn._hindsight_cost(
        jctx.demand, options=jctx.options, clouds=jctx.clouds, od=jctx.od,
        start_weeks=6))
    options = convert.options_from_reference(jpf.options_from_pricing())
    tctx = tpol.make_context(torch.from_numpy(demand), options,
                             clouds=clouds, od_rate=tpr.on_demand_premium(),
                             start_weeks=6, cadence_weeks=1, horizon_weeks=2)
    got = float(ttn._lean_replay(tpol.DeterministicHedgePolicy(grid_size=8),
                                 tctx, "scan", 1)[0]) / float(
        ttn._hindsight_cost(tctx.demand, options=options, clouds=clouds,
                            od=tpr.on_demand_premium(), start_weeks=6,
                            num_paths=1)[0])
    assert got == pytest.approx(want, rel=1e-5)
    assert got == pytest.approx(0.959, abs=1e-3) and got < 1.0


def test_run_tournament_on_the_port_paths():
    """The whole entry point on the port's own paths (3 families x 3
    seeds): shapes, finite ratios, hindsight scoring 1, and the card-free
    call refusing spans= (telemetry, not ported)."""
    rep = ttn.run_tournament(
        list(tpol.POLICIES), ("steady", "burst", "declining"),
        num_pools=3, num_weeks=30, num_seeds=3, start_weeks=12,
        horizon_weeks=4, device="cpu")
    assert rep.policies == tuple(tpol.POLICIES)
    assert rep.cost.shape == (5, 3, 3)
    assert np.isfinite(rep.competitive_ratio).all()
    assert (rep.hindsight_cost > 0).all()
    i = rep.policies.index("hindsight")
    np.testing.assert_allclose(rep.competitive_ratio[i], 1.0, rtol=1e-5)
    np.testing.assert_allclose(rep.regret, rep.cost - rep.hindsight_cost,
                               rtol=1e-12)
    assert "| policy |" in rep.to_markdown()
    with pytest.raises(NotImplementedError, match="item 14"):
        ttn.run_tournament(spans=object(), device="cpu")
    with pytest.raises(ValueError, match="backend"):
        ttn.run_tournament(backend="vmap", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            ttn.run_tournament(num_seeds=1)
