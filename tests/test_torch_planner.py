"""The one-shot planner, end to end: the PyTorch port (on the CPU, so the
sweep runs its plain version) against the JAX package on one fleet.

Fleets are the JAX package's synthetic demand, carried across with
``convert.pool_set_from_reference``: the 12-pool x 16-week fleet with a
4-week holdout of tests/test_pools.py's ``TestFleetPoolPlanning``, and a
4-pool x 68-week one whose 64 weeks of history (>= 1.2 years) turn the
yearly Fourier terms on.

With the yearly terms on, the forecaster's normal equations have a
condition number near 1e7.  The reference solves them as they stand in
float32 and its forecasts land up to ~25% from a float64 solve of the
same equations; the port solves them in a whitened basis and lands within
~1e-4 (``forecast._whiten``).  So on that fleet the port's fit is held to
the float64 solve, and the rest of the plan to the reference's own
pipeline run on the port's forecasts.  Tolerances:

* forecasts within rtol 5e-4 of the reference's (short history) or of the
  float64 solve (yearly terms on);
* fractiles at rtol 1e-6 (the reference's batched-vs-solo bound);
* the same envelope structure, and widths and levels within rtol 0.03 /
  atol 0.05 (the reference's batched-vs-solo bound: the fits differ in
  float32 summation order, and an order statistic can step to a
  neighbouring forecast value);
* totals, aggregate cost and pooling premium within rel 1e-3, the rolling
  parity's bound;
* the batched spend equal to a loop of ``portfolio_spend`` at rel 1e-6.
"""

import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.capacity import generations as jgn  # noqa: E402
from repro.capacity import pricing as jpr  # noqa: E402
from repro.core import api as japi  # noqa: E402
from repro.core import commitment as jcm  # noqa: E402
from repro.core import demand as jdm  # noqa: E402
from repro.core import forecast as jfc  # noqa: E402
from repro.core import planner as jpl  # noqa: E402
from repro.core import portfolio as jpf  # noqa: E402
from repro.data import traces as jtr  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.capacity import generations as tgn  # noqa: E402
from repro_torch.core import api as tapi  # noqa: E402
from repro_torch.core import commitment as tcm  # noqa: E402
from repro_torch.core import forecast as tfc  # noqa: E402
from repro_torch.core import migration as tmg  # noqa: E402
from repro_torch.core import planner as tpl  # noqa: E402
from repro_torch.core import portfolio as tpf  # noqa: E402

WK = 168
HORIZON = 4
FRACTILE_RTOL = 1e-6
FORECAST_RTOL = 5e-4
STACK_TOL = dict(rtol=0.03, atol=0.05)
COST_REL = 1e-3
FLEETS = {"short": (12, 16), "yearly": (4, 68)}
COSTS = ("total_cost", "committed_cost", "on_demand_cost", "aggregate_cost",
         "pooling_premium", "all_on_demand_cost", "savings_vs_on_demand")


@pytest.fixture(scope="module", autouse=True)
def _full_f32_matmuls():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_float32_matmul_precision(prev)


def _float64_forecasts(hist, num_hours, cfg=jfc.ForecastConfig()):
    """(P, num_hours) forecasts of the reference's estimator solved in
    float64: its design matrix, its normal equations and IRLS passes."""
    if hist.shape[-1] < 1.2 * jfc.HOURS_PER_YEAR and cfg.yearly_order:
        cfg = dataclasses.replace(cfg, yearly_order=0)
    t_hist = hist.shape[-1]
    t_max = float(max(t_hist - 1, 1))
    x_all = np.asarray(jfc.design_matrix(
        jnp.arange(t_hist + num_hours, dtype=jnp.float32), cfg, t_max),
        np.float64)
    x, xf = x_all[:t_hist], x_all[t_hist:]
    logy = np.log(np.maximum(hist.astype(np.float64), 1e-6))
    eye = cfg.ridge * np.eye(x.shape[1])

    def solve(w):
        g = np.einsum("pt,td,te->pde", w, x, x) + eye
        return np.linalg.solve(g, ((w * logy) @ x)[..., None])[..., 0]

    beta = solve(np.ones_like(logy))
    for _ in range(cfg.irls_iters):
        beta = solve(np.where(logy - beta @ x.T > 0, cfg.asym_weight, 1.0))
    return np.exp(beta @ xf.T)


def _plan_both(name, spot=None):
    """(name, JAX fleet, port fleet, reference plan, port plan).  On the
    yearly fleet the reference plan runs on the port's forecasts."""
    num_pools, weeks = FLEETS[name]
    jpools = jtr.synthetic_pool_set(num_pools=num_pools,
                                    num_hours=weeks * WK)
    tpools = convert.pool_set_from_reference(jpools)
    tres = tapi.plan(tapi.PlanRequest(pools=tpools, horizon_weeks=HORIZON,
                                      spot=spot), device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        if name == "yearly":
            hist = torch.from_numpy(tpools.demand[:, :-HORIZON * WK])
            agg = tfc.fit(hist.sum(0))
            agg_yhat = tfc.forecast_horizon(agg, hist.shape[-1],
                                            HORIZON * WK).numpy()
            mp.setattr(jfc, "predict_batched",
                       lambda model, t: jnp.asarray(tres.forecasts))
            mp.setattr(jfc, "forecast_horizon",
                       lambda model, t0, n: jnp.asarray(agg_yhat))
        jres = japi.plan(japi.PlanRequest(pools=jpools,
                                          horizon_weeks=HORIZON, spot=spot))
    return name, jpools, tpools, jres, tres


@pytest.fixture(scope="module", params=sorted(FLEETS))
def plans(request):
    return _plan_both(request.param)


def test_returns_a_fleet_plan_of_the_reference_layout(plans):
    _, _, _, jres, tres = plans
    assert isinstance(tres, tpl.FleetPoolsPlan)
    names = lambda cls: [f.name for f in dataclasses.fields(cls)]  # noqa: E731
    assert names(tpl.FleetPoolsPlan) == names(jpl.FleetPoolsPlan)
    assert names(tpl.PoolPlanEntry) == names(jpl.PoolPlanEntry)
    assert names(tpf.PortfolioSpend) == names(jpf.PortfolioSpend)
    assert tres.keys == jres.keys
    assert [o.name for o in tres.options] == [o.name for o in jres.options]
    np.testing.assert_array_equal(tres.available, jres.available)
    for field in ("spot_lines", "spot_floor", "migration_edges",
                  "conv_options", "conv_widths", "conv_alloc"):
        assert getattr(tres, field) is None
    assert tres.spot_cost == 0.0 and tres.conv_cost == 0.0


def test_yearly_terms_follow_the_history_length(plans):
    name, _, tpools, _, _ = plans
    hist = torch.from_numpy(tpools.demand[:, :-HORIZON * WK])
    model = tfc.fit_batched(hist)
    assert model.cfg.yearly_order == (8 if name == "yearly" else 0)
    assert model.beta.shape == (tpools.num_pools,
                                31 + 2 * model.cfg.yearly_order)


def test_fractiles(plans):
    _, _, _, jres, tres = plans
    np.testing.assert_allclose(tres.fractiles, jres.fractiles,
                               rtol=FRACTILE_RTOL)


def test_forecasts(plans):
    name, jpools, _, jres, tres = plans
    hist = np.asarray(jpools.demand[:, :-HORIZON * WK])
    exact = _float64_forecasts(hist, HORIZON * WK)
    np.testing.assert_allclose(tres.forecasts, exact, rtol=FORECAST_RTOL)
    if name == "short":
        np.testing.assert_allclose(tres.forecasts, jres.forecasts,
                                   rtol=FORECAST_RTOL)
    else:
        # the documented difference: the reference's float32 solve is the
        # one that strays from the float64 fit
        ref = np.asarray(jfc.predict_batched(
            jfc.fit_batched(jnp.asarray(hist)),
            jnp.arange(hist.shape[-1], hist.shape[-1] + HORIZON * WK)))
        ref_err = np.abs(ref / exact - 1.0).max()
        assert ref_err > 10 * np.abs(tres.forecasts / exact - 1.0).max()


def test_envelope_widths_and_levels(plans):
    _, _, _, jres, tres = plans
    np.testing.assert_array_equal(tres.widths > 0, jres.widths > 0)
    np.testing.assert_allclose(tres.widths, jres.widths, **STACK_TOL)
    np.testing.assert_allclose(tres.levels, jres.levels, **STACK_TOL)
    np.testing.assert_allclose(tres.per_horizon_levels,
                               jres.per_horizon_levels, **STACK_TOL)


@pytest.mark.parametrize("field", COSTS)
def test_costs(plans, field):
    _, _, _, jres, tres = plans
    assert getattr(tres, field) == pytest.approx(getattr(jres, field),
                                                 rel=COST_REL)


def test_per_pool_spend(plans):
    _, _, _, jres, tres = plans
    for jp, tp in zip(jres.per_pool, tres.per_pool):
        assert tp.key == jp.key
        assert tp.spend.total == pytest.approx(jp.spend.total, rel=COST_REL)
        np.testing.assert_allclose(tp.spend.committed, jp.spend.committed,
                                   rtol=STACK_TOL["rtol"], atol=1.0)


def test_acceptance_properties(plans):
    """tests/test_pools.py's acceptance, run on the port's plan."""
    _, _, tpools, _, res = plans
    p, k = tpools.num_pools, len(res.options)
    assert res.widths.shape == (p, k)
    assert len(res.ladders.ladders) == p
    assert res.ladders.keys == tpools.keys
    assert res.total_cost > 0
    assert res.total_cost == pytest.approx(
        res.committed_cost + res.on_demand_cost)
    assert 0.0 < res.savings_vs_on_demand < 0.6
    term_hours = {i: o.term_weeks * WK for i, o in enumerate(res.options)}
    any_tranche = False
    for lad in res.ladders.ladders:
        for opt_idx, term in zip(lad.option, lad.term):
            any_tranche = True
            assert term == term_hours[int(opt_idx)]
    assert any_tranche
    # cloud availability
    assert (res.widths[~res.available] == 0.0).all()
    for i, key in enumerate(res.keys):
        for j, opt in enumerate(res.options):
            if res.widths[i, j] > 0:
                assert opt.cloud == key[0]
    # the commitment filter sums widths
    total = sum(res.commitment(cloud=c) for c in ("aws", "azure", "gcp"))
    assert total == pytest.approx(float(res.widths.sum()), rel=1e-6)
    gcp_3y = res.commitment(cloud="gcp", term_weeks=156)
    assert 0.0 <= gcp_3y <= res.commitment(cloud="gcp")
    # the pooling premium
    assert np.isfinite(res.pooling_premium)
    assert res.pooling_premium > 0.0
    assert res.aggregate_cost < res.total_cost


def test_batched_spend_equals_per_pool_loop(plans):
    _, _, tpools, _, res = plans
    actual = torch.from_numpy(tpools.demand[:, -HORIZON * WK:])
    od = tpf.pricing.on_demand_premium()
    for i, entry in enumerate(res.per_pool):
        solo = tpf.portfolio_spend(actual[i], res.widths[i], res.options,
                                   od_rate=od)
        np.testing.assert_array_equal(solo.committed, entry.spend.committed)
        for field in ("on_demand", "total", "all_on_demand",
                      "savings_vs_on_demand"):
            assert getattr(solo, field) == pytest.approx(
                getattr(entry.spend, field), rel=1e-6, abs=1e-9), field


def test_matches_per_pool_plan_portfolio_loop(plans):
    """The batched fleet pass reproduces single-pool ``plan_portfolio``
    runs fed the same masked per-pool cost lines."""
    _, _, tpools, _, res = plans
    od = tpf.pricing.on_demand_premium()
    al_p, be_p, _ = tpf.pool_option_lines(res.options, tpools.clouds,
                                          od_rate=od)
    hist = torch.from_numpy(tpools.demand[:, :-HORIZON * WK])
    for p in range(0, tpools.num_pools, 3):
        solo = tpl.plan_portfolio(hist[p], res.options,
                                  num_horizons=HORIZON, od_rate=od,
                                  lines=(al_p[p], be_p[p]))
        np.testing.assert_allclose(res.fractiles[p], solo.fractiles.numpy(),
                                   rtol=FRACTILE_RTOL)
        np.testing.assert_array_equal(res.widths[p] > 0,
                                      solo.widths.numpy() > 0)
        np.testing.assert_allclose(res.widths[p], solo.widths.numpy(),
                                   **STACK_TOL)
        np.testing.assert_allclose(res.levels[p], solo.levels.numpy(),
                                   **STACK_TOL)


def test_too_short_history_raises():
    tpools = convert.pool_set_from_reference(
        jtr.synthetic_pool_set(num_pools=2, num_hours=HORIZON * WK))
    with pytest.raises(ValueError, match="holdout"):
        tapi.plan(tapi.PlanRequest(pools=tpools, horizon_weeks=HORIZON),
                  device="cpu")


def test_empty_holdout_gives_a_neutral_premium():
    """Every pool retired over the holdout, and no option under the
    on-demand rate: nothing is bought or billed, and the premium is 0."""
    jpools = jtr.synthetic_pool_set(num_pools=3, num_hours=10 * WK)
    demand = np.array(jpools.demand)
    demand[:, -HORIZON * WK:] = 0.0
    jpools = jdm.PoolSet(keys=jpools.keys, demand=demand)
    tpools = convert.pool_set_from_reference(jpools)
    kw = dict(horizon_weeks=HORIZON, od_rate=0.5)
    jres = japi.plan(japi.PlanRequest(pools=jpools, **kw))
    tres = tapi.plan(tapi.PlanRequest(pools=tpools, **kw), device="cpu")
    for res in (jres, tres):
        assert res.aggregate_cost == 0.0
        assert res.pooling_premium == 0.0
        assert res.savings_vs_on_demand == 0.0
    assert (tres.widths == 0.0).all()


def test_no_card_no_device_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    tpools = convert.pool_set_from_reference(
        jtr.synthetic_pool_set(num_pools=2, num_hours=6 * WK))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tapi.plan(tapi.PlanRequest(pools=tpools, horizon_weeks=2))


def test_legacy_shim(plans):
    _, _, tpools, _, tres = plans
    res = tpl.plan_fleet_pools(tpools, horizon_weeks=HORIZON, device="cpu")
    assert res.total_cost == tres.total_cost
    np.testing.assert_array_equal(res.widths, tres.widths)
    with pytest.raises(TypeError, match="one_shot"):
        tpl.plan_fleet_pools(tpools, cadence_weeks=2, device="cpu")
    with pytest.warns(DeprecationWarning, match="RollingConfig"):
        rep = tpl.plan_fleet_pools(tpools, mode="rolling", horizon_weeks=2,
                                   cadence_weeks=2, compare=False,
                                   device="cpu")
    assert rep.total_cost > 0


@pytest.fixture(scope="module")
def history():
    return np.array(jdm.synth_demand(WK * 26, key=jax.random.PRNGKey(0)))


@pytest.mark.parametrize("solver", ["quantile", "golden"])
def test_plan_commitment(history, solver):
    jres = jpl.plan_commitment(jnp.asarray(history), num_horizons=8,
                               solver=solver)
    tres = tpl.plan_commitment(torch.from_numpy(history), num_horizons=8,
                               solver=solver)
    assert tres.per_horizon_levels.shape == (8,)
    assert tres.forecast.shape == (8 * WK,)
    np.testing.assert_allclose(tres.forecast.numpy(),
                               np.asarray(jres.forecast), rtol=1e-4)
    np.testing.assert_allclose(tres.per_horizon_levels.numpy(),
                               np.asarray(jres.per_horizon_levels),
                               rtol=COST_REL)
    assert tres.commitment == pytest.approx(jres.commitment, rel=COST_REL)
    assert tres.commitment == float(tres.per_horizon_levels.min())
    assert tres.argmin_horizon == jres.argmin_horizon


def test_plan_commitment_levels_are_prefix_quantiles(history):
    """K = 1: each horizon's level costs what the exact quantile of its
    forecast prefix costs."""
    res = tpl.plan_commitment(torch.from_numpy(history), num_horizons=6)
    for w in range(6):
        prefix = res.forecast[: (w + 1) * WK]
        c_q = tcm.optimal_commitment_quantile(prefix)
        assert float(tcm.commitment_cost(prefix, res.per_horizon_levels[w])) \
            == pytest.approx(float(tcm.commitment_cost(prefix, c_q)),
                             rel=1e-5)


def test_plan_commitment_rejects_unknown_solver(history):
    with pytest.raises(ValueError, match="solver"):
        tpl.plan_commitment(torch.from_numpy(history), solver="brent")


@pytest.mark.parametrize("tw", [0.0, 1.0])
def test_plan_portfolio(history, tw):
    jres = jpl.plan_portfolio(jnp.asarray(history), num_horizons=6,
                              term_weighting=tw)
    tres = tpl.plan_portfolio(torch.from_numpy(history), num_horizons=6,
                              term_weighting=tw)
    assert [o.name for o in tres.options] == [o.name for o in jres.options]
    np.testing.assert_allclose(tres.fractiles.numpy(),
                               np.asarray(jres.fractiles), rtol=FRACTILE_RTOL)
    np.testing.assert_array_equal(tres.widths.numpy() > 0,
                                  np.asarray(jres.widths) > 0)
    np.testing.assert_allclose(tres.widths.numpy(), np.asarray(jres.widths),
                               **STACK_TOL)
    np.testing.assert_allclose(tres.levels.numpy(), np.asarray(jres.levels),
                               **STACK_TOL)
    np.testing.assert_allclose(tres.per_horizon_levels.numpy(),
                               np.asarray(jres.per_horizon_levels),
                               **STACK_TOL)


@pytest.mark.parametrize("horizons,eval_weeks", [((1, 2), None),
                                                 ((1, 3, 4), 4)])
def test_compare_horizons(horizons, eval_weeks):
    base = jdm.synth_demand(WK * 4, jdm.DemandConfig(annual_growth=0.0,
                                                     noise_sigma=0.0))
    yhat = np.asarray(base) * np.repeat([1.0, 0.865, 0.9, 1.05], WK)
    yhat = yhat.astype(np.float32)
    want = jpl.compare_horizons(jnp.asarray(yhat), horizons,
                                eval_weeks=eval_weeks)
    got = tpl.compare_horizons(torch.from_numpy(yhat), horizons,
                               eval_weeks=eval_weeks)
    assert sorted(got) == sorted(want)
    for w in horizons:
        assert got[w]["level"] == want[w]["level"]
        assert got[w]["total_spend"] == pytest.approx(
            want[w]["total_spend"], rel=1e-5)
    assert got[2 if 2 in got else 3]["level"] < got[1]["level"]
    assert float(tcm.commitment_cost(torch.from_numpy(yhat), 0.0)) == \
        pytest.approx(float(jcm.commitment_cost(jnp.asarray(yhat), 0.0)),
                      rel=1e-5)


def test_unported_bands_name_their_item():
    """The band still to come (telemetry) raises naming its ROADMAP item;
    migration, convertible and scenarios are ported and not refused."""
    assert sorted(tpl.UNPORTED_BANDS) == ["telemetry"]
    for kw, item in (({"telemetry": True}, "item 14"),):
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            with pytest.raises(NotImplementedError, match=item):
                tpl.reject_unported_bands(**kw)
    tpl.reject_unported_bands(telemetry=False)


# The spot band in the one-shot plan (spot=True), on the same two fleets:
# the short one against the reference's own pipeline, the yearly one
# against the reference fed the port's forecasts.  Floors are order
# statistics of the forecast, so they are held like the stack's levels;
# the bill within the costs' rel 1e-3.
@pytest.fixture(scope="module", params=sorted(FLEETS))
def spot_plans(request):
    return _plan_both(request.param, spot=True)


@pytest.mark.parametrize("field", COSTS + ("spot_cost",))
def test_spot_costs(spot_plans, field):
    _, _, _, jres, tres = spot_plans
    assert getattr(tres, field) == pytest.approx(getattr(jres, field),
                                                 rel=COST_REL)


def test_spot_floors_widths_and_lines(spot_plans):
    _, _, _, jres, tres = spot_plans
    np.testing.assert_allclose(tres.spot_floor, np.asarray(jres.spot_floor),
                               **STACK_TOL)
    np.testing.assert_allclose(tres.widths, jres.widths, **STACK_TOL)
    np.testing.assert_allclose(tres.per_horizon_levels,
                               jres.per_horizon_levels, **STACK_TOL)
    for name in ("rate", "cap", "market_rate", "availability"):
        np.testing.assert_allclose(getattr(tres.spot_lines, name).numpy(),
                                   np.asarray(getattr(jres.spot_lines, name)),
                                   rtol=0, atol=1e-6)
    for jp, tp in zip(jres.per_pool, tres.per_pool):
        assert tp.spend.spot == pytest.approx(jp.spend.spot, rel=COST_REL,
                                              abs=1e-6)


def test_spot_plan_accounting(spot_plans):
    """The reference's TestOneShotSpot: the bill adds up, spot is bought,
    and a cheaper top band never grows the committed stack."""
    _, _, tpools, _, res = spot_plans
    assert res.spot_floor.shape == (tpools.num_pools,)
    assert res.spot_cost > 0
    assert res.total_cost == pytest.approx(
        res.committed_cost + res.on_demand_cost + res.spot_cost, rel=1e-12)
    base = tapi.plan(tapi.PlanRequest(pools=tpools, horizon_weeks=HORIZON),
                     device="cpu")
    assert res.widths.sum() <= base.widths.sum() + 1e-4
    assert (res.spot_floor >= res.widths.sum(-1) - 1e-4).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prefix_spot_floors_snap_to_reference_levels(seed):
    """Per-horizon spot floors on random forecasts.  A floor snaps to an
    observed forecast level, the first whose above-volume fits the cap; a
    float32 suffix sum taken in another order can move it to the
    neighbouring sorted level.  So each port floor equals the reference's
    or a neighbour of it in the sorted forecast, and the volumes above
    the floors agree at rel 1e-4."""
    rng = np.random.default_rng(seed)
    yhat = rng.gamma(3.0, 20.0, (6, 4 * WK)).astype(np.float32)
    cap = rng.uniform(0.0, 0.6, 6).astype(np.float32)
    w_hours = np.arange(1, 5) * WK
    want = np.asarray(jax.vmap(jpl._prefix_spot_floors,
                               in_axes=(0, None, 0))(
        jnp.asarray(yhat), jnp.asarray(w_hours), jnp.asarray(cap)))
    got = tpl._prefix_spot_floors(torch.from_numpy(yhat),
                                  torch.from_numpy(w_hours),
                                  torch.from_numpy(cap)).numpy()
    assert got.shape == want.shape == (6, 4)
    for p in range(6):
        levels = np.sort(yhat[p])
        for w in range(4):
            i = np.searchsorted(levels, want[p, w])
            near = levels[max(i - 1, 0):i + 2]
            assert got[p, w] in near, (p, w)

    def above(floors):
        return sum(float(np.maximum(yhat[p, :w_hours[w]] - floors[p, w],
                                    0.0).sum())
                   for p in range(6) for w in range(4))

    assert above(got) == pytest.approx(above(want), rel=1e-4)



# The migration and convertible bands in the one-shot plan
# (migration=, convertible=True), on two turnover fleets of the JAX
# package carried across: 4 pools x 30 weeks with the reference's planted
# rolling table (adoption midpoints in weeks 14 and 21), and 4 pools x 68
# weeks (>= 1.2 years of history, so the yearly terms are on) with its
# decomposition table (weeks 35 and 68).  On the yearly fleet the
# reference runs on the port's pair-total forecasts (its float32 fit
# strays there, see above) and fits its own shares.  Forecasts within
# rtol 5e-4; the pools' stacks, the cloud bands and their allocation
# within the stack tolerance; every cost within rel 1e-3 of the bill.
MIG_PLANTS = {
    "short": (30, jgn.MigrationConfig(generations=(
        jpr.Generation("aws", "C6i", "C7i", 8, 12.0, 0.25),
        jpr.Generation("gcp", "N2-Standard", "N4-Standard", 16, 10.0, 0.50),
    ))),
    "yearly": (68, jgn.MigrationConfig(generations=(
        jpr.Generation("aws", "C6i", "C7i", 20, 30.0, 0.25),
        jpr.Generation("gcp", "N2-Standard", "N4-Standard", 55, 26.0, 0.50),
    ))),
}
MIG_COSTS = ("total_cost", "committed_cost", "on_demand_cost", "conv_cost",
             "aggregate_cost")


@pytest.fixture(scope="module", params=sorted(MIG_PLANTS))
def mig_plans(request):
    weeks, jplant = MIG_PLANTS[request.param]
    jpools = jtr.synthetic_pool_set(num_pools=4, num_hours=weeks * WK,
                                    seed=3, migration=jplant)
    tpools = convert.pool_set_from_reference(jpools)
    tplant = convert.migration_config_from_reference(jplant)
    tres = tapi.plan(tapi.PlanRequest(pools=tpools, horizon_weeks=HORIZON,
                                      migration=tplant, convertible=True),
                     device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        if request.param == "yearly":
            hist = torch.from_numpy(tpools.demand[:, :-HORIZON * WK])
            edges = tgn.migration_edges(tpools.keys, tplant, device="cpu")
            model = tfc.fit_batched(tmg.transform_for_fit(hist, edges))
            t_fut = hist.shape[-1] + torch.arange(HORIZON * WK)
            tot = tfc.predict_batched(model, t_fut).numpy()
            agg = tfc.fit(hist.sum(0))
            agg_yhat = tfc.forecast_horizon(agg, hist.shape[-1],
                                            HORIZON * WK).numpy()
            mp.setattr(jfc, "predict_batched",
                       lambda model, t: jnp.asarray(tot))
            mp.setattr(jfc, "forecast_horizon",
                       lambda model, t0, n: jnp.asarray(agg_yhat))
        jres = japi.plan(japi.PlanRequest(pools=jpools,
                                          horizon_weeks=HORIZON,
                                          migration=jplant,
                                          convertible=True))
    return request.param, tpools, jres, tres


@pytest.mark.parametrize("field", MIG_COSTS)
def test_migration_convertible_costs(mig_plans, field):
    _, _, jres, tres = mig_plans
    got, want = getattr(tres, field), getattr(jres, field)
    assert abs(got - want) <= COST_REL * abs(jres.total_cost), field


def test_migration_convertible_forecasts_and_stacks(mig_plans):
    _, _, jres, tres = mig_plans
    np.testing.assert_allclose(tres.forecasts, jres.forecasts,
                               rtol=FORECAST_RTOL)
    np.testing.assert_allclose(tres.widths, jres.widths, **STACK_TOL)
    np.testing.assert_allclose(tres.levels, jres.levels, **STACK_TOL)
    assert tres.conv_clouds == tuple(jres.conv_clouds)
    assert tres.conv_options == convert.options_from_reference(
        jres.conv_options)
    np.testing.assert_allclose(tres.conv_widths, np.asarray(jres.conv_widths),
                               **STACK_TOL)
    np.testing.assert_allclose(tres.conv_alloc, np.asarray(jres.conv_alloc),
                               **STACK_TOL)
    for field in ("src", "dst", "uplift", "inv_gain"):
        np.testing.assert_array_equal(
            getattr(tres.migration_edges, field).numpy(),
            np.asarray(getattr(jres.migration_edges, field)))


def test_migration_convertible_accounting(mig_plans):
    """The reference's checks on the one-shot plan's fields: the bill adds
    up with the convertible spend, the allocation stays inside its cloud,
    and the cloud book holds the bands bought."""
    _, tpools, _, res = mig_plans
    assert res.migration_edges.num_edges == 2
    assert res.conv_widths.shape == (len(res.conv_clouds),
                                     len(res.conv_options))
    assert res.conv_cost > 0.0
    assert res.total_cost == pytest.approx(
        res.committed_cost + res.on_demand_cost + res.conv_cost, rel=1e-12)
    member = np.asarray([[1.0 if c == k[0] else 0.0 for k in res.keys]
                         for c in res.conv_clouds])
    assert (member @ res.conv_alloc <= res.conv_widths.sum(-1) + 1e-3).all()
    assert res.conv_ladders.keys == tuple(
        (c, "*", "convertible") for c in res.conv_clouds)
    np.testing.assert_allclose(
        res.conv_ladders.option_widths(0, len(res.conv_options)),
        res.conv_widths, rtol=1e-6)
    # the allocation lifts the billed level: each pool's on-demand spend
    # is the demand above its stack plus its allocation
    actual = tpools.demand[:, -HORIZON * WK:]
    od = tpf.pricing.on_demand_premium()
    for p, entry in enumerate(res.per_pool):
        level = res.widths[p].sum() + res.conv_alloc[p]
        want = od * np.maximum(actual[p] - level, 0.0).sum()
        assert entry.spend.on_demand == pytest.approx(want, rel=1e-4,
                                                      abs=1e-3)


def test_migration_only_and_convertible_only():
    """Each band alone, on the short fleet: migration without convertible
    recomposes the forecasts and buys no cloud band; convertible without
    migration keeps the plain forecasts."""
    weeks, jplant = MIG_PLANTS["short"]
    tpools = convert.pool_set_from_reference(jtr.synthetic_pool_set(
        num_pools=4, num_hours=weeks * WK, seed=3, migration=jplant))
    tplant = convert.migration_config_from_reference(jplant)
    both = tapi.plan(tapi.PlanRequest(pools=tpools, horizon_weeks=HORIZON,
                                      migration=tplant, convertible=True),
                     device="cpu")
    mig = tapi.plan(tapi.PlanRequest(pools=tpools, horizon_weeks=HORIZON,
                                     migration=tplant), device="cpu")
    np.testing.assert_array_equal(mig.forecasts, both.forecasts)
    assert mig.conv_options is None and mig.conv_cost == 0.0
    conv = tapi.plan(tapi.PlanRequest(pools=tpools, horizon_weeks=HORIZON,
                                      convertible=True), device="cpu")
    plain = tapi.plan(tapi.PlanRequest(pools=tpools, horizon_weeks=HORIZON),
                      device="cpu")
    np.testing.assert_array_equal(conv.forecasts, plain.forecasts)
    assert conv.migration_edges is None and conv.conv_widths is not None
    with pytest.raises(TypeError, match="MigrationConfig"):
        tapi.PlanRequest(pools=tpools, migration="yes")
