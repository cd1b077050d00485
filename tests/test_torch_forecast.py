"""The PyTorch port's prefix-refit forecaster against the JAX package's, on
a 4-pool x 20-week fleet of the JAX package's own synthetic demand.

The forecast ``yhat`` agrees to rel 1e-4: the normal equations are float32
ridge solves (ridge 1e-3), and the two packages sum and factorize in
different orders, which moves ``beta`` and the forecast in their last
digits.  ``beta`` itself is compared only through the forecast.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import forecast as jfc  # noqa: E402
from repro.data import traces as jtr  # noqa: E402
from repro_torch.core import forecast as tfc  # noqa: E402
from repro_torch.numerics import linspace  # noqa: E402

WK = 168
HORIZON = 3 * WK
START = 6
YHAT_RTOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _full_f32_matmuls():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_float32_matmul_precision(prev)


@pytest.fixture(scope="module")
def demand():
    return np.asarray(
        jtr.synthetic_pool_set(num_pools=4, num_hours=20 * WK).demand
    )


@pytest.fixture(scope="module")
def states(demand):
    kw = dict(horizon_hours=HORIZON, min_prefix_hours=START * WK)
    return (
        jfc.prefix_fit_state(jnp.asarray(demand), jfc.ForecastConfig(), **kw),
        tfc.prefix_fit_state(torch.from_numpy(demand), tfc.ForecastConfig(),
                             **kw),
    )


@pytest.mark.parametrize("t_max", [1.0, 3359.0, 26207.0])
def test_design_matrix(t_max):
    t = np.arange(0, 26208 + HORIZON, 7)
    cfg_j, cfg_t = jfc.ForecastConfig(), tfc.ForecastConfig()
    want = np.asarray(jfc.design_matrix(jnp.asarray(t), cfg_j, t_max))
    got = tfc.design_matrix(torch.from_numpy(t), cfg_t, t_max).numpy()
    assert got.shape == want.shape
    # sin/cos of the same float32 angles, one ulp apart at most
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_changepoint_knots_equal_the_rolling_paths(states):
    """The knots linspace(0.1, 0.9, 8) bit for bit: the rolling replay
    builds its design matrix eagerly (``prefix_fit_state``), so its knots
    are an eager ``jnp.linspace``'s, and the changepoint columns of both
    packages' refit states are then equal bit for bit too."""
    js, ts = states
    want = np.asarray(jnp.linspace(0.1, 0.9, 8))
    got = linspace(0.1, 0.9, 8).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    cps = slice(2, 2 + tfc.ForecastConfig().num_changepoints)
    np.testing.assert_array_equal(
        ts.x[:, cps].numpy().view(np.uint32),
        np.asarray(js.x)[:, cps].view(np.uint32),
    )


@pytest.mark.parametrize("start,stop,num", [
    (0.1, 0.9, 3), (0.1, 0.9, 20), (-2.5, 1.75, 11), (0.0, 1.0, 128),
    (0.0, 1.0, 257),
])
def test_linspace_equals_eager_reference(start, stop, num):
    want = np.asarray(jnp.linspace(start, stop, num))
    got = linspace(start, stop, num).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_short_history_drops_yearly_terms(states):
    js, ts = states
    assert ts.cfg == tfc.ForecastConfig(yearly_order=0)
    assert ts.x.shape == js.x.shape == (20 * WK + HORIZON, 31)
    assert ts.t_max == js.t_max and ts.num_hist_hours == js.num_hist_hours


def test_prefix_sums(states):
    js, ts = states
    np.testing.assert_allclose(ts.logy.numpy(), np.asarray(js.logy),
                               rtol=1e-6)
    np.testing.assert_allclose(
        ts.gram_prefix.numpy(), np.asarray(js.gram_prefix),
        rtol=1e-4, atol=1e-2,
    )
    np.testing.assert_allclose(
        ts.rhs_prefix.numpy(), np.asarray(js.rhs_prefix),
        rtol=1e-4, atol=1e-2,
    )


def _yhat_j(js, beta, week):
    return np.asarray(jfc.predict_from_beta(js, beta, week * WK, HORIZON))


def _yhat_t(ts, beta, week):
    return tfc.predict_from_beta(ts, beta, week * WK, HORIZON).numpy()


@pytest.mark.parametrize("week", [START, 12, 19])
def test_solve_prefix_forecast(states, week):
    js, ts = states
    want = _yhat_j(js, jfc.solve_prefix(js, week), week)
    got = _yhat_t(ts, tfc.solve_prefix(ts, week), week)
    np.testing.assert_allclose(got, want, rtol=YHAT_RTOL)


@pytest.mark.parametrize("week", [START, 12, 19])
def test_solve_prefix_direct_forecast(states, week):
    """The direct refit differs from the prefix-sum refit in summation
    order only, and on these short prefixes that alone moves the JAX
    package's own two forecasts apart by up to ~1e-4.  So the port's direct
    forecast is held to the JAX prefix-sum forecast at rel 1e-4, and to
    the JAX direct one (and the port's own prefix-sum one) at the
    reference's scan-vs-loop bound, rtol 1e-3 (tests/test_replan.py)."""
    js, ts = states
    got = _yhat_t(ts, tfc.solve_prefix_direct(ts, week), week)
    np.testing.assert_allclose(
        got, _yhat_j(js, jfc.solve_prefix(js, week), week), rtol=YHAT_RTOL)
    np.testing.assert_allclose(
        got, _yhat_j(js, jfc.solve_prefix_direct(js, week), week), rtol=1e-3)
    np.testing.assert_allclose(
        got, _yhat_t(ts, tfc.solve_prefix(ts, week), week), rtol=1e-3)


def test_irls_refine_forecast(states):
    js, ts = states
    week = 12
    want = _yhat_j(js, jfc.irls_refine(js, jfc.solve_prefix(js, week),
                                       week, 2), week)
    got = _yhat_t(ts, tfc.irls_refine(ts, tfc.solve_prefix(ts, week),
                                      week, 2), week)
    np.testing.assert_allclose(got, want, rtol=YHAT_RTOL)
    beta = tfc.solve_prefix(ts, week)
    assert tfc.irls_refine(ts, beta, week, 0) is beta


def test_predict_from_beta_same_beta(states):
    """With one beta the forecasts differ only by the design matrix."""
    js, ts = states
    beta = np.random.default_rng(0).normal(0, 0.05, (4, 31)).astype(
        np.float32)
    beta[:, 0] = 4.0
    want = _yhat_j(js, jnp.asarray(beta), 10)
    got = _yhat_t(ts, torch.from_numpy(beta), 10)
    np.testing.assert_allclose(got, want, rtol=1e-5)


# The one-shot fit: fit / fit_batched / predict against the reference on
# short histories (yearly terms off).  The port solves the normal equations
# in a whitened basis (forecast._whiten); the reference solves them as they
# stand in float32, where a condition number of ~2e6-4e6 puts its forecasts
# up to 4.2e-4 from a float64 solve of the same equations (the port's stay
# within 2.1e-5; tests/test_torch_planner.py holds the port to the float64
# solve).  So the one-shot fits agree within FIT_RTOL = 5e-4.

FIT_RTOL = 5e-4

@pytest.fixture(scope="module")
def one_shot(demand):
    hist = demand[:, :12 * WK]
    t_fut = np.arange(12 * WK, 14 * WK)
    jm = jfc.fit_batched(jnp.asarray(hist))
    tm = tfc.fit_batched(torch.from_numpy(hist))
    return hist, t_fut, jm, tm


def test_fit_batched_forecast(one_shot):
    hist, t_fut, jm, tm = one_shot
    assert tm.t_max == jm.t_max
    assert tm.cfg.yearly_order == jm.cfg.yearly_order == 0
    assert tm.beta.shape == jm.beta.shape == (4, 31)
    want = np.asarray(jfc.predict_batched(jm, jnp.asarray(t_fut)))
    got = tfc.predict_batched(tm, torch.from_numpy(t_fut)).numpy()
    np.testing.assert_allclose(got, want, rtol=FIT_RTOL)


@pytest.mark.parametrize("cfg_kw", [{}, {"irls_iters": 0},
                                    {"asym_weight": 1.0}])
def test_fit_and_forecast_horizon(one_shot, cfg_kw):
    hist, t_fut, _, _ = one_shot
    jm = jfc.fit(jnp.asarray(hist[1]), jfc.ForecastConfig(**cfg_kw))
    tm = tfc.fit(torch.from_numpy(hist[1]), tfc.ForecastConfig(**cfg_kw))
    want = np.asarray(jfc.forecast_horizon(jm, 12 * WK, 2 * WK))
    got = tfc.forecast_horizon(tm, 12 * WK, 2 * WK).numpy()
    np.testing.assert_allclose(got, want, rtol=FIT_RTOL)
    np.testing.assert_allclose(
        tfc.predict(tm, torch.from_numpy(t_fut)).numpy(), got, rtol=1e-6)


def test_fit_is_a_row_of_fit_batched(one_shot):
    hist, t_fut, _, tm = one_shot
    solo = tfc.fit(torch.from_numpy(hist[2]))
    np.testing.assert_allclose(
        tfc.predict(solo, torch.from_numpy(t_fut)).numpy(),
        tfc.predict_batched(tm, torch.from_numpy(t_fut))[2].numpy(),
        rtol=1e-5)


def test_solve_wls_matches_reference(demand):
    """One weighted ridge solve with asymmetric weights, through the
    whitened basis, against the reference's plain normal equations."""
    t = np.arange(6 * WK, dtype=np.float32)
    cfg = tfc.ForecastConfig(yearly_order=0)
    x_j = jfc.design_matrix(jnp.asarray(t), jfc.ForecastConfig(
        yearly_order=0), 6 * WK - 1.0)
    logy = np.log(demand[:2, :6 * WK])
    w = np.where(np.arange(6 * WK) % 3 == 0, 2.1, 1.0).astype(np.float32)
    want = np.stack([np.asarray(x_j @ jfc._solve_wls(
        x_j, jnp.asarray(y), jnp.asarray(w), cfg.ridge)) for y in logy])
    x_t = tfc.design_matrix(torch.from_numpy(t), cfg, 6 * WK - 1.0)
    beta = tfc._solve_wls(x_t, torch.from_numpy(logy),
                          torch.from_numpy(w).expand(2, -1), cfg.ridge)
    np.testing.assert_allclose((beta @ x_t.T).numpy(), want, rtol=FIT_RTOL)


def test_short_history_guard_of_fit(demand):
    """Below ~1.2 years the yearly terms are off in both fits; the guard
    keys on the history's length."""
    year = int(1.2 * tfc.HOURS_PER_YEAR)
    for n, order in ((year - 1, 0), (year + 1, 8)):
        y = torch.ones(n) * 5.0
        assert tfc.fit(y).cfg.yearly_order == order
        assert tfc.fit_batched(y[None]).cfg.yearly_order == order
        assert jfc.fit(jnp.ones(n)).cfg.yearly_order == order


def test_weighted_mape():
    rng = np.random.default_rng(1)
    y = rng.gamma(2, 50, (3, 40)).astype(np.float32)
    p = y * rng.uniform(0.8, 1.2, y.shape).astype(np.float32)
    for asym in (2.1, 1.0):
        np.testing.assert_allclose(
            tfc.weighted_mape(torch.from_numpy(y), torch.from_numpy(p),
                              asym).numpy(),
            np.asarray(jfc.weighted_mape(jnp.asarray(y), jnp.asarray(p),
                                         asym)), rtol=1e-6)
