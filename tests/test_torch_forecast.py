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
