"""The PyTorch port's Eq. (1) cost and its solvers against the JAX
package's (``repro.core.commitment``, ``optimal_commitment_sweep``), on
the CPU, where the sweep runs its plain version.

Tolerances are the reference's own:

* cost, curve, spend and unused fraction at rel 1e-5
  (tests/test_commitment.py, ``TestCostFunction``);
* the quantile solver equal, element for element: it is one order
  statistic, and the port rounds T * A/(A+B) to float32 before the
  ceiling, as the reference's ``jnp.ceil`` of a Python float does;
* golden and Brent costs within rel 1e-3 of the quantile cost
  (``TestSolverAgreement``);
* the grid+refine sweep within C(c_grid) <= C(c_exact) (1 + 1e-3)
  (tests/test_kernels.py), and its cost within rel 1e-5 of the JAX grid's.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import commitment as jcm  # noqa: E402
from repro.kernels.commitment_sweep import ops as jops  # noqa: E402
from repro_torch.core import commitment as tcm  # noqa: E402
from repro_torch.kernels.commitment_sweep import ops as tops  # noqa: E402

REL = 1e-5
SOLVER_REL = 1e-3


def _traces(p, t, seed):
    return np.random.default_rng(seed).gamma(2.0, 50.0, (p, t)).astype(
        np.float32)


@pytest.fixture(scope="module")
def f():
    return _traces(4, 24 * 14, 0)


def test_constants_equal():
    assert (tcm.DEFAULT_A, tcm.DEFAULT_B) == (jcm.DEFAULT_A, jcm.DEFAULT_B)
    assert tcm._INVPHI == float(jcm._INVPHI)
    assert tcm._INVPHI2 == float(jcm._INVPHI2)


@pytest.mark.parametrize("a,b", [(2.1, 1.0), (1.5, 0.4)])
def test_cost_spend_unused(f, a, b):
    c = np.percentile(f, 60, axis=-1).astype(np.float32)
    ft, ct = torch.from_numpy(f), torch.from_numpy(c)
    fj, cj = jnp.asarray(f), jnp.asarray(c)
    np.testing.assert_allclose(
        tcm.commitment_cost(ft, ct, a, b).numpy(),
        np.asarray(jcm.commitment_cost(fj, cj, a, b)), rtol=REL)
    np.testing.assert_allclose(
        tcm.total_spend(ft, ct, a, 0.8).numpy(),
        np.asarray(jcm.total_spend(fj, cj, a, 0.8)), rtol=REL)
    np.testing.assert_allclose(
        tcm.unused_commitment_fraction(ft, ct).numpy(),
        np.asarray(jcm.unused_commitment_fraction(fj, cj)), rtol=REL)
    # a Python float level, as the planner passes one
    assert float(tcm.commitment_cost(ft[0], float(c[0]), a, b)) == \
        pytest.approx(float(jcm.commitment_cost(fj[0], float(c[0]), a, b)),
                      rel=REL)


def test_cost_curve(f):
    cs = np.linspace(f.min(), f.max(), 17).astype(np.float32)
    got = tcm.cost_curve(torch.from_numpy(f), torch.from_numpy(cs))
    want = jcm.cost_curve(jnp.asarray(f), jnp.asarray(cs))
    assert got.shape == (4, 17)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=REL)
    one = tcm.cost_curve(torch.from_numpy(f[0]), torch.from_numpy(cs))
    np.testing.assert_allclose(one.numpy(), np.asarray(want[0]), rtol=REL)


@pytest.mark.parametrize("num_levels", [9, 5])
def test_scenario_costs(f, num_levels):
    lv_t, cost_t, arg_t = tcm.scenario_costs(torch.from_numpy(f[1]),
                                             num_levels)
    lv_j, cost_j, arg_j = jcm.scenario_costs(jnp.asarray(f[1]), num_levels)
    np.testing.assert_allclose(lv_t.numpy(), np.asarray(lv_j), rtol=REL)
    np.testing.assert_allclose(cost_t.numpy(), np.asarray(cost_j), rtol=REL)
    assert int(arg_t) == int(arg_j)


@pytest.mark.parametrize("t", [1, 31, 336, 1016, 1344, 8760])
@pytest.mark.parametrize("a,b", [(2.1, 1.0), (3.0, 0.7)])
def test_quantile_solver_equal(t, a, b):
    x = _traces(3, t, t)
    got = tcm.optimal_commitment_quantile(torch.from_numpy(x), a, b)
    want = jcm.optimal_commitment_quantile(jnp.asarray(x), a, b)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_quantile_index_rounds_through_float32():
    """The lengths where Python's float and float32 disagree on
    ceil(T * A/(A+B)): the port takes the reference's side."""
    q = 2.1 / 3.1
    split = [t for t in range(1, 20000)
             if math.ceil(t * q) != math.ceil(float(np.float32(t * q)))]
    assert split
    for t in split[:3]:
        x = np.arange(t, dtype=np.float32)[::-1].copy()
        got = tcm.optimal_commitment_quantile(torch.from_numpy(x))
        want = jcm.optimal_commitment_quantile(jnp.asarray(x))
        assert float(got) == float(want)


def test_golden_and_brent_match_quantile_cost(f):
    ft = torch.from_numpy(f)
    c_q = tcm.optimal_commitment_quantile(ft)
    c_g = tcm.optimal_commitment_golden(ft)
    cost_q = tcm.commitment_cost(ft, c_q).numpy()
    np.testing.assert_allclose(tcm.commitment_cost(ft, c_g).numpy(), cost_q,
                               rtol=SOLVER_REL)
    # the same bracket walk as the reference's golden section
    c_gj = np.asarray(jcm.optimal_commitment_golden(jnp.asarray(f[0])))
    np.testing.assert_allclose(float(c_g[0]), float(c_gj), rtol=1e-4)
    for i in range(2):
        c_b = tcm.optimal_commitment_brent(ft[i])
        assert c_b == pytest.approx(jcm.optimal_commitment_brent(f[i]),
                                    rel=1e-6)
        cost_b = float(tcm.commitment_cost(ft[i], c_b))
        assert cost_b == pytest.approx(float(cost_q[i]), rel=SOLVER_REL)


def test_golden_batches_leading_axes(f):
    x = torch.from_numpy(f.reshape(2, 2, -1))
    got = tcm.optimal_commitment_golden(x)
    assert got.shape == (2, 2)
    flat = tcm.optimal_commitment_golden(torch.from_numpy(f))
    np.testing.assert_array_equal(got.reshape(-1).numpy(), flat.numpy())


@pytest.mark.parametrize("num", [(128, 128), (16, 8)])
def test_optimal_commitment_sweep(num):
    x = _traces(6, 24 * 14, 3)
    kw = dict(num_coarse=num[0], num_fine=num[1])
    c_t = tops.optimal_commitment_sweep(torch.from_numpy(x), **kw)
    c_j = np.asarray(jops.optimal_commitment_sweep(jnp.asarray(x), **kw))
    c_ex = np.asarray(jcm.optimal_commitment_quantile(jnp.asarray(x)))
    cost = lambda c: np.asarray(jcm.commitment_cost(  # noqa: E731
        jnp.asarray(x), jnp.asarray(c)))
    if num == (128, 128):
        assert (cost(c_t.numpy()) <= cost(c_ex) * (1 + SOLVER_REL)).all()
    np.testing.assert_allclose(cost(c_t.numpy()), cost(c_j), rtol=REL)
    one = tops.optimal_commitment_sweep(torch.from_numpy(x[2]), **kw)
    assert one.shape == (1,)
    assert float(one[0]) == float(c_t[2])
