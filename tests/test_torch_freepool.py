"""Paper §5's free-pool sizing in the PyTorch port (``core/freepool.py``,
on the CPU) against the JAX package, on the same numpy-seeded traces.

* ``optimal_static_pool``: bit for bit (both take the reference's
  linear-interpolated quantile; the port's ``freepool._quantile``
  reproduces ``jnp.quantile``'s fused interpolation, one row and several).
* ``predicted_pool`` fits the forecaster: the port solves the normal
  equations in a whitened basis, the reference as they stand, both in
  float32 (no yearly terms, no changepoints, so the systems are well
  conditioned).  Each hour within rel 1e-4 of the pool's peak (measured
  ~1.5e-5), at lead times 0, 1 and 3.
* ``compare_static_vs_predicted``: the static size bit for bit, its cost
  and under-minutes up to float32 summation order (rel 1e-6).  The
  predicted pool's figures are Lipschitz in the pool: its cost moves by
  at most max(p_over, p_under) x sum_t |d pool_t|, its under-minutes by
  sum_t |d pool_t| and its mean by the mean |d pool_t|; each is held to
  that bound on the two packages' pools (plus rel 1e-6 for summation
  order).
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import demand as jdm  # noqa: E402
from repro.core import freepool as jfp  # noqa: E402
from repro_torch.core import demand as tdm  # noqa: E402
from repro_torch.core import freepool as tfp  # noqa: E402

WK = 168
POOL_RTOL = 1e-4


def _trace(num_hours, seed):
    base = np.asarray(jdm.synth_demand(num_hours, jdm.DemandConfig(
        noise_sigma=0.0)))
    rng = np.random.default_rng(seed)
    return (base * (1.0 + 0.06 * rng.standard_normal(num_hours))
            ).astype(np.float32)


@pytest.fixture(scope="module")
def split():
    full = _trace(9 * WK, 5)
    return full[:8 * WK], full[8 * WK:]


def test_static_pool_bit_for_bit(split):
    hist, _ = split
    rng = np.random.default_rng(0)
    gamma = rng.gamma(2, 10, (3, 500)).astype(np.float32)
    # one row (a scalar level: the reference's program fuses the other
    # product) and several rows
    for d, cfg in ((hist, (1.0, 10.0)), (gamma[:1, :77], (1.0, 10.0)),
                   (gamma, (1.0, 3.0)), (gamma[:, :77], (2.0, 5.0))):
        jc, tc = jfp.FreePoolConfig(*cfg), tfp.FreePoolConfig(*cfg)
        want = np.asarray(jfp.optimal_static_pool(jnp.asarray(d), jc))
        got = tfp.optimal_static_pool(torch.from_numpy(d), tc).numpy()
        np.testing.assert_array_equal(got, want)
        assert tfp.critical_fractile(tc) == jfp.critical_fractile(jc)


@pytest.mark.parametrize("lead", [0, 1, 3])
def test_predicted_pool_matches_reference(split, lead):
    hist, fut = split
    jc = jfp.FreePoolConfig(1.0, 10.0, lead)
    tc = tfp.FreePoolConfig(1.0, 10.0, lead)
    want = np.asarray(jfp.predicted_pool(jnp.asarray(hist), WK, jc))
    got = tfp.predicted_pool(hist, WK, tc, device="cpu")
    assert got.shape == (WK,) and got.dtype == torch.float32
    got = got.numpy()
    assert np.abs(got - want).max() <= POOL_RTOL * np.abs(want).max()

    ref = jfp.compare_static_vs_predicted(jnp.asarray(hist), jnp.asarray(fut),
                                          jc)
    out = tfp.compare_static_vs_predicted(hist, fut, tc, device="cpu")
    assert set(out) == set(ref)
    assert out["static_size"] == ref["static_size"]
    for key in ("static_cost", "under_minutes_static"):
        assert out[key] == pytest.approx(ref[key], rel=1e-6), key
    dpool = np.abs(got - want).astype(np.float64)
    bounds = {"predicted_cost": max(tc.p_over, tc.p_under) * dpool.sum(),
              "under_minutes_predicted": dpool.sum(),
              "predicted_mean_size": dpool.mean()}
    for key, bound in bounds.items():
        assert abs(out[key] - ref[key]) <= bound + 1e-6 * abs(ref[key]), key
    # Fig. 12: the predicted pool beats the best static pool
    assert out["predicted_cost"] < out["static_cost"]


def test_static_pool_minimizes_cost():
    """``tests/test_planner.py::test_static_pool_is_quantile`` in the port:
    the fractile pool costs no more than any level of a fine grid."""
    d = torch.from_numpy(
        np.random.default_rng(0).gamma(2, 10, 500).astype(np.float32))
    cfg = tfp.FreePoolConfig(p_over=1.0, p_under=3.0)
    pool = tfp.optimal_static_pool(d, cfg)
    grid = torch.linspace(float(d.min()), float(d.max()), 400)
    costs = tfp.pool_cost(grid[:, None].expand(-1, d.shape[0]), d, cfg)
    assert float(tfp.pool_cost(pool.expand_as(d), d, cfg)) <= float(
        costs.min()) * (1 + 1e-3)


def test_predicted_beats_static_on_own_draws():
    """Fig. 12 on the port's own noise (``torch.Generator``)."""
    gen = torch.Generator().manual_seed(2)
    full = tdm.synth_demand(9 * WK, generator=gen)
    cfg = tfp.FreePoolConfig(p_over=1.0, p_under=10.0, lead_time=1)
    out = tfp.compare_static_vs_predicted(full[:8 * WK], full[8 * WK:], cfg,
                                          device="cpu")
    assert out["predicted_cost"] < out["static_cost"]
    assert out["under_minutes_predicted"] < out["under_minutes_static"]


def test_latency_profile_matches_reference():
    h = np.arange(48, dtype=np.float32) % 24
    np.testing.assert_allclose(
        tfp.provisioning_latency_profile(torch.from_numpy(h)).numpy(),
        np.asarray(jfp.provisioning_latency_profile(jnp.asarray(h))),
        rtol=1e-6)


def test_predicted_pool_defaults_to_the_card(split):
    hist, _ = split
    if torch.cuda.is_available():
        assert tfp.predicted_pool(hist, WK).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tfp.predicted_pool(hist, WK)
