"""The PyTorch port's commitment sweep against the JAX package's.

On the CPU the port's ``ops`` runs the plain PyTorch version; the JAX side
runs its Pallas kernel in interpret mode and its jnp oracle.  Tolerances
are the reference's own (docs/ARCHITECTURE.md, "Tolerance policy"): rtol
2e-4 / atol 1e-2 on the raw over/under integrals and 1e-5 relative on the
cost curve 2.1 over + under — float32 sums taken in different orders.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.commitment_sweep import ops as jops  # noqa: E402
from repro.kernels.commitment_sweep import ref as jref  # noqa: E402
from repro_torch.kernels.commitment_sweep import commitment_sweep as tker  # noqa: E402
from repro_torch.kernels.commitment_sweep import ops as tops  # noqa: E402

RTOL, ATOL, COST_RTOL = 2e-4, 1e-2, 1e-5


def _inputs(p, t, g, weights, seed):
    rng = np.random.default_rng(seed)
    f = rng.gamma(2, 50, (p, t)).astype(np.float32)
    grid = np.linspace(0.0, 1.0, g, dtype=np.float32)
    cs = (f.max(-1, keepdims=True) * grid[None, :]).astype(np.float32)
    if weights == "none":
        w = None
    elif weights == "random":
        w = rng.random((p, t)).astype(np.float32)
    else:  # nested 0/1 prefix masks, as the grid solver's horizons
        ends = np.linspace(1, t, p).astype(int)[:, None]
        w = (np.arange(t)[None, :] < ends).astype(np.float32)
    return f, cs, w


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


def _assert_sweep_close(got, want):
    go, gu = (np.asarray(x, np.float64) for x in got)
    wo, wu = (np.asarray(x, np.float64) for x in want)
    np.testing.assert_allclose(go, wo, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(gu, wu, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(2.1 * go + gu, 2.1 * wo + wu, rtol=COST_RTOL)


@pytest.mark.parametrize("p,t,g", [
    (1, 100, 9),
    (5, 300, 37),        # ragged against every tile size
    (9, 513, 129),
    (16, 672, 64),
])
@pytest.mark.parametrize("weights", ["none", "random", "prefix"])
def test_over_under_matches_jax(p, t, g, weights):
    f, cs, w = _inputs(p, t, g, weights, seed=p * 1000 + t)
    got = tops.commitment_sweep_over_under(_t(f), _t(cs), _t(w))
    kernel = jops.commitment_sweep_over_under(
        _j(f), _j(cs), _j(w), interpret=True
    )
    oracle = jref.commitment_sweep_over_under_ref(
        _j(f), _j(np.ones_like(f) if w is None else w), _j(cs)
    )
    _assert_sweep_close(got, kernel)
    _assert_sweep_close(got, oracle)


def test_single_row_and_shared_grid_cases():
    """(T,) demand with a (G,) grid squeezes to (G,); a (G,) grid
    broadcasts over (P, T) rows — as the reference's ops."""
    f, cs, w = _inputs(3, 250, 21, "prefix", seed=3)
    grid = cs[1]
    one = tops.commitment_sweep_over_under(_t(f[1]), _t(grid), _t(w[1]))
    assert one[0].shape == (21,)
    _assert_sweep_close(one, jops.commitment_sweep_over_under(
        _j(f[1]), _j(grid), _j(w[1]), interpret=True))
    shared = tops.commitment_sweep_over_under(_t(f), _t(grid))
    assert shared[0].shape == (3, 21)
    _assert_sweep_close(shared, jops.commitment_sweep_over_under(
        _j(f), _j(grid), interpret=True))


def test_no_weights_equals_unit_weights():
    f, cs, _ = _inputs(4, 200, 17, "none", seed=4)
    a = tops.commitment_sweep_over_under(_t(f), _t(cs))
    b = tops.commitment_sweep_over_under(_t(f), _t(cs), torch.ones(4, 200))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("a,b", [(2.1, 1.0), (1.5, 0.5)])
def test_cost_curve_matches_jax(a, b):
    f, cs, w = _inputs(6, 400, 33, "random", seed=6)
    got = tops.commitment_sweep(_t(f), _t(cs), _t(w), a=a, b=b)
    want = jops.commitment_sweep(_j(f), _j(cs), _j(w), a=a, b=b,
                                 interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=COST_RTOL)
    oracle = tops.commitment_sweep_oracle(_t(f), _t(cs), _t(w), a=a, b=b)
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), rtol=COST_RTOL)
    j_oracle = jops.commitment_sweep_oracle(_j(f), _j(cs), _j(w), a=a, b=b)
    np.testing.assert_allclose(got.numpy(), np.asarray(j_oracle),
                               rtol=COST_RTOL)


def test_batched_equals_looped_bit_for_bit():
    """Batching rows is a layout change, not a numerics change: the whole
    (P, T) x (P, G) sweep equals one call per row block, bit for bit."""
    f, cs, w = _inputs(13, 337, 45, "prefix", seed=13)
    over, under = tops.commitment_sweep_over_under(_t(f), _t(cs), _t(w))
    for lo in range(0, 13, 5):
        o1, u1 = tops.commitment_sweep_over_under(
            _t(f[lo:lo + 5]), _t(cs[lo:lo + 5]), _t(w[lo:lo + 5])
        )
        assert torch.equal(o1, over[lo:lo + 5])
        assert torch.equal(u1, under[lo:lo + 5])


def test_cpu_dispatch_runs_the_plain_version():
    """A CPU tensor never reaches the kernel: the launch count stays."""
    f, cs, w = _inputs(2, 100, 9, "random", seed=2)
    before = tker.LAUNCHES
    got = tops.commitment_sweep_over_under(_t(f), _t(cs), _t(w))
    want = tops.commitment_sweep_over_under_oracle(_t(f), _t(cs), _t(w))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert tker.LAUNCHES == before


def test_kernel_wrapper_rejects_what_the_kernel_does_not_take():
    f = torch.rand(4, 50)
    cs = torch.rand(4, 8)
    w = torch.ones(4, 50)
    before = tker.LAUNCHES
    with pytest.raises(TypeError, match="float32"):
        tker.commitment_sweep_cuda(f.double(), w, cs)
    with pytest.raises(ValueError, match="contiguous"):
        tker.commitment_sweep_cuda(torch.rand(50, 4).T, w, cs)
    with pytest.raises(ValueError, match="2-D"):
        tker.commitment_sweep_cuda(f[0], w, cs)
    # Well-formed CPU tensors: the launch function raises instead of
    # computing anything, so no card means no result.
    with pytest.raises(ValueError, match="CUDA"):
        tker.commitment_sweep_cuda(f, w, cs)
    assert tker.LAUNCHES == before


def test_mixed_devices_rejected():
    f = torch.rand(2, 10)
    with pytest.raises(ValueError, match="devices"):
        tops.commitment_sweep_over_under(
            f, torch.rand(2, 3, device="meta"), torch.ones(2, 10)
        )
