"""The PyTorch port's commitment sweep against the JAX package's.

On the CPU the port's ``ops`` runs the plain PyTorch version; the JAX side
runs its Pallas kernel in interpret mode and its jnp oracle.  Tolerances
are the reference's own (docs/ARCHITECTURE.md, "Tolerance policy"): rtol
2e-4 / atol 1e-2 on the raw over/under integrals and 1e-5 relative on the
cost curve 2.1 over + under — float32 sums taken in different orders.
The CUDA kernel's own algebra (``ref.commitment_sweep_bucketed_ref``:
buckets between sorted candidates, int64 fixed-point sums) is held to the
same tolerances, and to itself bit for bit under batching and under any
order of the hours.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.commitment_sweep import ops as jops  # noqa: E402
from repro.kernels.commitment_sweep import ref as jref  # noqa: E402
from repro_torch.kernels.commitment_sweep import commitment_sweep as tker  # noqa: E402
from repro_torch.kernels.commitment_sweep import ops as tops  # noqa: E402
from repro_torch.kernels.commitment_sweep import ref as tref  # noqa: E402

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


# --- the bucketed algebra of the CUDA kernel (ref.commitment_sweep_bucketed_ref)

def _bucketed(f, cs, w):
    """The kernel's algebra on numpy inputs (w None -> ones)."""
    w = np.ones_like(f) if w is None else w
    return tref.commitment_sweep_bucketed_ref(_t(f), _t(w), _t(cs))


def _jax_both(f, cs, w):
    kernel = jops.commitment_sweep_over_under(_j(f), _j(cs), _j(w),
                                              interpret=True)
    oracle = jref.commitment_sweep_over_under_ref(
        _j(f), _j(np.ones_like(f) if w is None else w), _j(cs))
    return kernel, oracle


@pytest.mark.parametrize("p,t,g", [
    (1, 100, 9),
    (5, 300, 37),
    (9, 513, 129),       # two candidate tiles, the second of one
    (16, 672, 64),
])
@pytest.mark.parametrize("weights", ["none", "random", "prefix"])
def test_bucketed_matches_jax(p, t, g, weights):
    f, cs, w = _inputs(p, t, g, weights, seed=p * 1000 + t)
    got = _bucketed(f, cs, w)
    kernel, oracle = _jax_both(f, cs, w)
    _assert_sweep_close(got, kernel)
    _assert_sweep_close(got, oracle)


def _edge_case(name):
    rng = np.random.default_rng(7)
    f = rng.gamma(2, 50, (6, 400)).astype(np.float32)
    w = rng.random((6, 400)).astype(np.float32)
    grid = np.linspace(0.0, 1.0, 40, dtype=np.float32)
    if name == "unsorted":
        cs = rng.uniform(0, 400, (6, 40)).astype(np.float32)
    elif name == "duplicates":
        cs = (rng.integers(0, 6, (6, 40)) * 60.0).astype(np.float32)
    elif name == "all_equal":
        cs = np.full((6, 40), 120.0, np.float32)
    elif name == "negative_descending":
        f = -f
        cs = (f.max(-1, keepdims=True) * grid[None]).astype(np.float32)
        assert (np.diff(cs, axis=-1) <= 0).all()
    elif name == "f_equals_candidate":
        f[:, ::5] = 150.0
        f[:, 1::7] = 75.0
        cs = np.tile(np.float32([0.0, 75.0, 150.0, 225.0, 300.0]), (6, 1))
    elif name == "zero_weight_rows":
        cs = rng.uniform(0, 400, (6, 40)).astype(np.float32)
        w[::2] = 0.0
    elif name == "G_1":
        cs = rng.uniform(0, 400, (6, 1)).astype(np.float32)
    elif name == "T_1":
        f, w = f[:, :1].copy(), w[:, :1].copy()
        cs = rng.uniform(0, 400, (6, 40)).astype(np.float32)
    elif name == "three_years":
        f = rng.gamma(2, 50, (1, 24 * 365 * 3)).astype(np.float32)
        w = rng.random((1, f.shape[1])).astype(np.float32)
        cs = (f.max(-1, keepdims=True)
              * np.linspace(0.0, 1.0, 128, dtype=np.float32)[None])
    elif name == "G_300_unsorted":   # three tiles, each sorted on its own
        cs = rng.uniform(0, 400, (6, 300)).astype(np.float32)
    return f, cs.astype(np.float32), w


EDGE_CASES = ["unsorted", "duplicates", "all_equal", "negative_descending",
              "f_equals_candidate", "zero_weight_rows", "G_1", "T_1",
              "three_years", "G_300_unsorted"]


@pytest.mark.parametrize("name", EDGE_CASES)
def test_bucketed_edge_cases_match_jax(name):
    f, cs, w = _edge_case(name)
    got = _bucketed(f, cs, w)
    _assert_sweep_close(got, jref.commitment_sweep_over_under_ref(
        _j(f), _j(w), _j(cs)))
    if f.shape[1] <= 400:    # the interpret-mode kernel at the small cases
        _assert_sweep_close(got, jops.commitment_sweep_over_under(
            _j(f), _j(cs), _j(w), interpret=True))
    if name == "zero_weight_rows":
        assert not got[0][::2].any() and not got[1][::2].any()
    if name in ("duplicates", "all_equal"):
        # equal candidates get equal outputs, bit for bit
        for x in got:
            xs = x.numpy()
            for r in range(cs.shape[0]):
                for value in np.unique(cs[r]):
                    same = xs[r][cs[r] == value]
                    assert (same == same[0]).all()


def test_bucketed_is_closer_to_float64_than_brute_force():
    """On 64 rows of the planner's demand (a daily cycle with noise, the
    grid max(f) x linspace(0, 1, 128), prefix masks), the bucketed sums are
    at least as close to float64 exact sums as the brute-force float32
    plain version."""
    rng = np.random.default_rng(11)
    t = np.arange(1344, dtype=np.float32)
    base = 40.0 + 200.0 * rng.random((8, 1))
    shape = 1.0 + 0.15 * np.cos(2 * np.pi * (t - 15) / 24)
    yhat = (base * shape * (1.0 + 0.02 * rng.standard_normal((8, 1344))))
    f = np.repeat(yhat, 8, axis=0).astype(np.float32)
    w = np.tile((t[None, :] < (np.arange(1, 9) * 168)[:, None]), (8, 1))
    w = w.astype(np.float32)
    cs = (f.max(-1, keepdims=True)
          * np.linspace(0.0, 1.0, 128, dtype=np.float32)[None])
    diff = f.astype(np.float64)[:, None, :] - cs.astype(np.float64)[:, :, None]
    exact = ((np.maximum(diff, 0) * w[:, None, :]).sum(-1),
             (np.maximum(-diff, 0) * w[:, None, :]).sum(-1))
    bucketed = _bucketed(f, cs, w)
    brute = tops.commitment_sweep_over_under(_t(f), _t(cs), _t(w))
    for b, p, e in zip(bucketed, brute, exact):
        scale = np.maximum(np.abs(e), 1.0)
        b_err = (np.abs(b.numpy() - e) / scale).max()
        p_err = (np.abs(p.numpy() - e) / scale).max()
        assert b_err <= p_err, (b_err, p_err)


def test_bucketed_batched_equals_blocks_bit_for_bit():
    f, cs, w = _inputs(13, 337, 150, "prefix", seed=13)
    over, under = _bucketed(f, cs, w)
    for lo in range(0, 13, 5):
        o1, u1 = _bucketed(f[lo:lo + 5], cs[lo:lo + 5], w[lo:lo + 5])
        assert torch.equal(o1, over[lo:lo + 5])
        assert torch.equal(u1, under[lo:lo + 5])


def test_bucketed_non_finite_rows_are_nan():
    f, cs, w = _inputs(4, 64, 9, "random", seed=4)
    f[0, 5] = np.nan
    w[2, 60] = np.inf
    cs[3, 1] = -np.inf
    over, under = _bucketed(f, cs, w)
    for r in (0, 2, 3):
        assert over[r].isnan().all() and under[r].isnan().all()
    assert torch.isfinite(over[1]).all() and torch.isfinite(under[1]).all()
    brute = tops.commitment_sweep_over_under(_t(f), _t(cs), _t(w))
    for r in (0, 2, 3):   # the plain version is not finite there either
        assert not (torch.isfinite(brute[0][r]).all()
                    and torch.isfinite(brute[1][r]).all())


def test_bucketed_hour_order_is_irrelevant_bit_for_bit():
    """Integer sums: permuting a row's hours changes no bit."""
    hypothesis = pytest.importorskip("hypothesis")
    st = pytest.importorskip("hypothesis.strategies")

    @hypothesis.settings(max_examples=25, deadline=None)
    @hypothesis.given(seed=st.integers(0, 2**31 - 1),
                      t=st.integers(1, 300), g=st.integers(1, 140))
    def check(seed, t, g):
        rng = np.random.default_rng(seed)
        f = rng.normal(100.0, 60.0, (3, t)).astype(np.float32)
        w = (rng.random((3, t)) * (rng.random((3, t)) > 0.3))
        w = w.astype(np.float32)
        cs = rng.uniform(-50.0, 300.0, (3, g)).astype(np.float32)
        perm = rng.permutation(t)
        a = _bucketed(f, cs, w)
        b = _bucketed(np.ascontiguousarray(f[:, perm]), cs,
                      np.ascontiguousarray(w[:, perm]))
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])

    check()
