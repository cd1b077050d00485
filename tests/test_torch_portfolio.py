"""The PyTorch port's portfolio solvers and Algorithm 1 helpers against the
JAX package's.

Cost lines, fractiles and the prefix-quantile / monotone-stack steps are
exact; the exact stack solver matches to rel 1e-5 (float32 reductions in
different orders); the grid solver's thresholds land on grid-cell edges,
so they are held to one cell, max(f)/(G-1).  The tie cases pin the
results of the stable sorts (``jnp.argsort`` is stable, ``torch.argsort``
only with ``stable=True``).  Torch's CPU sorts happen to be stable either
way, so chip_smoke.py repeats these cases on the card, where they are not.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.capacity import pricing as jpricing  # noqa: E402
from repro.core import planner as jpl  # noqa: E402
from repro.core import portfolio as jpf  # noqa: E402
from repro.core import spot as jsp  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.capacity import pricing as tpricing  # noqa: E402
from repro_torch.core import planner as tpl  # noqa: E402
from repro_torch.core import portfolio as tpf  # noqa: E402

OD = jpricing.on_demand_premium()
CLOUDS = ("aws", "azure", "gcp", "gcp", "aws", "azure")


def _demand(p, t, seed):
    return np.random.default_rng(seed).gamma(2, 50, (p, t)).astype(
        np.float32)


def test_pricing_copy_matches_reference():
    assert [(p.cloud, p.family, p.discount_1y, p.discount_3y)
            for p in tpricing.SAVINGS_PLANS] == [
        (p.cloud, p.family, p.discount_1y, p.discount_3y)
        for p in jpricing.SAVINGS_PLANS]
    assert tpricing.on_demand_premium() == jpricing.on_demand_premium()
    assert tpricing.mean_discount_3y() == jpricing.mean_discount_3y()
    tpricing.validate_tables()


def test_options_from_pricing_equal():
    got = tpf.options_from_pricing()
    want = jpf.options_from_pricing()
    assert [(o.name, o.cloud, o.rate, o.term_weeks) for o in got] == [
        (o.name, o.cloud, o.rate, o.term_weeks) for o in want]
    assert got == convert.options_from_reference(want)
    sub = tpf.options_from_pricing(terms=("3y",), clouds=("gcp",))
    assert [o.name for o in sub] == [
        o.name for o in jpf.options_from_pricing(terms=("3y",),
                                                 clouds=("gcp",))]


@pytest.mark.parametrize("tw", [0.0, 0.5, 1.0])
def test_pool_option_lines_and_fractiles_equal(tw):
    opts_j = jpf.options_from_pricing()
    opts_t = convert.options_from_reference(opts_j)
    al_j, be_j, av_j = jpf.pool_option_lines(
        opts_j, CLOUDS, term_weighting=tw, od_rate=OD)
    al_t, be_t, av_t = tpf.pool_option_lines(
        opts_t, CLOUDS, term_weighting=tw, od_rate=OD)
    np.testing.assert_array_equal(al_t.numpy(), np.asarray(al_j))
    np.testing.assert_array_equal(be_t.numpy(), np.asarray(be_j))
    np.testing.assert_array_equal(av_t, av_j)
    qs_j = jax.vmap(lambda a, b: jpf.handover_fractiles(a, b, od_rate=OD))(
        al_j, be_j)
    np.testing.assert_array_equal(
        tpf.handover_fractiles(al_t, be_t, od_rate=OD).numpy(),
        np.asarray(qs_j))


def _lines(tw):
    opts = jpf.options_from_pricing()
    al, be = jpf.option_lines(opts, term_weighting=tw)
    return (al, be), (torch.tensor(np.asarray(al)),
                      torch.tensor(np.asarray(be)))


def _assert_plan_close(got, want, rtol):
    for field in ("levels", "widths", "total", "cost"):
        np.testing.assert_allclose(
            getattr(got, field).numpy(), np.asarray(getattr(want, field)),
            rtol=rtol, atol=1e-3, err_msg=field)


@pytest.mark.parametrize("tw", [0.0, 1.0])
def test_optimal_portfolio_stack_shared_lines(tw):
    f = _demand(6, 700, seed=11)
    (al_j, be_j), (al_t, be_t) = _lines(tw)
    want = jax.vmap(lambda x: jpf.optimal_portfolio_stack(
        x, al_j, be_j, od_rate=OD))(jnp.asarray(f))
    got = tpf.optimal_portfolio_stack(torch.from_numpy(f), al_t, be_t,
                                      od_rate=OD)
    _assert_plan_close(got, want, rtol=1e-5)


def test_optimal_portfolio_stack_per_pool_lines():
    """The hindsight baseline's shape: one row of lines per pool."""
    f = _demand(6, 500, seed=12)
    opts = jpf.options_from_pricing()
    al_j, be_j, _ = jpf.pool_option_lines(opts, CLOUDS, od_rate=OD)
    want = jax.vmap(lambda x, a, b: jpf.optimal_portfolio_stack(
        x, a, b, od_rate=OD))(jnp.asarray(f), al_j, be_j)
    got = tpf.optimal_portfolio_stack(
        torch.from_numpy(f), torch.tensor(np.asarray(al_j)),
        torch.tensor(np.asarray(be_j)), od_rate=OD)
    _assert_plan_close(got, want, rtol=1e-5)


@pytest.mark.parametrize("weights", [False, True])
def test_optimal_portfolio_grid_within_one_cell(weights):
    p, t, g = 8, 504, 128
    f = _demand(p, t, seed=21)
    w = None
    if weights:
        ends = np.repeat(np.arange(1, 4) * 168, 3)[:p, None]
        w = (np.arange(t)[None, :] < ends).astype(np.float32)
    (al_j, be_j), (al_t, be_t) = _lines(1.0)
    want = jpf.optimal_portfolio_grid(
        jnp.asarray(f), al_j, be_j, od_rate=OD, num_grid=g,
        weights=None if w is None else jnp.asarray(w))
    got = tpf.optimal_portfolio_grid(
        torch.from_numpy(f), al_t, be_t, od_rate=OD, num_grid=g,
        weights=None if w is None else torch.from_numpy(w))
    cell = f.max(-1, keepdims=True) / (g - 1)
    for field in ("levels", "widths"):
        diff = np.abs(getattr(got, field).numpy()
                      - np.asarray(getattr(want, field)))
        assert (diff <= cell + 1e-4).all(), field
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(want.cost),
                               rtol=1e-4)


def test_grid_solver_batched_equals_looped_bit_for_bit():
    f = _demand(5, 300, seed=5)
    _, (al_t, be_t) = _lines(1.0)
    batch = tpf.optimal_portfolio_grid(torch.from_numpy(f), al_t, be_t,
                                       od_rate=OD, num_grid=64)
    for i in range(5):
        solo = tpf.optimal_portfolio_grid(torch.from_numpy(f[i]), al_t,
                                          be_t, od_rate=OD, num_grid=64)
        for field in ("widths", "levels", "total", "cost"):
            assert torch.equal(getattr(batch, field)[i],
                               getattr(solo, field)), (i, field)


def test_portfolio_cost_matches():
    f = _demand(3, 400, seed=8)
    levels = np.sort(np.random.default_rng(9).uniform(
        0, 200, (3, 16)).astype(np.float32), axis=-1)
    (al_j, be_j), (al_t, be_t) = _lines(0.0)
    want = jpf.portfolio_cost(jnp.asarray(f), jnp.asarray(levels), al_j,
                              be_j, od_rate=OD)
    got = tpf.portfolio_cost(torch.from_numpy(f), torch.from_numpy(levels),
                             al_t, be_t, od_rate=OD)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_stack_heights_ties_exact():
    """Options off the envelope tie at the sentinel and keep input order."""
    has = np.array([[True, False, True, False, True, False]] * 2)
    lo = np.array([[7, 9, 2, 9, 2, 0], [1, 1, 1, 4, 4, 4]])
    widths = np.array([[1.5, 0.0, 2.5, 0.0, 4.0, 0.0],
                       [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]], np.float32)
    want = jpf._stack_heights(jnp.asarray(has), jnp.asarray(lo),
                              jnp.asarray(widths), 10)
    got = tpf._stack_heights(torch.from_numpy(has), torch.from_numpy(lo),
                             torch.from_numpy(widths), 10)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _tied_forecast(p, h, seed):
    """Forecast rows full of exact ties: values on a coarse lattice."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 12, (p, h)) * 2.5 + 50.0).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_prefix_weighted_quantiles_ties_exact(seed):
    yhat = _tied_forecast(4, 3 * 168, seed)
    w_hours = np.arange(1, 4) * 168
    qs = np.array([[0.0, 0.3, 0.55, 0.55, 1.0, 0.9]] * 4, np.float32)
    qs[1:, 2] = [0.1, 0.7, 0.33]
    want = jax.vmap(lambda y, q: jpl._prefix_weighted_quantiles(
        y, jnp.asarray(w_hours), q))(jnp.asarray(yhat), jnp.asarray(qs))
    got = tpl._prefix_weighted_quantiles(
        torch.from_numpy(yhat), torch.from_numpy(w_hours),
        torch.from_numpy(qs))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_monotone_stack_ties_exact():
    """Off-envelope options (q = 0) tie at an ``inf`` depth; tied fractiles
    and tied per-option minima must resolve as the reference's."""
    rng = np.random.default_rng(3)
    per_h = (rng.integers(0, 5, (3, 8, 6)) * 10.0 + 20.0).astype(np.float32)
    qs = np.array([[0.0, 0.4, 0.4, 0.0, 0.8, 0.2],
                   [0.5, 0.0, 0.5, 0.5, 0.0, 0.0],
                   [0.3, 0.3, 0.3, 0.3, 0.3, 0.3]], np.float32)
    terms = np.array([4, 52, 2, 156, 8, 1])
    want_w, want_t = jax.vmap(lambda ph, q: jpl._monotone_stack(
        ph, q, jnp.asarray(terms), 8))(jnp.asarray(per_h), jnp.asarray(qs))
    got_w, got_t = tpl._monotone_stack(
        torch.from_numpy(per_h), torch.from_numpy(qs),
        torch.from_numpy(terms), 8)
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))


# Real-dollar spend (``portfolio_spend``): committed dollars equal (float64
# host arithmetic on the same float32 widths), the float32 over-integrals
# and the dollars built on them within rel 1e-6 (sums in different orders).

@pytest.mark.parametrize("kw", [
    {},
    {"level_offset": 7.5},
    {"spot_rate": 0.6, "spot_floor": 150.0},
    {"spot_rate": 0.6, "spot_floor": float("inf")},
    {"spot_rate": 0.6, "spot_floor": 10.0},
])
def test_portfolio_spend_matches(kw):
    opts = jpf.options_from_pricing()[:4]
    f = _demand(1, 500, 9)[0]
    widths = np.asarray([30.0, 0.0, 25.5, 12.25], np.float32)
    want = jpf.portfolio_spend(jnp.asarray(f), widths, opts, od_rate=OD,
                               **kw)
    got = tpf.portfolio_spend(torch.from_numpy(f), widths,
                              convert.options_from_reference(opts),
                              od_rate=OD, **kw)
    np.testing.assert_array_equal(got.committed, want.committed)
    for field in ("on_demand", "total", "all_on_demand", "spot",
                  "spot_chip_hours"):
        assert getattr(got, field) == pytest.approx(
            getattr(want, field), rel=1e-6, abs=1e-9), field
    # 1 - total / all_on_demand: its absolute error is the ratio's relative
    assert got.savings_vs_on_demand == pytest.approx(
        want.savings_vs_on_demand, abs=1e-6)


def test_portfolio_spend_of_an_empty_window():
    opts = convert.options_from_reference(jpf.options_from_pricing()[:2])
    got = tpf.portfolio_spend(torch.zeros(48), np.ones(2, np.float32), opts)
    assert got.all_on_demand == 0.0 and got.on_demand == 0.0
    assert got.savings_vs_on_demand == 0.0
    assert got.total == pytest.approx(float(got.committed.sum()))


def test_portfolio_spends_is_a_loop_of_portfolio_spend():
    opts = convert.options_from_reference(jpf.options_from_pricing()[:3])
    f = torch.from_numpy(_demand(5, 300, 2))
    widths = torch.from_numpy(
        np.random.default_rng(4).uniform(0, 40, (5, 3)).astype(np.float32))
    rate = torch.tensor([0.5, 0.6, 0.7, 0.8, 0.9], dtype=torch.float64)
    floor = torch.tensor([200.0, 120.0, 90.0, 1e9, 0.0])
    batch = tpf.portfolio_spends(f, widths, opts, od_rate=OD,
                                 spot_rate=rate, spot_floor=floor)
    for i, spend in enumerate(batch):
        solo = tpf.portfolio_spend(f[i], widths[i], opts, od_rate=OD,
                                   spot_rate=float(rate[i]),
                                   spot_floor=float(floor[i]))
        np.testing.assert_array_equal(solo.committed, spend.committed)
        for field in ("on_demand", "total", "spot", "spot_chip_hours"):
            assert getattr(solo, field) == pytest.approx(
                getattr(spend, field), rel=1e-6, abs=1e-9), field


# The spot band in both solvers, on the inputs of the reference's
# tests/test_spot.py::TestStackSolverSpot (gamma demand, seed 7, 4 x 600,
# Table-2 lines at term_weighting 1).  The exact solver's floor is a
# gather into sorted demand and its volume bound a suffix sum: widths,
# levels, totals and floors equal the reference's, costs and spot
# fractions within rel 1e-5 (float32 sums in another order).  The grid
# solver's cells come from the sweep, which sums in another order too.
SPOT_CASES = {
    "rate1_cap03": (1.0, 0.3),
    "cap0": (1.0, 0.0),
    "od_rate": (2.1, 1.0),
    "above_od": (2.5, 1.0),
    "idle_heavy": ("max_alpha_x1.3", 1.0),
    "pool_lines": ("lines", "lines"),
}


def _spot_inputs(case):
    f = np.random.default_rng(7).gamma(2.0, 50.0, (4, 600)).astype(
        np.float32)
    (al_j, be_j), (al_t, be_t) = _lines(1.0)
    rate, cap = SPOT_CASES[case]
    if rate == "lines":
        lines = jsp.pool_spot_lines(("aws", "azure", "gcp", "aws"),
                                    od_rate=2.1)
        rate, cap = np.asarray(lines.rate), np.asarray(lines.cap)
    elif rate == "max_alpha_x1.3":
        rate = float(jnp.max(al_j)) * 1.3
    rate_j = jnp.broadcast_to(jnp.asarray(rate, jnp.float32), (4,))
    cap_j = jnp.broadcast_to(jnp.asarray(cap, jnp.float32), (4,))
    return f, (al_j, be_j, rate_j, cap_j), (
        al_t, be_t, torch.tensor(np.asarray(rate_j)),
        torch.tensor(np.asarray(cap_j)))


def _assert_spot_plan_close(got, want, rtol):
    for field in ("levels", "widths", "total", "spot_floor"):
        np.testing.assert_allclose(
            getattr(got, field).numpy(), np.asarray(getattr(want, field)),
            rtol=rtol, atol=1e-3, err_msg=field)
    for field in ("cost", "spot_frac"):
        np.testing.assert_allclose(
            getattr(got, field).numpy(), np.asarray(getattr(want, field)),
            rtol=1e-5, atol=1e-6, err_msg=field)


@pytest.mark.parametrize("case", sorted(SPOT_CASES))
def test_stack_solver_with_spot(case):
    f, (al_j, be_j, r_j, c_j), (al_t, be_t, r_t, c_t) = _spot_inputs(case)
    want = jax.vmap(lambda x, r, c: jpf.optimal_portfolio_stack(
        x, al_j, be_j, spot_rate=r, spot_cap=c))(jnp.asarray(f), r_j, c_j)
    got = tpf.optimal_portfolio_stack(torch.from_numpy(f), al_t, be_t,
                                      spot_rate=r_t, spot_cap=c_t)
    _assert_spot_plan_close(got, want, rtol=1e-6)


@pytest.mark.parametrize("case", sorted(SPOT_CASES))
def test_grid_solver_with_spot(case):
    f, (al_j, be_j, r_j, c_j), (al_t, be_t, r_t, c_t) = _spot_inputs(case)
    want = jpf.optimal_portfolio_grid(jnp.asarray(f), al_j, be_j,
                                      num_grid=512, spot_rate=r_j,
                                      spot_cap=c_j)
    got = tpf.optimal_portfolio_grid(torch.from_numpy(f), al_t, be_t,
                                     num_grid=512, spot_rate=r_t,
                                     spot_cap=c_t)
    _assert_spot_plan_close(got, want, rtol=1e-6)


def test_spot_cap_zero_and_none_leave_the_solvers_unchanged():
    """cap 0 gives the spot-free stack bit for bit (the reference's
    test_cap_zero_is_bit_identical_to_base); spot_rate=None is the
    spot-free program in both solvers."""
    f = torch.from_numpy(_spot_inputs("cap0")[0])
    _, (al_t, be_t) = _lines(1.0)
    base = tpf.optimal_portfolio_stack(f, al_t, be_t)
    capped = tpf.optimal_portfolio_stack(f, al_t, be_t, spot_rate=1.0,
                                         spot_cap=0.0)
    assert torch.equal(capped.cost, base.cost)
    assert torch.equal(capped.widths, base.widths)
    assert float(capped.spot_frac.abs().max()) == 0.0
    assert base.spot_floor is None and base.spot_frac is None
    a = tpf.optimal_portfolio_grid(f, al_t, be_t, num_grid=64)
    b = tpf.optimal_portfolio_grid(f, al_t, be_t, num_grid=64,
                                   spot_rate=None)
    assert torch.equal(a.cost, b.cost) and b.spot_floor is None


def test_one_row_solves_with_spot_squeeze():
    f = torch.from_numpy(_spot_inputs("rate1_cap03")[0])
    _, (al_t, be_t) = _lines(1.0)
    for solve in (tpf.optimal_portfolio_stack, tpf.optimal_portfolio_grid):
        batch = solve(f, al_t, be_t, spot_rate=1.0, spot_cap=0.3)
        one = solve(f[1], al_t, be_t, spot_rate=1.0, spot_cap=0.3)
        assert one.spot_floor.dim() == 0 and one.widths.dim() == 1
        torch.testing.assert_close(one.spot_floor, batch.spot_floor[1])
        torch.testing.assert_close(one.spot_frac, batch.spot_frac[1])


# The convertible band's helpers (convertible=): the SKUs, the argument's
# resolution, the cloud set-up, the truncation below the pinned stack and
# the allocation onto a cloud's pools, against the reference.  Elementwise
# float32 throughout: rtol 1e-6; the allocation's three rounds of (C, P)
# products at rtol 1e-5.
CONV_CLOUDS = ("aws", "gcp", "aws", "azure", "gcp", "aws")


@pytest.mark.parametrize("clouds", [None, ["gcp"], ["azure", "aws"]])
@pytest.mark.parametrize("terms", [("1y", "3y"), ("3y",)])
def test_convertible_options_equal_reference(clouds, terms):
    want = jpf.convertible_options_from_pricing(clouds, terms=terms)
    got = tpf.convertible_options_from_pricing(clouds, terms=terms)
    assert convert.options_from_reference(want) == got
    assert all(o.convertible for o in got)
    std = tpf.options_from_pricing(clouds=clouds)
    for o in got:
        same = [s.rate for s in std
                if s.cloud == o.cloud and s.term_weeks == o.term_weeks]
        assert o.rate > sum(same) / len(same)   # flexibility is not free


def test_resolve_convertible_variants():
    assert tpf.resolve_convertible(None, CONV_CLOUDS) is None
    assert tpf.resolve_convertible(False, CONV_CLOUDS) is None
    got = tpf.resolve_convertible(True, CONV_CLOUDS)
    want = jpf.resolve_convertible(True, CONV_CLOUDS)
    assert got == convert.options_from_reference(want)
    assert tpf.resolve_convertible(got, CONV_CLOUDS) == got
    assert tpf.resolve_convertible([], CONV_CLOUDS) is None
    with pytest.raises(TypeError, match="convertible"):
        tpf.resolve_convertible(tpf.options_from_pricing(), CONV_CLOUDS)


@pytest.mark.parametrize("term_weighting", [0.0, 1.0])
def test_convertible_cloud_setup_equals_reference(term_weighting):
    jopts = jpf.convertible_options_from_pricing()
    want = jpf.convertible_cloud_setup(jopts, CONV_CLOUDS,
                                       term_weighting=term_weighting,
                                       od_rate=OD)
    got = tpf.convertible_cloud_setup(
        convert.options_from_reference(jopts), CONV_CLOUDS,
        term_weighting=term_weighting, od_rate=OD, device="cpu")
    assert got[0] == want[0]
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


def test_truncate_convertible_stack_equals_reference():
    rng = np.random.default_rng(3)
    tops = np.sort(rng.uniform(0, 50, (3, 4)), -1).astype(np.float32)
    widths = rng.uniform(0, 10, (3, 4)).astype(np.float32)
    pinned = np.asarray([0.0, 30.0, 80.0], np.float32)
    want = jpf.truncate_convertible_stack(*map(jnp.asarray, (tops, widths,
                                                             pinned)))
    got = tpf.truncate_convertible_stack(*map(torch.from_numpy, (
        tops, widths, pinned)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy()[2] == 0).all() and (got.numpy() <= widths).all()


MEMBER = np.asarray([[1.0, 1.0, 0.0], [0.0, 0.0, 1.0]], np.float32)


@pytest.mark.parametrize("width,need", [
    ([12.0, 1.5], [4.0, 20.0, 2.0]),      # scarce: all handed out
    ([30.0, 5.0], [2.0, 20.0, 2.0]),      # surplus: every need met
    ([0.0, 3.0], [0.0, 0.0, 1.0]),        # nothing to give, nothing needed
])
def test_allocate_convertible_equals_reference(width, need):
    width = np.asarray(width, np.float32)
    need = np.asarray(need, np.float32)
    want = np.asarray(jpf.allocate_convertible(
        jnp.asarray(width), jnp.asarray(need), jnp.asarray(MEMBER)))
    got = tpf.allocate_convertible(torch.from_numpy(width),
                                   torch.from_numpy(need),
                                   torch.from_numpy(MEMBER)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert (got <= need + 1e-5).all()
    np.testing.assert_allclose(MEMBER @ got, np.minimum(MEMBER @ need, width),
                               atol=1e-3)


def test_convertible_ladder_book_keys():
    from repro.core import ladder as jld

    from repro_torch.core import ladder as tld
    targets = np.zeros((2, 3, 1), np.float32)
    targets[:, 0, 0] = [5.0, 7.0]
    book = tld.convertible_ladder_book(targets, np.asarray([52 * 168]),
                                       ["aws", "gcp"])
    ref = jld.convertible_ladder_book(targets, np.asarray([52 * 168]),
                                      ["aws", "gcp"])
    assert book.keys == ref.keys == (("aws", "*", "convertible"),
                                     ("gcp", "*", "convertible"))
    np.testing.assert_allclose(book.option_widths(0, 1)[:, 0], [5.0, 7.0])
    for a, b in zip(book.ladders, ref.ladders):
        np.testing.assert_array_equal(a.amount, b.amount)
        np.testing.assert_array_equal(a.start, b.start)
