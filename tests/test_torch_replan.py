"""The rolling replay, end to end: the PyTorch port (on the CPU, so the
sweep runs its plain version) against the JAX package on one fleet.

4 pools x 20 weeks of the JAX package's synthetic demand, short-term
options so tranches roll off inside the window, ``compare=True``.

* quantile solver: total, one-shot and hindsight costs within rel 1e-4,
  ``active`` and ``targets`` within rtol 1e-3 / atol 1e-2 — the reference's
  own scan-vs-loop bounds (tests/test_replan.py);
* grid solver: targets within one grid cell of that week's forecast,
  max(yhat)/(G-1), since thresholds snap to cell edges; totals within
  rel 1e-3.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import api as japi  # noqa: E402
from repro.core import portfolio as jpf  # noqa: E402
from repro.core import replan as jrp  # noqa: E402
from repro.data import traces as jtr  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import api as tapi  # noqa: E402
from repro_torch.core import forecast as tfc  # noqa: E402
from repro_torch.core import replan as trp  # noqa: E402

WK = 168
NUM_GRID = 128
KW = dict(cadence_weeks=1, start_weeks=6, horizon_weeks=3,
          term_weighting=1.0, compare=True)


@pytest.fixture(scope="module", autouse=True)
def _full_f32_matmuls():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_float32_matmul_precision(prev)


def _short_options():
    """Short-term per-cloud SKUs so a 20-week replay sees roll-offs."""
    out = []
    for cloud in ("aws", "azure", "gcp"):
        out.append(jpf.PurchaseOption(f"{cloud}/short/4w", cloud, 0.9, 4))
        out.append(jpf.PurchaseOption(f"{cloud}/long/12w", cloud, 0.75, 12))
    return out


@pytest.fixture(scope="module")
def fleet():
    jpools = jtr.synthetic_pool_set(num_pools=4, num_hours=20 * WK)
    jopts = _short_options()
    return (jpools, jopts, convert.pool_set_from_reference(jpools),
            convert.options_from_reference(jopts))


@pytest.fixture(scope="module")
def reports(fleet):
    jpools, jopts, tpools, topts = fleet
    out = {}
    for solver in ("quantile", "grid"):
        kw = dict(KW, solver=solver, num_grid=NUM_GRID)
        out[solver] = (
            jrp.replan_fleet_pools(jpools, jopts, **kw),
            trp.replan_fleet_pools(tpools, topts, device="cpu", **kw),
        )
    return out


COSTS = ("total_cost", "one_shot_cost", "hindsight_cost")


@pytest.mark.parametrize("field", COSTS)
def test_quantile_costs_match(reports, field):
    jrep, trep = reports["quantile"]
    assert getattr(trep, field) == pytest.approx(getattr(jrep, field),
                                                 rel=1e-4)


@pytest.mark.parametrize("field", ["active", "targets", "increments"])
def test_quantile_stacks_match(reports, field):
    jrep, trep = reports["quantile"]
    np.testing.assert_allclose(getattr(trep, field), getattr(jrep, field),
                               rtol=1e-3, atol=1e-2)


def test_quantile_weekly_bills_match(reports):
    jrep, trep = reports["quantile"]
    np.testing.assert_allclose(trep.committed_cost, jrep.committed_cost,
                               rtol=1e-3)
    np.testing.assert_allclose(trep.weekly_cost, jrep.weekly_cost,
                               rtol=1e-3)
    np.testing.assert_allclose(trep.hindsight_widths, jrep.hindsight_widths,
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(trep.weeks, jrep.weeks)


def _cells(tpools, rep):
    """(S, P) grid-cell width of every replayed week's forecast."""
    demand = torch.from_numpy(tpools.demand)
    state = tfc.prefix_fit_state(
        demand, tfc.ForecastConfig(), horizon_hours=rep.horizon_weeks * WK,
        min_prefix_hours=rep.start_weeks * WK)
    return np.stack([
        (tfc.predict_from_beta(state, tfc.solve_prefix(state, int(w)),
                               int(w) * WK, rep.horizon_weeks * WK)
         .amax(-1) / (NUM_GRID - 1)).numpy()
        for w in rep.weeks
    ])


def test_grid_targets_within_one_cell(fleet, reports):
    jrep, trep = reports["grid"]
    cells = _cells(fleet[2], trep)
    diff = np.abs(trep.targets - jrep.targets)
    assert (diff <= cells[:, :, None] + 1e-4).all()


@pytest.mark.parametrize("field", COSTS)
def test_grid_costs_match(reports, field):
    jrep, trep = reports["grid"]
    assert getattr(trep, field) == pytest.approx(getattr(jrep, field),
                                                 rel=1e-3)


def test_grid_close_to_quantile(reports):
    """The reference's own contract (tests/test_replan.py), in the port."""
    q, g = reports["quantile"][1], reports["grid"][1]
    assert g.total_cost == pytest.approx(q.total_cost, rel=0.02)


@pytest.mark.parametrize("solver", ["quantile", "grid"])
def test_book_matches_carried_stack(reports, solver):
    """The tranche book's live option widths equal the replay's carried
    (P, K) stack at every evaluated week."""
    _, rep = reports[solver]
    k = len(rep.options)
    for i, w in enumerate(rep.weeks):
        np.testing.assert_allclose(
            rep.ladders.option_widths(int(w) * WK, k), rep.active[i],
            rtol=1e-4, atol=1e-4)


def test_ladder_book_equals_per_pool_loop():
    """The fleet book steps all pools at once; each pool's tranches equal
    the per-pool loop's — the port's and the JAX package's — bit for bit."""
    from repro.core import ladder as jld
    from repro_torch.core import ladder as tld

    rng = np.random.default_rng(5)
    targets = np.zeros((6, 30, 4), np.float32)
    targets[:, 3:] = np.cumsum(rng.normal(0.2, 1.0, (6, 27, 4)), 1) + 10
    targets[:, ::4] = 0.0                       # non-decision weeks
    terms = np.array([4, 12, 1, 52]) * WK
    keys = [("aws", "r", f"t{i}") for i in range(6)]
    book = tld.plan_pool_portfolio_purchases(targets, terms, keys)
    for i, lad in enumerate(book.ladders):
        for ref in (tld.plan_portfolio_purchases(targets[i], terms),
                    jld.plan_portfolio_purchases(targets[i], terms)):
            for field in ("start", "term", "amount", "option"):
                np.testing.assert_array_equal(getattr(lad, field),
                                              getattr(ref, field))
    assert sum(len(lad.start) for lad in book.ladders) > 50
    jbook = jld.plan_pool_portfolio_purchases(targets, terms, keys)
    np.testing.assert_array_equal(book.active_level(30 * WK),
                                  jbook.active_level(30 * WK))
    np.testing.assert_array_equal(book.option_widths(17 * WK, 4),
                                  jbook.option_widths(17 * WK, 4))


def test_plan_purchases_and_expirations_equal_reference():
    """The single-option ladder and its expiration profile: host numpy on
    both sides, equal."""
    from repro.core import ladder as jld
    from repro_torch.core import ladder as tld

    targets = np.array([10.0, 12.0, 8.0, 14.0, 14.0, 3.0, 9.5])
    for period, term in ((5, 100), (5, 7), (WK, 3 * WK)):
        got = tld.plan_purchases(targets, period_hours=period,
                                 term_hours=term)
        want = jld.plan_purchases(targets, period_hours=period,
                                  term_hours=term)
        for field in ("start", "term", "amount", "option"):
            np.testing.assert_array_equal(getattr(got, field),
                                          getattr(want, field))
        n = len(targets) * period + term
        np.testing.assert_array_equal(tld.expiration_profile(got, n),
                                      jld.expiration_profile(want, n))
    more = tld.plan_purchases(targets[:2], existing=got)
    np.testing.assert_array_equal(
        more.amount, jld.plan_purchases(targets[:2], existing=want).amount)


@pytest.mark.parametrize("a", [2.1, 1.6])
def test_ladder_vs_flat_matches_reference(a):
    """Fig 9: flat level and both spends within rel 1e-5 (float32 sums in
    other orders), the weekly costs one evaluation over (W, 168) rows."""
    from repro.core import commitment as jcm
    from repro.core import demand as jdm
    from repro.core import ladder as jld
    from repro_torch.core import ladder as tld

    demand = np.array(jdm.synth_demand(
        WK * 5, jdm.DemandConfig(annual_growth=0.0, noise_sigma=0.0)))
    demand[WK * 2:WK * 3] *= 0.92
    weekly = np.array([float(jcm.optimal_commitment_quantile(
        jnp.asarray(demand[w * WK:(w + 1) * WK]), a)) for w in range(4)])
    want = jld.ladder_vs_flat(demand, weekly, a=a)
    got = tld.ladder_vs_flat(demand, weekly, a=a, device="cpu")
    assert sorted(got) == sorted(want)
    assert got["flat_level"] == want["flat_level"]
    for key in ("flat_spend", "laddered_spend"):
        assert got[key] == pytest.approx(want[key], rel=1e-5), key
    assert got["savings_frac"] == pytest.approx(want["savings_frac"],
                                                abs=1e-5)
    assert 0.0 < got["savings_frac"] < 0.10
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            tld.ladder_vs_flat(demand, weekly, a=a)


def test_tranches_roll_off(reports):
    """With term-weighted lines the 4-week SKUs are bought, and some of
    them expire inside the window (the stack drops without a sale)."""
    _, rep = reports["quantile"]
    short = [k for k, o in enumerate(rep.options) if o.term_weeks == 4]
    assert rep.increments[:, :, short].sum() > 0
    lad = rep.ladders.ladders[0]
    assert (lad.start + lad.term < rep.weeks[-1] * WK).any()
    assert (rep.increments >= 0).all() and (rep.active >= -1e-5).all()


def test_scan_and_loop_backends_agree(fleet):
    _, _, tpools, topts = fleet
    kw = dict(KW, compare=False)
    scan = trp.replan_fleet_pools(tpools, topts, device="cpu",
                                  backend="scan", **kw)
    loop = trp.replan_fleet_pools(tpools, topts, device="cpu",
                                  backend="loop", **kw)
    assert scan.total_cost == pytest.approx(loop.total_cost, rel=1e-4)
    np.testing.assert_allclose(scan.active, loop.active, rtol=1e-3,
                               atol=1e-2)
    np.testing.assert_allclose(scan.committed_cost, loop.committed_cost,
                               rtol=1e-3)


@pytest.mark.parametrize("policy", ["one_shot", "hindsight"])
def test_policies_match(fleet, policy):
    jpools, jopts, tpools, topts = fleet
    kw = dict(KW, compare=False, policy=policy)
    jrep = jrp.replan_fleet_pools(jpools, jopts, **kw)
    trep = trp.replan_fleet_pools(tpools, topts, device="cpu", **kw)
    assert trep.policy_name == jrep.policy_name == policy
    assert trep.total_cost == pytest.approx(jrep.total_cost, rel=1e-4)
    np.testing.assert_array_equal(trep.decision_mask, jrep.decision_mask)


def test_entry_point_equals_replan(fleet, reports):
    _, _, tpools, topts = fleet
    req = tapi.PlanRequest(
        pools=tpools, options=topts, mode="rolling", horizon_weeks=3,
        term_weighting=1.0,
        rolling=tapi.RollingConfig(start_weeks=6, solver="grid",
                                   num_grid=NUM_GRID),
    )
    rep = tapi.plan(req, device="cpu")
    want = reports["grid"][1]
    assert rep.total_cost == want.total_cost
    assert rep.one_shot_cost == want.one_shot_cost
    assert rep.hindsight_cost == want.hindsight_cost
    np.testing.assert_array_equal(rep.targets, want.targets)


def test_summary_matches_reference(reports):
    jrep, trep = reports["quantile"]
    js, ts = jrep.summary(), trep.summary()
    assert sorted(ts) == sorted(js)
    for key, val in js.items():
        assert ts[key] == pytest.approx(val, rel=1e-4), key


def test_request_fields_match_reference():
    """A request spells the same in both packages."""
    import dataclasses
    names = lambda cls: [f.name for f in dataclasses.fields(cls)]  # noqa: E731
    assert names(tapi.PlanRequest) == names(japi.PlanRequest)
    assert names(tapi.RollingConfig) == names(japi.RollingConfig)
    assert tapi.RollingConfig() == tapi.RollingConfig(**{
        k: v for k, v in dataclasses.asdict(japi.RollingConfig()).items()})


@pytest.mark.parametrize("kw", [
    {"spot": True}, {"migration": True}, {"convertible": True},
    {"scenarios": 2}, {"telemetry": True}, {"irls_carry": True},
    {"cadence": "breach"}, {"policy": "deterministic_hedge"},
    {"policy": "randomized_hedge"},
])
def test_unported_keywords_raise(fleet, kw):
    _, _, tpools, topts = fleet
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        trp.replan_fleet_pools(tpools, topts, device="cpu", **kw)


def test_unported_modes_raise_on_plan(fleet):
    tpools = fleet[2]
    for kw, item in (({"spot": True}, "item 10"),
                     ({"migration": True}, "item 11"),
                     ({"convertible": True}, "item 11")):
        with pytest.raises(NotImplementedError, match=item):
            tapi.plan(tapi.PlanRequest(pools=tpools, **kw), device="cpu")
    req = tapi.PlanRequest(pools=tpools, mode="rolling",
                           rolling=tapi.RollingConfig(cadence="breach"))
    with pytest.raises(NotImplementedError, match="breach"):
        tapi.plan(req, device="cpu")
    with pytest.raises(NotImplementedError, match="spot"):
        tapi.plan(tapi.PlanRequest(pools=tpools, mode="rolling", spot=True),
                  device="cpu")


def test_no_silent_cpu(fleet):
    """Without a card, no device means an error that names device="cpu"."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    tpools = fleet[2]
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tapi.plan(tapi.PlanRequest(pools=tpools, mode="rolling"))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        trp.replan_fleet_pools(tpools)


def test_validation(fleet):
    tpools = fleet[2]
    with pytest.raises(ValueError, match="cadence"):
        trp.replan_fleet_pools(tpools, cadence_weeks=0, device="cpu")
    with pytest.raises(ValueError, match="start_weeks"):
        trp.replan_fleet_pools(tpools, start_weeks=20, device="cpu")
    with pytest.raises(ValueError, match="solver"):
        tapi.RollingConfig(solver="golden")
    with pytest.raises(ValueError, match="rolling"):
        tapi.PlanRequest(pools=tpools, rolling=tapi.RollingConfig(
            solver="grid"))
