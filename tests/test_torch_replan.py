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

The spot, migration/convertible and scenario-batched (``scenarios=``)
replays and the hedging policies follow, each section with its fleet and
tolerances.  Within the port, scenario batching is held bit for bit: a
one-scenario batch equals the unbatched replay for every policy, scenario
0 of a batch equals it with every band on, and a chunked batch equals the
unchunked one, under both solvers.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.capacity import generations as jgn  # noqa: E402
from repro.capacity import pricing as jpr  # noqa: E402
from repro.core import api as japi  # noqa: E402
from repro.core import portfolio as jpf  # noqa: E402
from repro.core import policy as jpol  # noqa: E402
from repro.core import replan as jrp  # noqa: E402
from repro.data import scenarios as jsc  # noqa: E402
from repro.data import traces as jtr  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.capacity import generations as tgn  # noqa: E402
from repro_torch.capacity import pricing as tpr  # noqa: E402
from repro_torch.core import api as tapi  # noqa: E402
from repro_torch.core import forecast as tfc  # noqa: E402
from repro_torch.core import migration as tmg  # noqa: E402
from repro_torch.core import policy as tpol  # noqa: E402
from repro_torch.core import replan as trp  # noqa: E402
from repro_torch.data import scenarios as tsc  # noqa: E402

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
    {"telemetry": True}, {"irls_carry": True}, {"cadence": "breach"},
])
def test_unported_keywords_raise(fleet, kw):
    _, _, tpools, topts = fleet
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        trp.replan_fleet_pools(tpools, topts, device="cpu", **kw)


def test_unported_modes_raise_on_plan(fleet):
    tpools = fleet[2]
    for kw, item in (({"telemetry": True}, "item 14"),):
        with pytest.raises(NotImplementedError, match=item):
            tapi.plan(tapi.PlanRequest(pools=tpools, mode="rolling", **kw),
                      device="cpu")
    req = tapi.PlanRequest(pools=tpools, mode="rolling",
                           rolling=tapi.RollingConfig(cadence="breach"))
    with pytest.raises(NotImplementedError, match="breach"):
        tapi.plan(req, device="cpu")


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


# The rolling replay with the spot band (spot=True), on the reference's
# tests/test_spot.py::TestRollingSpot fleet: 3 pools x 30 weeks, cadence 2,
# start 8, horizon 4; both solvers, both backends, compare=True.  Totals
# within rel 1e-3 and the per-week floors and stacks within rtol 1e-3 /
# atol 1e-2, the tolerances above.  Each week's three-way bill (committed,
# on-demand between the stack top and the floor, spot above the floor)
# within rtol 1e-3, or 1e-3 of that week's pool bill: the on-demand band
# between a stack top and a floor can be a few chip-hours, so its
# relative error is large where its dollars are not.
SPOT_KW = dict(cadence_weeks=2, start_weeks=8, horizon_weeks=4,
               compare=True, num_grid=NUM_GRID, spot=True)


@pytest.fixture(scope="module")
def spot_fleet():
    jpools = jtr.synthetic_pool_set(num_pools=3, num_hours=30 * WK)
    return jpools, convert.pool_set_from_reference(jpools)


@pytest.fixture(scope="module", params=[
    ("quantile", "scan"), ("quantile", "loop"), ("grid", "scan"),
    ("grid", "loop")], ids=lambda p: "-".join(p))
def spot_reports(request, spot_fleet):
    jpools, tpools = spot_fleet
    solver, backend = request.param
    kw = dict(SPOT_KW, solver=solver, backend=backend)
    return (jrp.replan_fleet_pools(jpools, **kw),
            trp.replan_fleet_pools(tpools, device="cpu", **kw))


def test_spot_replay_costs_match(spot_reports):
    jrep, trep = spot_reports
    for field in COSTS:
        assert getattr(trep, field) == pytest.approx(
            getattr(jrep, field), rel=1e-3), field
    js, ts = jrep.summary(), trep.summary()
    assert sorted(ts) == sorted(js)
    for key in ("spot_cost", "spot_chip_hours", "total_cost"):
        assert ts[key] == pytest.approx(js[key], rel=1e-3), key


def test_spot_replay_floors_and_three_way_bill(spot_reports):
    jrep, trep = spot_reports
    for field in ("spot_floor", "active", "targets"):
        np.testing.assert_allclose(getattr(trep, field),
                                   getattr(jrep, field), rtol=1e-3,
                                   atol=1e-2, err_msg=field)
    pool_bill = jrep.committed_cost + jrep.on_demand_cost + jrep.spot_cost
    for field in ("committed_cost", "on_demand_cost", "spot_cost",
                  "spot_volume"):
        got, want = getattr(trep, field), getattr(jrep, field)
        assert got.shape == want.shape == jrep.spot_floor.shape
        assert (np.abs(got - want)
                <= 1e-3 * np.abs(want) + 1e-3 * pool_bill).all(), field
    np.testing.assert_allclose(trep.weekly_cost, jrep.weekly_cost,
                               rtol=1e-3)
    np.testing.assert_allclose(trep.spot_lines.rate.numpy(),
                               np.asarray(jrep.spot_lines.rate), atol=1e-6)


def test_spot_replay_accounting(spot_fleet, spot_reports):
    """The reference's TestRollingSpot checks, on the port's report: the
    bill adds up, floors sit at or above the stack top, and one week's
    three-way bill re-derived from the reported floor."""
    _, tpools = spot_fleet
    _, rep = spot_reports
    want = float(rep.committed_cost.sum() + rep.on_demand_cost.sum()
                 + rep.spot_cost.sum())
    assert rep.total_cost == pytest.approx(want, rel=1e-6)
    assert rep.weekly_cost.sum() == pytest.approx(want, rel=1e-6)
    assert (rep.spot_floor >= rep.active.sum(-1) - 1e-4).all()
    i = len(rep.weeks) // 2
    w = int(rep.weeks[i])
    d = tpools.demand[:, w * WK:(w + 1) * WK]
    level = rep.active[i].sum(-1)[:, None]
    fl = rep.spot_floor[i][:, None]
    od = tpr.on_demand_premium()
    np.testing.assert_allclose(
        rep.on_demand_cost[i],
        od * np.maximum(np.minimum(d, fl) - level, 0.0).sum(-1), rtol=1e-4)
    np.testing.assert_allclose(
        rep.spot_cost[i],
        rep.spot_lines.rate.numpy() * np.maximum(d - fl, 0.0).sum(-1),
        rtol=1e-4)


def test_spot_lowers_the_rolling_bill(spot_fleet):
    _, tpools = spot_fleet
    kw = dict(SPOT_KW, compare=False)
    spot = trp.replan_fleet_pools(tpools, device="cpu", **kw)
    kw.pop("spot")
    base = trp.replan_fleet_pools(tpools, device="cpu", **kw)
    assert spot.total_cost < base.total_cost
    assert base.spot_floor is None and base.spot_ladders is None
    with pytest.raises(ValueError, match="does not forecast"):
        trp.replan_fleet_pools(tpools, device="cpu", policy="hindsight",
                               **dict(SPOT_KW, compare=False))


def test_spot_ladder_is_one_week_tranches(spot_fleet, spot_reports):
    """Every spot tranche lasts exactly one week, sized at that week's
    realized peak spot usage (demand above the week's floor)."""
    _, tpools = spot_fleet
    _, rep = spot_reports
    total = 0
    for p, lad in enumerate(rep.spot_ladders.ladders):
        total += len(lad.amount)
        assert (lad.term == WK).all()
        for start, amount in zip(lad.start, lad.amount):
            w = start // WK
            i = int(w - rep.start_weeks)
            d = tpools.demand[p, w * WK:(w + 1) * WK]
            peak = np.maximum(d - rep.spot_floor[i, p], 0.0).max()
            assert amount == pytest.approx(float(peak), rel=1e-5)
    assert total > 0


def test_spot_ladder_helpers_equal_reference():
    from repro.core import ladder as jld

    from repro_torch.core import ladder as tld
    peaks = np.array([5.0, 0.0, 3.0, 1e-12, 7.25])
    want = jld.weekly_spot_ladder(peaks, start_week=10)
    got = tld.weekly_spot_ladder(peaks, start_week=10)
    for field in ("start", "term", "amount", "option"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field))
    assert got.active_width(10 * WK) == 5.0
    assert got.active_width(11 * WK) == 0.0
    assert got.active_width(12 * WK + 167) == 3.0
    keys = [("aws", "r", "a"), ("gcp", "r", "b")]
    grid = np.abs(np.random.default_rng(1).normal(size=(6, 2)))
    book = tld.spot_ladder_book(grid, keys, start_week=3)
    ref = jld.spot_ladder_book(grid, keys, start_week=3)
    assert book.keys == ref.keys
    for a, b in zip(book.ladders, ref.ladders):
        np.testing.assert_array_equal(a.start, b.start)
        np.testing.assert_array_equal(a.amount, b.amount)
    with pytest.raises(ValueError, match="keys"):
        tld.spot_ladder_book(np.zeros((4, 3)), [("aws", "r", "m")])


# The rolling replay with the migration and convertible bands
# (migration=, convertible=True), on the reference's
# tests/test_generations.py::TestRollingMigrationConvertible fleet: 4 pools
# x 30 weeks, seed 3, its planted 2-edge table; cadence 2, start 8,
# horizon 6, compare=True; both solvers, both backends.  Totals within rel
# 1e-3 and the pool and cloud stacks within rtol 1e-3 / atol 1e-2, the
# tolerances above; under the grid solver, targets within one grid cell
# of that week's forecast (pools) or of its cloud totals (clouds).
MIG_PLANT = jgn.MigrationConfig(generations=(
    jpr.Generation("aws", "C6i", "C7i", 8, 12.0, 0.25),
    jpr.Generation("gcp", "N2-Standard", "N4-Standard", 16, 10.0, 0.50),
))
MIG_KW = dict(cadence_weeks=2, start_weeks=8, horizon_weeks=6, compare=True,
              num_grid=NUM_GRID, convertible=True)


@pytest.fixture(scope="module")
def mig_fleet():
    jpools = jtr.synthetic_pool_set(num_pools=4, num_hours=30 * WK, seed=3,
                                    migration=MIG_PLANT)
    return (jpools, convert.pool_set_from_reference(jpools),
            convert.migration_config_from_reference(MIG_PLANT))


@pytest.fixture(scope="module", params=[
    ("quantile", "scan"), ("quantile", "loop"), ("grid", "scan"),
    ("grid", "loop")], ids=lambda p: "-".join(p))
def mig_reports(request, mig_fleet):
    jpools, tpools, tplant = mig_fleet
    solver, backend = request.param
    kw = dict(MIG_KW, solver=solver, backend=backend)
    return (solver,
            jrp.replan_fleet_pools(jpools, migration=MIG_PLANT, **kw),
            trp.replan_fleet_pools(tpools, migration=tplant, device="cpu",
                                   **kw))


def _composed_cells(tpools, tplant, rep):
    """(S, P) and (S, C) grid cells of every replayed week's
    turnover-aware forecast and of its cloud totals, recomputed with the
    port's own pieces."""
    demand = torch.from_numpy(tpools.demand)
    edges = tgn.migration_edges(tpools.keys, tplant, device="cpu")
    state = tfc.prefix_fit_state(
        tmg.transform_for_fit(demand, edges), tfc.ForecastConfig(),
        horizon_hours=rep.horizon_weeks * WK,
        min_prefix_hours=rep.start_weeks * WK)
    share = tmg.share_prefix_state(demand, edges, t_max=state.t_max,
                                   prior_weight=tplant.share_prior_weight)
    member = torch.tensor([[1.0 if c == k[0] else 0.0 for k in rep.keys]
                           for c in rep.conv_clouds])
    pools, clouds = [], []
    for w in map(int, rep.weeks):
        yhat = tfc.predict_from_beta(state, tfc.solve_prefix(state, w),
                                     w * WK, rep.horizon_weeks * WK)
        a, b = tmg.solve_share_prefix(share, w)
        sh = tmg.predict_share(a, b, w * WK + torch.arange(yhat.shape[-1]),
                               share.t_max)
        yhat = tmg.compose_forecast(yhat, sh, edges)
        pools.append((yhat.amax(-1) / (NUM_GRID - 1)).numpy())
        clouds.append(((member @ yhat).amax(-1) / (NUM_GRID - 1)).numpy())
    return np.stack(pools), np.stack(clouds)


def test_migration_replay_costs_match(mig_reports):
    _, jrep, trep = mig_reports
    for field in COSTS:
        assert getattr(trep, field) == pytest.approx(
            getattr(jrep, field), rel=1e-3), field
    js, ts = jrep.summary(), trep.summary()
    assert sorted(ts) == sorted(js)
    for key in ("convertible_cost", "convertible_final_width",
                "total_cost"):
        assert ts[key] == pytest.approx(js[key], rel=1e-3), key
    np.testing.assert_allclose(trep.weekly_cost, jrep.weekly_cost,
                               rtol=1e-3)
    np.testing.assert_allclose(trep.one_shot_weekly_cost,
                               jrep.one_shot_weekly_cost, rtol=1e-3)


def test_migration_replay_stacks_match(mig_fleet, mig_reports):
    solver, jrep, trep = mig_reports
    assert trep.conv_clouds == tuple(jrep.conv_clouds)
    assert trep.conv_options == convert.options_from_reference(
        jrep.conv_options)
    for field in ("src", "dst", "midpoint_hours", "rate_per_hour"):
        np.testing.assert_array_equal(
            getattr(trep.migration_edges, field).numpy(),
            np.asarray(getattr(jrep.migration_edges, field)))
    assert trep.migration_config == mig_fleet[2]
    if solver == "quantile":
        for field in ("active", "targets", "increments"):
            np.testing.assert_allclose(getattr(trep, field),
                                       getattr(jrep, field), rtol=1e-3,
                                       atol=1e-2, err_msg=field)
        # A cloud band is the cloud stack's top above the sum of its pools'
        # stacks, so it moves with their error: 1e-3 of the cloud's pool
        # level, and the allocation 1e-3 of the pool's billed level.
        member = np.asarray([[1.0 if c == k[0] else 0.0 for k in trep.keys]
                             for c in trep.conv_clouds])
        pool_level = jrep.active.sum(-1)                          # (S, P)
        cloud_tol = (1e-3 * pool_level @ member.T + 1e-2)[..., None]
        for field in ("conv_active", "conv_targets", "conv_increments"):
            diff = np.abs(getattr(trep, field) - getattr(jrep, field))
            assert (diff <= cloud_tol).all(), field
        diff = np.abs(trep.conv_alloc - jrep.conv_alloc)
        assert (diff <= 1e-3 * (pool_level + jrep.conv_alloc) + 1e-2).all()
        return
    pool_cells, cloud_cells = _composed_cells(mig_fleet[1], mig_fleet[2],
                                              trep)
    # targets snap to cell edges; a cell's drift with the grid's top is
    # the forecasts' rel 1e-4 times the cell index
    slack = 1.0 + (NUM_GRID - 1) * 1e-4
    diff = np.abs(trep.targets - jrep.targets)
    assert (diff <= pool_cells[:, :, None] * slack + 1e-4).all()
    diff = np.abs(trep.conv_targets - jrep.conv_targets)
    assert (diff <= cloud_cells[:, :, None] * slack + 1e-4).all()


def test_migration_replay_books_reconcile(mig_reports):
    """The acceptance of the reference's TestRollingMigrationConvertible on
    the port's report: the cloud book's live widths equal the carried
    cloud stack every week, the pool book (built from the realized stack,
    since live convertible capacity suppresses standard buys) equals the
    carried pool stack, and the allocation stays inside its cloud."""
    _, _, rep = mig_reports
    member = np.asarray([[1.0 if c == k[0] else 0.0 for k in rep.keys]
                         for c in rep.conv_clouds])
    for i, w in enumerate(rep.weeks):
        np.testing.assert_allclose(
            rep.conv_ladders.option_widths(int(w) * WK,
                                           len(rep.conv_options)),
            rep.conv_active[i], atol=1e-4)
        np.testing.assert_allclose(
            rep.ladders.option_widths(int(w) * WK, len(rep.options)),
            rep.active[i], atol=1e-4)
        assert (member @ rep.conv_alloc[i]
                <= rep.conv_active[i].sum(-1) + 1e-3).all()
    s, c, kc = rep.conv_targets.shape
    assert (s, c, kc) == (len(rep.weeks), len(rep.conv_clouds),
                          len(rep.conv_options))
    assert rep.conv_alloc.shape == rep.committed_cost.shape
    want = float(rep.committed_cost.sum() + rep.on_demand_cost.sum()
                 + rep.conv_committed_cost.sum())
    assert rep.total_cost == pytest.approx(want, rel=1e-6)
    assert rep.weekly_cost.sum() == pytest.approx(want, rel=1e-6)


def test_migration_bands_need_a_forecasting_policy(mig_fleet):
    _, tpools, tplant = mig_fleet
    kw = dict(MIG_KW, compare=False)
    for bands in ({"migration": tplant, "convertible": None},
                  {"convertible": True}):
        with pytest.raises(ValueError, match="does not forecast"):
            trp.replan_fleet_pools(tpools, device="cpu", policy="hindsight",
                                   **dict(kw, **bands))


def test_migration_bands_through_the_request(mig_fleet):
    """api.plan spells the same replay as replan_fleet_pools, and each
    band alone leaves the other's report fields empty."""
    _, tpools, tplant = mig_fleet
    trep = trp.replan_fleet_pools(tpools, migration=tplant, device="cpu",
                                  **dict(MIG_KW, compare=False))
    rolling = tapi.RollingConfig(cadence_weeks=2, start_weeks=8,
                                 num_grid=NUM_GRID, compare=False)
    req = tapi.PlanRequest(pools=tpools, mode="rolling", horizon_weeks=6,
                           migration=tplant, convertible=True,
                           rolling=rolling)
    rep = tapi.plan(req, device="cpu")
    assert rep.total_cost == trep.total_cost
    mig = tapi.plan(dataclasses.replace(req, convertible=None),
                    device="cpu")
    assert mig.conv_active is None and mig.migration_edges is not None
    assert "convertible_cost" not in mig.summary()
    conv = tapi.plan(dataclasses.replace(req, migration=None), device="cpu")
    assert conv.migration_edges is None and conv.conv_active is not None


# tests/test_generations.py::TestTwoTurnoverAcceptance on its fleet (4
# pools x 156 weeks, seed 7, two turnovers), built by the JAX package and
# carried across: the port's migration-aware plan with convertibles is at
# least 5% cheaper than its migration-blind rolling plan.
@pytest.fixture(scope="module")
def acceptance_reports():
    two = jgn.MigrationConfig(generations=(
        jpr.Generation("aws", "C6i", "C7i", 30, 40.0, 0.25),
        jpr.Generation("gcp", "N2-Standard", "N4-Standard", 85, 36.0, 0.50),
    ))
    tpools = convert.pool_set_from_reference(jtr.synthetic_pool_set(
        num_pools=4, num_hours=24 * 7 * 156, seed=7, migration=two))
    kw = dict(cadence_weeks=2, start_weeks=26, horizon_weeks=52,
              compare=False, device="cpu")
    blind = trp.replan_fleet_pools(tpools, **kw)
    aware = trp.replan_fleet_pools(
        tpools, migration=convert.migration_config_from_reference(two),
        convertible=True, **kw)
    return blind, aware


def test_two_turnover_margin_at_least_5pct(acceptance_reports):
    blind, aware = acceptance_reports
    margin = 1.0 - aware.total_cost / blind.total_cost
    assert margin >= 0.05, f"margin {margin:.3f} below 5%"


def test_two_turnover_convertible_bought_and_pinned(acceptance_reports):
    _, aware = acceptance_reports
    assert float(aware.conv_active[-1].sum()) > 1.0
    assert float(aware.conv_alloc.sum()) > 0.0
    assert aware.conv_committed_cost.sum() > 0.0


# Scenario batching (scenarios=), on the reference's tests/test_api.py
# fleet (3 pools x 20 weeks; cadence 2, start 6, horizon 4).  Within the
# port every contract is bit for bit.  Against the reference: targets as
# above (quantile rtol 1e-3 / atol 1e-2; grid within one cell of the
# scenario's own forecast), every per-scenario cost and ratio within rel
# 1e-3 (regret, a difference of two bills, within 1e-3 of the bill),
# hindsight widths within rtol 1e-5 / atol 1e-4.
SCEN_KW = dict(cadence_weeks=2, start_weeks=6, horizon_weeks=4,
               num_grid=NUM_GRID)
SCEN_COSTS = ("scenario_cost", "scenario_one_shot_cost",
              "scenario_hindsight_cost", "scenario_cr")


@pytest.fixture(scope="module")
def scen_fleet():
    jpools = jtr.synthetic_pool_set(num_pools=3, num_hours=20 * WK)
    return jpools, convert.pool_set_from_reference(jpools)


def _same(a, b, name):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                  err_msg=name)


@pytest.mark.parametrize("policy", sorted(tpol.POLICIES))
def test_n1_bit_identical_per_policy(scen_fleet, policy):
    tpools = scen_fleet[1]
    kw = dict(SCEN_KW, policy=policy, compare=False, device="cpu")
    base = trp.replan_fleet_pools(tpools, **kw)
    scen = trp.replan_fleet_pools(tpools, scenarios=1, **kw)
    assert base.total_cost == scen.total_cost
    for name in ("targets", "active", "increments", "committed_cost",
                 "on_demand_cost"):
        _same(getattr(base, name), getattr(scen, name), name)
    assert scen.n_scenarios == 1 and scen.scenario_cost.shape == (1,)
    assert float(scen.scenario_cost[0]) == base.total_cost
    assert base.n_scenarios == 1 and base.scenario_cost is None


@pytest.mark.parametrize("solver", ["quantile", "grid"])
def test_scenario0_anchors_realized_all_bands(mig_fleet, solver):
    """At N = 3 with spot, migration and convertible on, scenario 0 is the
    unbatched replay bit for bit, baselines included."""
    _, tpools, tplant = mig_fleet
    kw = dict(MIG_KW, solver=solver, spot=True, migration=tplant,
              device="cpu")
    base = trp.replan_fleet_pools(tpools, **kw)
    scen = trp.replan_fleet_pools(
        tpools, scenarios=tsc.ScenarioConfig(n_scenarios=3, family="regime"),
        **kw)
    assert base.migration_edges.num_edges > 0 and scen.n_scenarios == 3
    for name in ("targets", "increments", "active", "committed_cost",
                 "on_demand_cost", "utilization", "spot_floor", "spot_cost",
                 "spot_volume", "conv_targets", "conv_active", "conv_alloc",
                 "conv_committed_cost", "weekly_cost",
                 "one_shot_weekly_cost", "hindsight_weekly_cost"):
        _same(getattr(scen, name)[:, 0], getattr(base, name), name)
    _same(scen.hindsight_widths[0], base.hindsight_widths, "hindsight")
    assert float(scen.scenario_cost[0]) == base.total_cost
    assert float(scen.scenario_one_shot_cost[0]) == base.one_shot_cost
    assert float(scen.scenario_hindsight_cost[0]) == base.hindsight_cost
    # the other scenarios are other futures
    assert not np.array_equal(scen.targets[:, 1], base.targets)


@pytest.mark.parametrize("solver", ["quantile", "grid"])
def test_chunked_merge_bit_identical(scen_fleet, solver):
    tpools = scen_fleet[1]
    kw = dict(SCEN_KW, solver=solver, device="cpu")
    full = trp.replan_fleet_pools(
        tpools, scenarios=tsc.ScenarioConfig(n_scenarios=4, family="growth"),
        **kw)
    chunked = trp.replan_fleet_pools(
        tpools, scenarios=tsc.ScenarioConfig(n_scenarios=4, family="growth",
                                             chunk=3), **kw)
    assert chunked.n_scenarios == 4
    for name in ("targets", "active", "committed_cost", "on_demand_cost",
                 "one_shot_weekly_cost", "hindsight_weekly_cost",
                 "hindsight_widths") + SCEN_COSTS:
        _same(getattr(full, name), getattr(chunked, name), name)
    assert full.total_cost == chunked.total_cost
    assert full.one_shot_cost == chunked.one_shot_cost
    assert full.hindsight_cost == chunked.hindsight_cost


def _scenario_cells(tpools, rep):
    """(S, N, P) grid-cell width of every replayed week's forecast of each
    scenario's demand."""
    rows = tsc.scenario_batch(
        tpools.demand, rep.scenario_config, device="cpu").reshape(
            -1, tpools.num_hours)
    state = tfc.prefix_fit_state(
        rows, tfc.ForecastConfig(), horizon_hours=rep.horizon_weeks * WK,
        min_prefix_hours=rep.start_weeks * WK)
    return np.stack([
        (tfc.predict_from_beta(state, tfc.solve_prefix(state, int(w)),
                               int(w) * WK, rep.horizon_weeks * WK)
         .amax(-1) / (NUM_GRID - 1)).numpy()
        for w in rep.weeks
    ]).reshape(len(rep.weeks), rep.n_scenarios, -1)


@pytest.mark.parametrize("solver", ["quantile", "grid"])
def test_batched_replay_matches_reference(scen_fleet, solver):
    jpools, tpools = scen_fleet
    kw = dict(SCEN_KW, solver=solver)
    jrep = jrp.replan_fleet_pools(jpools, scenarios=jsc.ScenarioConfig(
        n_scenarios=3, family="regime", seed=4), **kw)
    trep = trp.replan_fleet_pools(tpools, scenarios=tsc.ScenarioConfig(
        n_scenarios=3, family="regime", seed=4), device="cpu", **kw)
    assert trep.targets.shape == jrep.targets.shape
    if solver == "quantile":
        np.testing.assert_allclose(trep.targets, jrep.targets, rtol=1e-3,
                                   atol=1e-2)
    else:
        cells = _scenario_cells(tpools, trep)[..., None]
        assert (np.abs(trep.targets - jrep.targets) <= cells + 1e-4).all()
    for name in SCEN_COSTS:
        np.testing.assert_allclose(getattr(trep, name), getattr(jrep, name),
                                   rtol=1e-3, err_msg=name)
    # regret is a difference of two bills: held to 1e-3 of the bill
    assert (np.abs(trep.scenario_regret - jrep.scenario_regret)
            <= 1e-3 * jrep.scenario_cost).all()
    for name in ("total_cost", "one_shot_cost", "hindsight_cost"):
        assert getattr(trep, name) == pytest.approx(getattr(jrep, name),
                                                    rel=1e-3), name
    np.testing.assert_allclose(trep.hindsight_widths, jrep.hindsight_widths,
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(trep.weekly_cost, jrep.weekly_cost,
                               rtol=1e-3)


def test_batched_bands_match_reference(mig_fleet):
    """N = 3 with every band on against the reference: costs within rel
    1e-3, pool stacks and floors as above, cloud stacks within 1e-3 of
    the cloud's pool level plus 1e-2 (the convertible band's tolerance)."""
    jpools, tpools, tplant = mig_fleet
    kw = dict(MIG_KW, spot=True, compare=False)
    jrep = jrp.replan_fleet_pools(
        jpools, migration=MIG_PLANT,
        scenarios=jsc.ScenarioConfig(n_scenarios=3, family="scale"), **kw)
    trep = trp.replan_fleet_pools(
        tpools, migration=tplant,
        scenarios=tsc.ScenarioConfig(n_scenarios=3, family="scale"),
        device="cpu", **kw)
    np.testing.assert_allclose(trep.scenario_cost, jrep.scenario_cost,
                               rtol=1e-3)
    for name in ("active", "targets", "spot_floor"):
        np.testing.assert_allclose(getattr(trep, name), getattr(jrep, name),
                                   rtol=1e-3, atol=1e-2, err_msg=name)
    member = np.asarray([[1.0 if c == k[0] else 0.0 for k in trep.keys]
                         for c in trep.conv_clouds])
    pool_level = jrep.active.sum(-1)                        # (S, N, P)
    cloud_tol = (1e-3 * pool_level @ member.T + 1e-2)[..., None]
    for name in ("conv_active", "conv_targets"):
        diff = np.abs(getattr(trep, name) - getattr(jrep, name))
        assert (diff <= cloud_tol).all(), name
    for name in ("src", "dst"):
        _same(getattr(trep.migration_edges, name).numpy(),
              getattr(jrep.migration_edges, name), name)


def test_batched_report_shapes_and_summary(scen_fleet):
    jpools, tpools = scen_fleet
    n = 4
    jrep = jrp.replan_fleet_pools(jpools, scenarios=jsc.ScenarioConfig(
        n_scenarios=n, family="growth"), **SCEN_KW)
    trep = trp.replan_fleet_pools(tpools, scenarios=tsc.ScenarioConfig(
        n_scenarios=n, family="growth"), device="cpu", **SCEN_KW)
    s, p = len(trep.weeks), tpools.num_pools
    assert trep.targets.shape[:3] == (s, n, p)
    assert trep.weekly_cost.shape == (s, n)
    for name in SCEN_COSTS + ("scenario_regret",):
        assert getattr(trep, name).shape == (n,), name
    assert trep.hindsight_widths.shape[0] == n
    assert trep.scenario_family == "growth" and trep.n_scenarios == n
    assert trep.od_rate == pytest.approx(jrep.od_rate)
    assert trep.total_cost == pytest.approx(trep.scenario_cost.mean(),
                                            rel=1e-12)
    js, ts = jrep.summary(), trep.summary()
    assert sorted(ts) == sorted(js)
    for key, val in js.items():
        assert ts[key] == pytest.approx(val, rel=1e-3), key


def test_batched_scan_matches_loop(scen_fleet):
    tpools = scen_fleet[1]
    kw = dict(SCEN_KW, compare=False, device="cpu",
              scenarios=tsc.ScenarioConfig(n_scenarios=3, family="regime"))
    scan = trp.replan_fleet_pools(tpools, backend="scan", **kw)
    loop = trp.replan_fleet_pools(tpools, backend="loop", **kw)
    np.testing.assert_allclose(scan.targets, loop.targets, rtol=1e-3,
                               atol=1e-2)
    np.testing.assert_allclose(scan.scenario_cost, loop.scenario_cost,
                               rtol=1e-4)


def test_scenarios_through_the_request(scen_fleet):
    tpools = scen_fleet[1]
    cfg = tapi.ScenarioConfig(n_scenarios=2, family="burst", seed=1)
    req = tapi.PlanRequest(
        pools=tpools, mode="rolling", horizon_weeks=4, scenarios=cfg,
        rolling=tapi.RollingConfig(cadence_weeks=2, start_weeks=6,
                                   compare=False))
    rep = tapi.plan(req, device="cpu")
    want = trp.replan_fleet_pools(tpools, scenarios=cfg, compare=False,
                                  device="cpu", **dict(SCEN_KW, num_grid=128))
    _same(rep.targets, want.targets, "targets")
    _same(rep.scenario_cost, want.scenario_cost, "scenario_cost")
    assert "ScenarioConfig" in tapi.__all__
    with pytest.raises(TypeError, match="bool"):
        tapi.PlanRequest(pools=tpools, mode="rolling", scenarios=True)
    with pytest.raises(ValueError, match="rolling"):
        tapi.PlanRequest(pools=tpools, scenarios=2)
    with pytest.raises(ValueError, match="out of range"):
        tsc.scenario_block(tpools.demand, tsc.resolve_scenarios(2), 1, 3,
                           device="cpu")


# The hedging policies (deterministic_hedge, randomized_hedge) in the
# replay, on the same fleet, unbatched and at N = 3: the randomized hedge
# is fed the reference's jax.random thresholds (the port draws its own
# from torch.Generator).  Decisions equal: every week's buys and commit
# pattern; the widths and the bills within rel 1e-5 (float32 sums in
# another order).  No meter on these fleets sits within rounding of its
# price, so no tie moves a commit week here.
class _ReferenceDraws(tpol.RandomizedHedgePolicy):
    def _thresholds(self, num_pools):
        import jax
        u = jax.random.uniform(jax.random.PRNGKey(self.seed),
                               (num_pools, self.grid_size))
        return torch.from_numpy(np.array(jpol._hedge_threshold(u)))


@pytest.mark.parametrize("scenarios", [None, 3])
@pytest.mark.parametrize("name", ["deterministic_hedge", "randomized_hedge"])
def test_hedge_replay_matches_reference(scen_fleet, name, scenarios):
    jpools, tpools = scen_fleet
    scen = (None if scenarios is None else
            dict(n_scenarios=scenarios, family="regime", seed=2))
    jrep = jrp.replan_fleet_pools(
        jpools, policy=name, **SCEN_KW,
        scenarios=None if scen is None else jsc.ScenarioConfig(**scen))
    tpolicy = (_ReferenceDraws(seed=0) if name == "randomized_hedge"
               else name)
    trep = trp.replan_fleet_pools(
        tpools, policy=tpolicy, device="cpu", **SCEN_KW,
        scenarios=None if scen is None else tsc.ScenarioConfig(**scen))
    assert trep.policy_name == jrep.policy_name == name
    _same(trep.increments > 0, jrep.increments > 0, "buy weeks")
    for field in ("increments", "active", "targets"):
        np.testing.assert_allclose(getattr(trep, field), getattr(jrep, field),
                                   rtol=1e-5, atol=1e-5, err_msg=field)
    np.testing.assert_allclose(trep.weekly_cost, jrep.weekly_cost, rtol=1e-5)
    assert trep.total_cost == pytest.approx(jrep.total_cost, rel=1e-5)
    if scenarios is not None:
        np.testing.assert_allclose(trep.scenario_cr, jrep.scenario_cr,
                                   rtol=1e-5)


def test_hedge_thresholds_follow_the_density():
    """The port's own thresholds (torch.Generator uniforms): inside (0, 1],
    mean 1/(e-1) within 0.005, and a Kolmogorov distance to the CDF
    (e^z - 1)/(e - 1) below 0.01 over 40,000 draws."""
    z = tpol.RandomizedHedgePolicy(grid_size=40, seed=3)._thresholds(1000)
    z = np.sort(z.numpy().ravel().astype(np.float64))
    assert z.min() > 0.0 and z.max() <= 1.0
    assert z.mean() == pytest.approx(1.0 / (np.e - 1.0), abs=0.005)
    cdf = (np.exp(z) - 1.0) / (np.e - 1.0)
    n = z.size
    ks = max(np.max(np.arange(1, n + 1) / n - cdf),
             np.max(cdf - np.arange(n) / n))
    assert ks < 0.01
    again = tpol.RandomizedHedgePolicy(grid_size=40, seed=3)._thresholds(1000)
    assert np.array_equal(np.sort(again.numpy().ravel()), z.astype(np.float32))


def test_hindsight_policy_replays_its_own_bill(scen_fleet):
    """A true bound on fixed seeds: the hindsight policy holds the optimal
    constant stack every week, so its replay bills exactly the hindsight
    reference, a competitive ratio of 1 (float32 sums, rel 1e-5)."""
    tpools = scen_fleet[1]
    for family in ("regime", "growth"):
        rep = trp.replan_fleet_pools(
            tpools, policy="hindsight", device="cpu", **SCEN_KW,
            scenarios=tsc.ScenarioConfig(n_scenarios=3, family=family))
        np.testing.assert_allclose(rep.scenario_cr, 1.0, rtol=1e-5)
