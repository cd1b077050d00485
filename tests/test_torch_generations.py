"""Generation turnover: the port's pricing rows, successor edges and
turnover pass (the CUDA kernel's CPU path and spec) against the JAX
package, on the JAX package's own base fleets.

Tolerances:

* pricing rows, edges and validation: equal;
* the plain turnover against the reference's compiled scan: every element
  within rtol 1e-6, or within 2^-22 of its row's base peak.  The two
  ``exp``s (XLA's and PyTorch's) differ in the last ulp at a few hours, and
  a source row late in adoption is b - b*m, which cancels down to a few
  ulps of b: one ulp of b*m there is ~2^-24 of b, however small the
  difference is;
* the plain turnover against the port's per-hour loop (the reference's
  scan step replayed hour by hour): bit for bit;
* volume conservation: rel 1e-4 (the reference's bound).

The kernel itself only runs on the card: chip_smoke.py's ``turnover``
phase holds it to this plain version and to the loop there, bit for bit.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.capacity import generations as jgn  # noqa: E402
from repro.capacity import pricing as jpr  # noqa: E402
from repro.data import traces as jtr  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.capacity import generations as tgn  # noqa: E402
from repro_torch.capacity import pricing as tpr  # noqa: E402
from repro_torch.data import traces as ttr  # noqa: E402
from repro_torch.kernels.generation_turnover import generation_turnover as tker  # noqa: E402
from repro_torch.kernels.generation_turnover import ops  # noqa: E402
from repro_torch.kernels.generation_turnover.ref import turnover_ref  # noqa: E402

WK = 168
SCAN_RTOL = 1e-6
ROW_ATOL = 2.0 ** -22
EDGE_FIELDS = ("src", "dst", "uplift", "inv_gain", "midpoint_hours",
               "rate_per_hour")

# The reference's planted 2-edge table (tests/test_generations.py) with
# epochs unlike the pricing table's.
PLANT = jgn.MigrationConfig(generations=(
    jpr.Generation("aws", "C6i", "C7i", 8, 12.0, 0.25),
    jpr.Generation("gcp", "N2-Standard", "N4-Standard", 16, 10.0, 0.50),
))
TPLANT = convert.migration_config_from_reference(PLANT)


def _rows(items):
    return [dataclasses.asdict(x) for x in items]


@pytest.mark.parametrize("table", [
    "SAVINGS_PLANS", "SPOT_MARKETS", "HARDWARE_TRANSITIONS", "GENERATIONS",
    "CONVERTIBLE_PLANS",
])
def test_pricing_rows_equal_reference(table):
    assert _rows(getattr(tpr, table)) == _rows(getattr(jpr, table))


def test_pricing_derived_values_equal_reference():
    assert tpr.SOFTWARE_EFFICIENCY_PER_YEAR == jpr.SOFTWARE_EFFICIENCY_PER_YEAR
    for cloud in sorted(jpr.known_clouds()):
        assert tpr.convertible_discounts(cloud) == \
            jpr.convertible_discounts(cloud)
        assert _rows(tpr.generations_for_cloud(cloud)) == \
            _rows(jpr.generations_for_cloud(cloud))
        assert dataclasses.asdict(tpr.convertible_plan(cloud)) == \
            dataclasses.asdict(jpr.convertible_plan(cloud))
    assert tpr.Generation("aws", "C6i", "C7i", 10, 20.0, 0.25) \
        .midpoint_week == 20.0
    with pytest.raises(KeyError, match="oracle"):
        tpr.convertible_plan("oracle")
    tpr.validate_tables()


@pytest.mark.parametrize("table,bad,match", [
    ("GENERATIONS", ("aws", "C6i", "NotASku", 26, 40.0, 0.25), "Table-2"),
    ("GENERATIONS", ("aws", "C7i", "C6i", 10, 10.0, 0.1), "chained"),
    ("GENERATIONS", ("aws", "C6i", "C7i", -1, 10.0, 0.1), "positive"),
    ("CONVERTIBLE_PLANS", ("oracle", 0.04, 0.07), "unknown cloud"),
    ("CONVERTIBLE_PLANS", ("aws", 0.04, 0.30), "monotone"),
])
def test_corrupted_rows_raise(monkeypatch, table, bad, match):
    # Prepended, so a lookup by cloud finds the corrupted row first.
    row_type = type(getattr(tpr, table)[0])
    monkeypatch.setattr(tpr, table, [row_type(*bad)] + getattr(tpr, table))
    with pytest.raises(ValueError, match=match):
        tpr.validate_tables()


def test_unsorted_transitions_raise(monkeypatch):
    monkeypatch.setattr(tpr, "HARDWARE_TRANSITIONS",
                        list(reversed(tpr.HARDWARE_TRANSITIONS)))
    with pytest.raises(ValueError, match="date-sorted"):
        tpr.validate_tables()


@pytest.mark.parametrize("keys", [
    [("aws", "region_0", "C6i"), ("aws", "region_0", "C7i"),
     ("aws", "region_1", "C6i"), ("gcp", "region_0", "N2-Standard"),
     ("gcp", "region_0", "N4-Standard")],
    "turnover12",
    "legacy",
])
def test_edges_equal_reference(keys):
    if keys == "turnover12":
        keys = jtr.synthetic_base_pool_set(num_pools=12, num_hours=WK).keys
    elif keys == "legacy":
        keys = jtr.synthetic_pool_set(num_pools=3, num_hours=WK).keys
    for jcfg, tcfg in ((PLANT, TPLANT),
                       (jgn.MigrationConfig(), tgn.MigrationConfig())):
        want = jgn.migration_edges(keys, jcfg)
        got = tgn.migration_edges(keys, tcfg, device="cpu")
        assert got.num_edges == want.num_edges
        for field in EDGE_FIELDS:
            np.testing.assert_array_equal(
                getattr(got, field).numpy(),
                np.asarray(getattr(want, field)), err_msg=field)


def _config_case(case):
    g = (("aws", "C6i", "C7i", 20, 28.0, 0.25),)
    return {
        "dup_source": dict(generations=g + (
            ("aws", "C6i", "M7GD", 20, 28.0, 0.30),)),
        "dup_successor": dict(generations=g + (
            ("aws", "C7GD", "C7i", 20, 28.0, 0.30),)),
        "chain": dict(generations=g + (
            ("aws", "C7i", "M7GD", 20, 28.0, 0.30),)),
        "same_family": dict(generations=(
            ("aws", "C6i", "C6i", 20, 28.0, 0.25),)),
        "span": dict(generations=(("aws", "C6i", "C7i", 20, 0.0, 0.25),)),
        "prior": dict(generations=g, share_prior_weight=-1.0),
        "sw_rate": dict(generations=g, software_efficiency_per_year=1.0),
    }[case]


@pytest.mark.parametrize("case", [
    "dup_source", "dup_successor", "chain", "same_family", "span", "prior",
    "sw_rate",
])
def test_migration_config_refusals_match_reference(case):
    kw = _config_case(case)
    out = {}
    for name, gn_mod, pr_mod in (("jax", jgn, jpr), ("torch", tgn, tpr)):
        args = dict(kw, generations=tuple(
            pr_mod.Generation(*g) for g in kw["generations"]))
        with pytest.raises(ValueError) as err:
            gn_mod.MigrationConfig(**args)
        out[name] = str(err.value)
    assert out["torch"] == out["jax"]


def test_resolve_migration():
    assert tgn.resolve_migration(None) is None
    assert tgn.resolve_migration(False) is None
    assert tgn.resolve_migration(True) == tgn.MigrationConfig()
    assert tgn.resolve_migration(TPLANT) is TPLANT
    with pytest.raises(TypeError, match="MigrationConfig"):
        tgn.resolve_migration("yes")
    assert tgn.MigrationConfig().generations == tuple(tpr.GENERATIONS)


@pytest.fixture(scope="module")
def planted():
    """The reference's base fleet (4 pools x 30 weeks, seed 3) and its
    planted edges in both packages."""
    base = jtr.synthetic_base_pool_set(num_pools=4, num_hours=30 * WK,
                                       seed=3, migration=PLANT)
    return (base, jgn.migration_edges(base.keys, PLANT),
            tgn.migration_edges(base.keys, TPLANT, device="cpu"))


def _hold_to_scan(got, want, base):
    scale = ROW_ATOL * np.abs(base).max(-1, keepdims=True)
    bad = np.abs(got - want) > SCAN_RTOL * np.abs(want) + scale
    assert not bad.any(), (
        f"{int(bad.sum())} elements off; worst rel "
        f"{float((np.abs(got - want) / np.abs(want).clip(1e-30)).max())}")


@pytest.mark.parametrize("num_pools,weeks,plant", [
    (4, 30, True), (12, 8, False), (8, 1, False),
])
def test_plain_turnover_equals_reference_scan_and_loop(num_pools, weeks,
                                                       plant):
    jcfg, tcfg = (PLANT, TPLANT) if plant else (
        jgn.MigrationConfig(), tgn.MigrationConfig())
    base = jtr.synthetic_base_pool_set(num_pools=num_pools,
                                       num_hours=weeks * WK + 5, seed=3,
                                       migration=jcfg)
    je = jgn.migration_edges(base.keys, jcfg)
    te = tgn.migration_edges(base.keys, tcfg, device="cpu")
    b = torch.from_numpy(base.demand)
    got = tgn.migrate_demand(b, te, sw_rate=tcfg.software_efficiency_per_year)
    loop = tgn.migrate_demand_loop(
        b, te, sw_rate=tcfg.software_efficiency_per_year)
    torch.testing.assert_close(got, loop, rtol=0, atol=0)
    want = np.asarray(jgn.migrate_demand(
        jnp.asarray(base.demand), je,
        sw_rate=jcfg.software_efficiency_per_year))
    _hold_to_scan(got.numpy(), want, base.demand)


@pytest.mark.parametrize("threads", [1, 2, 5, None])
def test_logistic_exp_is_the_same_in_every_layout(planted, threads):
    """What the bit-for-bit check above rests on: the CPU ``exp`` of the
    logistic's argument gives each element the same value whatever call
    it is in.  The plain pass takes it over the (G, T) argument in one
    call, which ATen splits over its intra-op threads in 2048-element
    grains; the loop takes it over (G,) once per hour.  Held in both
    layouts, at unaligned offsets, and under 1, 2, 5 and the default
    number of threads."""
    base, _, te = planted
    t = torch.arange(base.num_hours + 5, dtype=torch.float32)
    arg = -torch.abs(te.rate_per_hour[:, None]
                     * (t[None, :] - te.midpoint_hours[:, None]))
    before = torch.get_num_threads()
    try:
        if threads is not None:
            torch.set_num_threads(threads)
        whole = torch.exp(arg)
        hourly = torch.stack([torch.exp(arg[:, h].clone())
                              for h in range(arg.shape[1])], dim=1)
        flat = arg.flatten()
        shifted = [torch.exp(flat[k:].clone()) for k in (1, 3, 7, 2018)]
    finally:
        torch.set_num_threads(before)
    torch.testing.assert_close(hourly, whole, rtol=0, atol=0)
    for k, got in zip((1, 3, 7, 2018), shifted):
        torch.testing.assert_close(got, whole.flatten()[k:], rtol=0, atol=0)


def test_turnover_is_the_closed_form(planted):
    """Each migrated pair is the closed-form adoption curve times the
    deflator (the reference's own check, rtol 3e-4)."""
    base, _, te = planted
    got = tgn.migrate_demand(torch.from_numpy(base.demand), te).numpy()
    t = np.arange(base.num_hours)
    s = tgn.adoption_shares(te, t).numpy()
    eff = tgn.software_deflator(
        t, TPLANT.software_efficiency_per_year).numpy()
    up = te.uplift.numpy()
    for g, (src, dst) in enumerate(zip(te.src.tolist(), te.dst.tolist())):
        np.testing.assert_allclose(
            got[src], base.demand[src] * (1 - s[g]) * eff,
            rtol=3e-4, atol=1e-4)
        np.testing.assert_allclose(
            got[dst],
            (base.demand[dst] + base.demand[src] * s[g] / (1 + up[g])) * eff,
            rtol=3e-4, atol=1e-4)
    ref_eff = np.asarray(jgn.software_deflator(
        jnp.arange(base.num_hours), PLANT.software_efficiency_per_year))
    np.testing.assert_allclose(eff, ref_eff, rtol=1e-6)
    ref_s = np.asarray(jgn.adoption_shares(planted[1],
                                           jnp.arange(base.num_hours)))
    np.testing.assert_allclose(s, ref_s, rtol=1e-6, atol=1e-12)


def test_volume_conservation(planted):
    """Perf-adjusted volume (successors x (1 + uplift), deflator undone)
    equals the base volume: turnover moves demand, it does not make it."""
    base, _, te = planted
    d = tgn.migrate_demand(torch.from_numpy(base.demand), te).numpy()
    eff = tgn.software_deflator(np.arange(base.num_hours),
                                TPLANT.software_efficiency_per_year).numpy()
    perf = np.ones(base.num_pools, np.float32)
    perf[te.dst.numpy()] = 1.0 + te.uplift.numpy()
    got = ((d / eff) * perf[:, None]).sum()
    np.testing.assert_allclose(got, base.demand.sum(), rtol=1e-4)


def test_no_edges_is_pure_deflation():
    jpools = jtr.synthetic_pool_set(num_pools=2, num_hours=2 * WK)
    te = tgn.migration_edges(jpools.keys, device="cpu")
    assert te.num_edges == 0
    out = tgn.migrate_demand(torch.from_numpy(jpools.demand), te)
    eff = tgn.software_deflator(np.arange(jpools.num_hours),
                                tpr.SOFTWARE_EFFICIENCY_PER_YEAR)
    np.testing.assert_allclose(out.numpy(), jpools.demand * eff.numpy(),
                               rtol=1e-6)
    want = np.asarray(jgn.migrate_demand(
        jnp.asarray(jpools.demand),
        jgn.migration_edges(jpools.keys)))
    _hold_to_scan(out.numpy(), want, jpools.demand)


def test_edges_at_the_first_and_last_pool():
    """A pair at the fleet's two ends, with no edge between them."""
    rng = np.random.default_rng(0)
    base = torch.tensor(rng.gamma(2.0, 30.0, (5, 333)).astype(np.float32))
    src, dst = torch.tensor([4]), torch.tensor([0])
    args = (torch.tensor([0.8]), torch.tensor([150.0]),
            torch.tensor([0.01]), 1e-5)
    got = ops.turnover(base, src, dst, *args)
    want = turnover_ref(base, src, dst, *args)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    eff = torch.exp(-1e-5 * torch.arange(333, dtype=torch.float32))
    torch.testing.assert_close(got[1:4], base[1:4] * eff, rtol=0, atol=0)


def test_turnover_refuses_pools_with_two_roles():
    base = torch.ones(4, 10)
    args = (torch.ones(2), torch.zeros(2), torch.ones(2), 0.0)
    with pytest.raises(ValueError, match="one role"):
        ops.turnover(base, torch.tensor([0, 1]), torch.tensor([1, 2]), *args)
    with pytest.raises(ValueError, match="outside"):
        ops.turnover(base, torch.tensor([0, 1]), torch.tensor([5, 2]), *args)
    with pytest.raises(ValueError, match="different devices"):
        ops.turnover(base.to("meta"), torch.tensor([0]), torch.tensor([1]),
                     torch.ones(1), torch.zeros(1), torch.ones(1), 0.0)


@pytest.mark.parametrize("num_pools,src,dst", [
    (5, [4], [0]), (6, [0, 3], [1, 2]), (3, [], []), (2, [1], [0]),
])
def test_units_cover_every_pool_once(num_pools, src, dst):
    """The kernel's unit table: each edge's (source, successor) rows with
    its index first, then every pool on no edge alone, so every pool is
    one unit's row exactly once."""
    rows, edge = ops.units(num_pools, src, dst, "cpu")
    assert rows.dtype == edge.dtype == torch.int32
    assert rows.shape == (num_pools - len(src), 2)
    assert edge.tolist() == list(range(len(src))) + [-1] * (
        num_pools - 2 * len(src))
    assert rows[:len(src)].tolist() == [[s, d] for s, d in zip(src, dst)]
    assert (rows[len(src):, 1] == -1).all()
    covered = [int(r) for r in rows.flatten() if r >= 0]
    assert sorted(covered) == list(range(num_pools))


def test_cuda_wrapper_takes_cuda_tensors_only():
    """On CPU tensors the kernel's wrapper raises instead of running
    anything, and counts no launch."""
    before = tker.LAUNCHES
    i32 = dict(dtype=torch.int32)
    args = (torch.zeros(3, 5), torch.tensor([[0, 2], [1, -1]], **i32),
            torch.tensor([0, -1], **i32), torch.ones(1), torch.zeros(1),
            torch.ones(1), 0.0)
    with pytest.raises(ValueError, match="CUDA"):
        tker.generation_turnover_cuda(*args)
    with pytest.raises(TypeError, match="float32"):
        tker.generation_turnover_cuda(args[0].double(), *args[1:])
    assert tker.LAUNCHES == before


def test_turnover_fleet_matches_reference_layout():
    """The port's turnover fleet: the reference's keys and configs,
    successor pools exactly zero before turnover, the same profiles (the
    noise draws differ), and the turnover run by the plain version."""
    for cfg_j, cfg_t in ((True, True), (PLANT, TPLANT)):
        jb = jtr.synthetic_base_pool_set(num_pools=8, num_hours=4 * WK,
                                         seed=2, migration=cfg_j)
        tb = ttr.synthetic_base_pool_set(num_pools=8, num_hours=4 * WK,
                                         seed=2, migration=cfg_t)
        assert tb.keys == jb.keys
        assert [c.__dict__ for c in tb.configs] == \
            [c.__dict__ for c in jb.configs]
        zero = jb.demand.sum(-1) == 0
        assert zero.sum() == 4
        np.testing.assert_array_equal(tb.demand[zero], 0.0)
        np.testing.assert_allclose(tb.demand[~zero].mean(-1),
                                   jb.demand[~zero].mean(-1), rtol=0.03)
        fleet = ttr.synthetic_pool_set(num_pools=8, num_hours=4 * WK,
                                       seed=2, migration=cfg_t,
                                       device="cpu")
        edges = tgn.migration_edges(tb.keys, tgn.resolve_migration(cfg_t),
                                    device="cpu")
        want = tgn.migrate_demand(torch.from_numpy(tb.demand), edges)
        np.testing.assert_array_equal(fleet.demand, want.numpy())
        assert fleet.keys == tb.keys and fleet.configs == tb.configs
    families = {k[2] for k in fleet.keys}
    table = {f for g in tpr.GENERATIONS for f in (g.old_family, g.new_family)}
    assert families <= table


def test_turnover_fleet_rejects_odd_pool_counts_and_no_band():
    with pytest.raises(ValueError, match="even"):
        ttr.synthetic_pool_set(num_pools=13, num_hours=WK, migration=True,
                               device="cpu")
    with pytest.raises(ValueError, match="even"):
        ttr.synthetic_base_pool_set(num_pools=1, num_hours=WK)
    with pytest.raises(ValueError, match="turnover fleet"):
        ttr.synthetic_base_pool_set(num_pools=4, num_hours=WK,
                                    migration=False)


def test_turnover_needs_a_device_or_the_card():
    """Without a card, the turnover fleet's default device is an error
    that names device="cpu"; the fleet without turnover stays host-only."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ttr.synthetic_pool_set(num_pools=4, num_hours=WK, migration=True)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tgn.migration_edges([("aws", "r", "C6i")])
    assert ttr.synthetic_pool_set(num_pools=4, num_hours=WK).num_pools == 4
