"""Share-based forecasting and the driver decomposition: the port's
``core.migration`` against the JAX package on the JAX package's turnover
fleets, carried across with ``convert``.

Tolerances:

* share observations and the transform/compose round trip: rtol 1e-6
  (elementwise float32, one log of difference);
* the share fits (``fit_share``, ``solve_share_prefix``) at rel 1e-4 (with
  an absolute floor of 1e-4 on a logit coefficient): five float32 sums
  over thousands of hours, summed in another order than XLA's, enter a
  2x2 solve whose denominator cancels;
* the decomposition recovers the planted midpoints within a week and the
  spans within 5%, the reference's own acceptance
  (tests/test_generations.py::TestDriverDecomposition), on the port's own
  fleet.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.capacity import generations as jgn  # noqa: E402
from repro.capacity import pricing as jpr  # noqa: E402
from repro.core import migration as jmg  # noqa: E402
from repro.data import traces as jtr  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.capacity import generations as tgn  # noqa: E402
from repro_torch.core import migration as tmg  # noqa: E402
from repro_torch.data import traces as ttr  # noqa: E402

WK = 168
FIT_REL = 1e-4
FIT_ABS = 1e-4

# The reference's planted tables: the rolling fixture's (midpoints in
# weeks 14 and 21 of 30) and the decomposition's (weeks 35 and 68 of 104).
PLANT = jgn.MigrationConfig(generations=(
    jpr.Generation("aws", "C6i", "C7i", 8, 12.0, 0.25),
    jpr.Generation("gcp", "N2-Standard", "N4-Standard", 16, 10.0, 0.50),
))
DECOMPOSE = jgn.MigrationConfig(generations=(
    jpr.Generation("aws", "C6i", "C7i", 20, 30.0, 0.25),
    jpr.Generation("gcp", "N2-Standard", "N4-Standard", 55, 26.0, 0.50),
))


@pytest.fixture(scope="module")
def fleet():
    """The reference's rolling fixture fleet (4 pools x 30 weeks, seed 3,
    turned over by the JAX package) with its edges in both packages."""
    jpools = jtr.synthetic_pool_set(num_pools=4, num_hours=30 * WK, seed=3,
                                    migration=PLANT)
    tplant = convert.migration_config_from_reference(PLANT)
    return (jpools, jgn.migration_edges(jpools.keys, PLANT),
            tgn.migration_edges(jpools.keys, tplant, device="cpu"))


def _close(got, want, rel=FIT_REL, atol=FIT_ABS):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rel,
                               atol=atol)


def test_share_observations_equal_reference(fleet):
    jpools, je, te = fleet
    jz, jw = jmg.share_observations(jnp.asarray(jpools.demand), je)
    tz, tw = tmg.share_observations(torch.from_numpy(jpools.demand), te)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6,
                               atol=1e-9)


@pytest.mark.parametrize("prior_weight", [0.0, 100.0])
def test_fit_share_equals_reference(fleet, prior_weight):
    jpools, je, te = fleet
    t_max = float(jpools.num_hours - 1)
    ja, jb = jmg.fit_share(jnp.asarray(jpools.demand), je, t_max=t_max,
                           prior_weight=prior_weight)
    ta, tb = tmg.fit_share(torch.from_numpy(jpools.demand), te, t_max=t_max,
                           prior_weight=prior_weight)
    _close(ta, ja)
    _close(tb, jb)
    jp = jmg._prior_moments(je, t_max, 100.0)
    tp = tmg._prior_moments(te, t_max, 100.0)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6)


@pytest.mark.parametrize("week", [1, 12, 30])
def test_share_prefix_equals_reference(fleet, week):
    jpools, je, te = fleet
    t_max = float(20 * WK - 1)
    js = jmg.share_prefix_state(jnp.asarray(jpools.demand), je, t_max=t_max,
                                prior_weight=100.0)
    ts = tmg.share_prefix_state(torch.from_numpy(jpools.demand), te,
                                t_max=t_max, prior_weight=100.0)
    assert ts.cum.shape == js.cum.shape
    np.testing.assert_allclose(ts.cum.numpy(), np.asarray(js.cum),
                               rtol=FIT_REL, atol=FIT_ABS)
    ja, jb = jmg.solve_share_prefix(js, week)
    ta, tb = tmg.solve_share_prefix(ts, week)
    _close(ta, ja)
    _close(tb, jb)


def test_share_prefix_at_the_end_is_the_full_fit(fleet):
    """The last prefix holds the same moments as the full-window fit,
    gathered instead of summed (the reference's check, 2e-4)."""
    jpools, _, te = fleet
    d = torch.from_numpy(jpools.demand)
    t_max = float(jpools.num_hours - 1)
    a_full, b_full = tmg.fit_share(d, te, t_max=t_max)
    state = tmg.share_prefix_state(d, te, t_max=t_max)
    a_pre, b_pre = tmg.solve_share_prefix(state, jpools.num_hours // WK)
    torch.testing.assert_close(a_pre, a_full, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(b_pre, b_full, rtol=2e-4, atol=2e-4)


def test_predict_share_and_round_trip(fleet):
    """predict_share matches the reference; the pair-total transform
    followed by the composition with the realized shares gives the demand
    back."""
    jpools, je, te = fleet
    d = torch.from_numpy(jpools.demand)
    a, b = torch.tensor([-3.0, 0.5]), torch.tensor([6.0, -1.0])
    t = np.arange(100, 400)
    got = tmg.predict_share(a, b, torch.from_numpy(t), 999.0)
    want = jmg.predict_share(jnp.asarray(a.numpy()), jnp.asarray(b.numpy()),
                             jnp.asarray(t), 999.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)

    total = tmg.transform_for_fit(d, te)
    want_total = jmg.transform_for_fit(jnp.asarray(jpools.demand), je)
    np.testing.assert_allclose(total.numpy(), np.asarray(want_total),
                               rtol=1e-6)
    old, new = d[te.src], d[te.dst]
    share = new * (1 + te.uplift[:, None]) / (old + new * (
        1 + te.uplift[:, None]))
    back = tmg.compose_forecast(total, share, te)
    torch.testing.assert_close(back, d, rtol=1e-5, atol=1e-4)
    ref_back = jmg.compose_forecast(want_total, jnp.asarray(share.numpy()),
                                    je)
    np.testing.assert_allclose(back.numpy(), np.asarray(ref_back),
                               rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def decomposed():
    """The reference's decomposition fleet (4 pools x 104 weeks, seed 3,
    its planted table), built and turned over by the port."""
    plant = convert.migration_config_from_reference(DECOMPOSE)
    base = ttr.synthetic_base_pool_set(num_pools=4, num_hours=104 * WK,
                                       seed=3, migration=plant)
    pools = tgn.migrate_pool_set(base, plant, device="cpu")
    return plant, base, pools


def test_decompose_recovers_planted_logistics(decomposed):
    plant, _, pools = decomposed
    dec = tmg.decompose_drivers(pools, migration=plant, device="cpu")
    assert [(f.cloud, f.old_family, f.new_family) for f in dec.edge_fits] \
        == [(g.cloud, g.old_family, g.new_family) for g in plant.generations]
    for ef, g in zip(dec.edge_fits, plant.generations):
        assert ef.midpoint_weeks == pytest.approx(g.midpoint_week, abs=1.0)
        assert ef.span_weeks == pytest.approx(g.span_weeks, rel=0.05)
        assert 0.5 < ef.final_share < 1.0
    assert dec.efficiency_per_year is None
    assert dec.hardware_index[-1] < dec.hardware_index[0] - 0.05
    shares = dec.predicted_shares(np.arange(0, pools.num_hours, 1000))
    assert shares.shape == (2, len(range(0, pools.num_hours, 1000)))


def test_decompose_recovers_efficiency_drift(decomposed):
    plant, base, pools = decomposed
    dec = tmg.decompose_drivers(pools, migration=plant,
                                user_volume=base.demand.sum(0),
                                device="cpu")
    assert dec.efficiency_per_year == pytest.approx(
        plant.software_efficiency_per_year, rel=0.05)
    assert dec.growth_per_year > 0
    with pytest.raises(ValueError, match="successor structure"):
        tmg.decompose_drivers(pools, migration=False, device="cpu")
    with pytest.raises(ValueError, match="user_volume"):
        tmg.decompose_drivers(pools, migration=plant,
                              user_volume=np.ones(5), device="cpu")


def test_decompose_equals_reference_on_the_reference_fleet():
    """On the JAX package's own turnover fleet both decompositions fit the
    same share lines and epochs."""
    jb = jtr.synthetic_base_pool_set(num_pools=4, num_hours=40 * WK, seed=3,
                                     migration=PLANT)
    jpools = jgn.migrate_pool_set(jb, PLANT)
    want = jmg.decompose_drivers(jpools, migration=PLANT)
    got = tmg.decompose_drivers(convert.pool_set_from_reference(jpools),
                                migration=convert
                                .migration_config_from_reference(PLANT),
                                device="cpu")
    np.testing.assert_allclose(got.share_a, want.share_a, rtol=FIT_REL,
                               atol=FIT_ABS)
    np.testing.assert_allclose(got.share_b, want.share_b, rtol=FIT_REL,
                               atol=FIT_ABS)
    for g, w in zip(got.edge_fits, want.edge_fits):
        assert g.midpoint_weeks == pytest.approx(w.midpoint_weeks, rel=1e-3)
        assert g.span_weeks == pytest.approx(w.span_weeks, rel=1e-3)
    np.testing.assert_allclose(got.hardware_index, want.hardware_index,
                               rtol=1e-5)
