"""The spot band's pricing and lines: the PyTorch port against the JAX
package.

* the spot-market rows equal, row for row, and the table checks;
* analytic ``pool_spot_lines`` within 1e-6 (float32 arithmetic in the same
  order; the cap's division may round an ulp apart);
* lines estimated from simulated paths within 1e-6, on the reference's own
  draws walked by the port; the port's own generator is held to the
  analytic lines on distribution only, as the reference's
  ``test_simulated_rate_close_to_analytic`` holds its own;
* ``spot_entry_fractile`` equal (both take ``argmin``'s first index on a
  4096-point grid), shared and per pool;
* ``resolve_spot``, ``expected_availability`` and the request's ``spot=``
  validation as in the reference;
* ``device=None`` is the card: without one, every builder of spot
  parameters or lines raises rather than building or walking on the CPU.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.capacity import preemption as jpe  # noqa: E402
from repro.capacity import pricing as jpr  # noqa: E402
from repro.core import portfolio as jpf  # noqa: E402
from repro.core import spot as jsp  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.capacity import preemption as tpe  # noqa: E402
from repro_torch.capacity import pricing as tpr  # noqa: E402
from repro_torch.core import api as tapi  # noqa: E402
from repro_torch.core import portfolio as tpf  # noqa: E402
from repro_torch.core import spot as tsp  # noqa: E402

LINE_TOL = 1e-6
CLOUDS = ("aws", "azure", "gcp", "aws", "gcp")
LINE_FIELDS = ("rate", "cap", "market_rate", "availability")


def _assert_lines_close(got, want, tol=LINE_TOL):
    for name in LINE_FIELDS:
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=0, atol=tol, err_msg=name)


def test_spot_markets_equal_reference():
    assert [dataclasses.astuple(m) for m in tpr.SPOT_MARKETS] == [
        dataclasses.astuple(m) for m in jpr.SPOT_MARKETS]
    assert tpr.known_clouds() == jpr.known_clouds()
    for m in jpr.SPOT_MARKETS:
        assert dataclasses.astuple(tpr.spot_market(m.cloud)) == \
            dataclasses.astuple(m)
    with pytest.raises(KeyError, match="oracle"):
        tpr.spot_market("oracle")


@pytest.mark.parametrize("bad", [
    dict(cloud="oracle"), dict(discount=1.2), dict(hazard_per_hour=0.0),
    dict(price_band=1.0),
])
def test_validate_tables_rejects_a_bad_spot_row(monkeypatch, bad):
    row = dataclasses.replace(tpr.SPOT_MARKETS[0], **bad)
    monkeypatch.setattr(tpr, "SPOT_MARKETS", [row] + tpr.SPOT_MARKETS[1:])
    with pytest.raises(ValueError, match="spot"):
        tpr.validate_tables()


@pytest.mark.parametrize("cfg", [
    dict(), dict(availability_target=0.9, risk_buffer=0.0),
    dict(requeue_hours=6.0), dict(availability_target=0.995),
])
def test_analytic_lines_equal_reference(cfg):
    jl = jsp.pool_spot_lines(CLOUDS, od_rate=2.1, cfg=jsp.SpotConfig(**cfg))
    tl = tsp.pool_spot_lines(CLOUDS, od_rate=2.1, cfg=tsp.SpotConfig(**cfg),
                             device="cpu")
    _assert_lines_close(tl, jl)
    assert tsp.SpotConfig(**cfg) == tsp.SpotConfig(**dataclasses.asdict(
        jsp.SpotConfig(**cfg)))


@pytest.mark.parametrize("draws,seed", [(4, 0), (16, 3)])
def test_simulated_lines_on_reference_draws(draws, seed):
    """The reference's num_draws > 0 lines, rebuilt by the port's walk and
    estimator from the very draws the reference made."""
    cfg = jsp.SpotConfig(num_draws=draws, seed=seed)
    jl = jsp.pool_spot_lines(CLOUDS, od_rate=2.1, cfg=cfg)
    noise = jpe.draw_noise(jl.params, cfg.sim_hours, draws,
                           jax.random.PRNGKey(seed))
    tp = tpe.params_for_clouds(CLOUDS, device="cpu")
    paths = tpe.revocation_walk(tp, *(torch.tensor(np.asarray(x))
                                      for x in noise))
    tcfg = tsp.SpotConfig(**dataclasses.asdict(cfg))
    tl = tsp._lines(tp, tcfg, 2.1, *tsp._path_estimates(paths))
    _assert_lines_close(tl, jl)
    _assert_lines_close(convert.spot_lines_from_reference(jl), jl, tol=0.0)


def test_own_generator_lines_close_to_analytic():
    """The reference's test_simulated_rate_close_to_analytic, on the port's
    own draws: many draws x hours bring the estimate to the analytic line."""
    cfg = tsp.SpotConfig(num_draws=64, sim_hours=24 * 7 * 26)
    sim = tsp.pool_spot_lines(("aws", "azure", "gcp"), od_rate=2.1,
                              cfg=cfg, device="cpu")
    ana = tsp.pool_spot_lines(("aws", "azure", "gcp"), od_rate=2.1,
                              device="cpu")
    np.testing.assert_allclose(sim.rate.numpy(), ana.rate.numpy(),
                               rtol=0.02)
    np.testing.assert_allclose(sim.availability.numpy(),
                               ana.availability.numpy(), atol=0.01)
    again = tsp.pool_spot_lines(("aws", "azure", "gcp"), od_rate=2.1,
                                cfg=cfg, device="cpu")
    assert torch.equal(sim.rate, again.rate)


def test_cap_rate_and_availability_helpers_equal_reference():
    a = np.asarray([0.5, 0.9, 0.95, 0.99, 1.0], np.float32)
    for target, buf in ((0.95, 0.0), (0.9, 0.2), (1.0, 0.1)):
        np.testing.assert_allclose(
            tsp.spot_cap_fraction(torch.tensor(a), target,
                                  risk_buffer=buf).numpy(),
            np.asarray(jsp.spot_cap_fraction(jnp.asarray(a), target,
                                             risk_buffer=buf)),
            rtol=0, atol=LINE_TOL)
    with pytest.raises(ValueError, match="availability_target"):
        tsp.spot_cap_fraction(torch.tensor(a), 0.0)
    got = tsp.expected_availability(torch.tensor(0.5), torch.tensor(0.9))
    assert float(got) == pytest.approx(0.95)
    jp = jpe.params_for_clouds(list(CLOUDS))
    tp = tpe.params_for_clouds(CLOUDS, device="cpu")
    np.testing.assert_allclose(
        tsp.effective_spot_rate(tp, od_rate=2.1, requeue_hours=2.0,
                                price=1.1).numpy(),
        np.asarray(jsp.effective_spot_rate(jp, od_rate=2.1,
                                           requeue_hours=2.0, price=1.1)),
        rtol=0, atol=LINE_TOL)


@pytest.mark.parametrize("rate", [0.3, 0.9, 1.0, 1.2, 1.6, 2.1, 2.5])
@pytest.mark.parametrize("tw", [0.0, 1.0])
def test_entry_fractile_equals_reference(rate, tw):
    al, be = jpf.option_lines(jpf.options_from_pricing(), term_weighting=tw)
    want = float(jsp.spot_entry_fractile(al, be, jnp.float32(rate),
                                         od_rate=2.1))
    got = tsp.spot_entry_fractile(
        torch.tensor(np.asarray(al)), torch.tensor(np.asarray(be)), rate,
        od_rate=2.1)
    assert got.dim() == 0 and float(got) == want


def test_entry_fractile_per_pool_is_per_line_set():
    """(P, K) lines with (P,) rates: one fractile per pool, computed once
    per distinct line set, equal to the reference's vmap."""
    opts = jpf.options_from_pricing()
    jal, jbe, _ = jpf.pool_option_lines(opts, list(CLOUDS), od_rate=2.1)
    jl = jsp.pool_spot_lines(CLOUDS, od_rate=2.1)
    want = jax.vmap(lambda a, b, r: jsp.spot_entry_fractile(
        a, b, r, od_rate=2.1))(jal, jbe, jl.rate)
    tal, tbe, _ = tpf.pool_option_lines(
        convert.options_from_reference(opts), CLOUDS, od_rate=2.1)
    tl = tsp.pool_spot_lines(CLOUDS, od_rate=2.1, device="cpu")
    got = tsp.spot_entry_fractile(tal, tbe, tl.rate, od_rate=2.1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_resolve_spot_variants():
    assert tsp.resolve_spot(None, CLOUDS, od_rate=2.1) is None
    assert tsp.resolve_spot(False, CLOUDS, od_rate=2.1) is None
    cfg, lines = tsp.resolve_spot(True, CLOUDS, od_rate=2.1, device="cpu")
    assert cfg == tsp.SpotConfig() and lines.rate.shape == (len(CLOUDS),)
    own = tsp.SpotConfig(availability_target=0.9)
    assert tsp.resolve_spot(own, CLOUDS, od_rate=2.1,
                            device="cpu")[0] is own
    pair = (own, lines)
    cfg2, lines2 = tsp.resolve_spot(pair, CLOUDS, od_rate=2.1, device="cpu")
    assert cfg2 is own and torch.equal(lines2.rate, lines.rate)
    for bad in ("yes", (own,), (lines, own)):
        with pytest.raises(TypeError, match="spot must be"):
            tsp.resolve_spot(bad, CLOUDS, od_rate=2.1)


@pytest.mark.parametrize("spot,ok", [
    (None, True), (True, True), (False, True),
    (tsp.SpotConfig(), True), ("yes", False), (0.5, False),
])
def test_request_spot_validation_mirrors_reference(spot, ok):
    if ok:
        tapi.PlanRequest(pools=None, spot=spot)
    else:
        with pytest.raises(TypeError, match="SpotConfig"):
            tapi.PlanRequest(pools=None, spot=spot)


@pytest.mark.parametrize("build", [
    lambda: tpe.params_for_clouds(CLOUDS),
    lambda: tsp.pool_spot_lines(CLOUDS, od_rate=2.1),
    lambda: tsp.pool_spot_lines(CLOUDS, od_rate=2.1,
                                cfg=tsp.SpotConfig(num_draws=2,
                                                   sim_hours=24)),
    lambda: tsp.resolve_spot(True, CLOUDS, od_rate=2.1),
], ids=["params", "analytic_lines", "simulated_lines", "resolve_spot"])
def test_no_device_means_the_card(build):
    """As at every entry point of the port, ``device=None`` resolves to
    the card; without one it raises, naming ``device="cpu"``."""
    if torch.cuda.is_available():
        assert build() is not None
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            build()
