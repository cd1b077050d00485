"""The free-pool autoscaler in the PyTorch port (``serve/autoscaler.py``,
on the CPU) against the JAX package's, on the reference's own demand
(``synth_demand`` with ``PRNGKey(0)``: 21 days of hourly history, 2 days
held out, as ``tests/test_serve.py`` draws it).

* ``plan``: the port's ``predicted_pool`` solves the forecaster's normal
  equations in a whitened basis, so each tick is held within 1e-4 of the
  pool's peak, the free pool's own tolerance
  (``tests/test_torch_freepool.py``).
* ``step`` and ``run``: host-side integer bookkeeping, equal bit for bit
  on the same targets, tick by tick (warm replicas, cold starts in flight,
  every stat).
* The reference's three ``TestAutoscaler`` properties, on the port.
"""

import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import demand as jdm  # noqa: E402
from repro.serve import autoscaler as jas  # noqa: E402
from repro_torch.core import freepool as tfp  # noqa: E402
from repro_torch.serve import autoscaler as tas  # noqa: E402

POOL_RTOL = 1e-4


@pytest.fixture(scope="module")
def demand():
    n_hist, n_fut = 24 * 21, 24 * 2
    f = np.asarray(jdm.synth_demand(
        n_hist + n_fut, jdm.DemandConfig(base_level=20.0, annual_growth=0.2),
        key=jax.random.PRNGKey(0)))
    return f[:n_hist], f[n_hist:]


def _port(**kw):
    return tas.FreePoolAutoscaler(tas.AutoscalerConfig(**kw), device="cpu")


def test_config_defaults_match_the_reference():
    ref, port = jas.AutoscalerConfig(), tas.AutoscalerConfig()
    assert dataclasses.asdict(ref) == dataclasses.asdict(port)
    assert (dataclasses.asdict(jas.AutoscalerStats())
            == dataclasses.asdict(tas.AutoscalerStats()))


@pytest.mark.parametrize("lead", [0, 1, 3])
def test_plan_matches_the_reference(demand, lead):
    hist, fut = demand
    pool = tfp.FreePoolConfig(lead_time=lead)
    want = jas.FreePoolAutoscaler(jas.AutoscalerConfig(
        pool=jas.fp.FreePoolConfig(lead_time=lead))).plan(hist, len(fut))
    got = tas.FreePoolAutoscaler(tas.AutoscalerConfig(pool=pool),
                                 device="cpu").plan(hist, len(fut))
    assert got.shape == want.shape == (len(fut),)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=POOL_RTOL * float(np.max(want)))


def test_step_sequence_bit_for_bit(demand):
    """Every tick's state on the reference's targets, the cold-start
    latency exercised by scaling up and down."""
    hist, fut = demand
    targets = jas.FreePoolAutoscaler(jas.AutoscalerConfig()).plan(
        hist, len(fut))
    # a ramp that scales up past the pending starts and back down
    targets = np.concatenate([targets, targets[::-1] * 0.5, targets * 1.3])
    load = np.concatenate([fut, fut[::-1], fut * 1.1])
    ref = jas.FreePoolAutoscaler(jas.AutoscalerConfig(provision_latency=2))
    port = _port(provision_latency=2)
    for t, d in zip(targets, load):
        ref.step(float(t), float(d))
        port.step(float(t), float(d))
        assert (port.warm, port.pending) == (ref.warm, ref.pending)
        assert dataclasses.asdict(port.stats) == dataclasses.asdict(
            ref.stats)


@pytest.mark.parametrize("static", [None, "p50", "max"])
def test_run_stats_bit_for_bit(demand, static, monkeypatch):
    """``run`` on the same targets: the reference's plan handed to both
    (the port's ``plan`` patched to return it), or a static size."""
    hist, fut = demand
    want_plan = jas.FreePoolAutoscaler(jas.AutoscalerConfig()).plan(
        hist, len(fut))
    size = {None: None, "p50": float(np.percentile(hist, 50)),
            "max": float(hist.max() * 1.2)}[static]
    ref = jas.FreePoolAutoscaler(jas.AutoscalerConfig())
    ref.run(hist, fut, static_size=size)
    port = _port()
    monkeypatch.setattr(port, "plan", lambda h, n: np.asarray(want_plan))
    port.run(hist, fut, static_size=size)
    assert dataclasses.asdict(port.stats) == dataclasses.asdict(ref.stats)


def test_predicted_beats_static_minimum(demand):
    hist, fut = demand
    pred = _port()
    pred.run(hist, fut)
    static_low = _port()
    static_low.run(hist, fut, static_size=float(np.percentile(hist, 50)))
    assert pred.stats.slo_misses < static_low.stats.slo_misses


def test_predicted_cheaper_than_static_max(demand):
    hist, fut = demand
    pred = _port()
    pred.run(hist, fut)
    static_hi = _port()
    static_hi.run(hist, fut, static_size=float(hist.max() * 1.2))
    assert pred.stats.replica_ticks < static_hi.stats.replica_ticks


def test_provisioning_latency_respected():
    auto = _port(provision_latency=3)
    auto.step(target=5.0, demand=0.0)
    assert auto.warm == 0          # cold starts take 3 ticks
    auto.step(target=5.0, demand=5.0)
    assert auto.stats.slo_misses == 5  # demand while cold is missed
    auto.step(target=5.0, demand=0.0)
    auto.step(target=5.0, demand=5.0)
    assert auto.warm == 5          # now warm
    assert auto.stats.slo_misses == 5  # warm demand served


def test_plan_defaults_to_the_card():
    """``device=None`` is the card: without one, ``plan`` raises rather
    than running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    auto = tas.FreePoolAutoscaler(tas.AutoscalerConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        auto.plan(np.ones(24 * 21, np.float32), 48)
