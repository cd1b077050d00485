"""The revocation walk: the port's plain per-hour loop (the CUDA kernel's
CPU path and spec) against the JAX package's compiled scan and its python
loop, on the JAX package's own draws.

Random streams differ between ``jax.random`` and ``torch.Generator``, so
the draws (``draw_noise`` of the reference) are handed to both packages as
arrays.  Tolerances, as the reference states them
(``repro/capacity/preemption.py``, ``revocation_walk_loop``):

* states and interruptions bit for bit: they depend only on comparisons
  of the same uniforms;
* prices within 1e-6 of the scan (it may fuse the AR(1) update into a
  multiply-add), bit for bit against the reference's python loop, which
  rounds every step as the port does.

The kernel itself only runs on the card: chip_smoke.py's ``walk`` phase
holds it to this plain version there, bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.capacity import preemption as jpe  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.capacity import preemption as tpe  # noqa: E402
from repro_torch.kernels.revocation_walk import ops  # noqa: E402
from repro_torch.kernels.revocation_walk import revocation_walk as tker  # noqa: E402
from repro_torch.kernels.revocation_walk.ref import revocation_walk_ref  # noqa: E402

PRICE_TOL = 1e-6
FIELDS = ("available", "interrupted", "price")
CLOUDS = ("aws", "gcp", "azure", "aws", "gcp", "azure", "aws")


def _draws(clouds, hours, draws, seed):
    jp = jpe.params_for_clouds(list(clouds))
    noise = jpe.draw_noise(jp, hours, draws, jax.random.PRNGKey(seed))
    return jp, noise, tuple(torch.tensor(np.asarray(x)) for x in noise)


@pytest.mark.parametrize("hours,draws,seed", [
    (1, 3, 0), (9, 2, 1), (300, 4, 2), (1001, 3, 3),
])
def test_plain_walk_equals_reference_scan_and_loop(hours, draws, seed):
    jp, jnoise, tnoise = _draws(CLOUDS, hours, draws, seed)
    tp = tpe.params_for_clouds(CLOUDS, device="cpu")
    got = tpe.revocation_walk(tp, *tnoise)
    plain = tpe.revocation_walk_loop(tp, *tnoise)
    scan = jpe.revocation_walk(jp, *jnoise)
    loop = jpe.revocation_walk_loop(jp, *jnoise)
    for field in FIELDS:
        a = getattr(got, field).numpy()
        assert a.shape == (draws, len(CLOUDS), hours)
        np.testing.assert_array_equal(a, getattr(plain, field).numpy())
        np.testing.assert_array_equal(a, np.asarray(getattr(loop, field)))
        want = np.asarray(getattr(scan, field))
        if field == "price":
            np.testing.assert_allclose(a, want, rtol=0, atol=PRICE_TOL)
        else:
            np.testing.assert_array_equal(a, want)


@pytest.mark.parametrize("start", [0.0, 1.0])
def test_uniform_starts_equal_reference(start):
    """Every lane starting revoked, and every lane starting available."""
    jp, (a0, us, zs), (_, tus, tzs) = _draws(CLOUDS, 200, 3, 5)
    a0 = np.full(np.asarray(a0).shape, start, np.float32)
    got = tpe.revocation_walk(tpe.params_for_clouds(CLOUDS, device="cpu"),
                              torch.tensor(a0), tus, tzs)
    want = jpe.revocation_walk_loop(jp, a0, us, zs)
    for field in FIELDS:
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)))


def test_hazard_zero_recovery_one_stays_up():
    _, _, (a0, us, zs) = _draws(CLOUDS, 50, 2, 6)
    p = len(CLOUDS)
    params = tpe.PreemptionParams(
        torch.zeros(p), torch.ones(p), torch.full((p,), 0.5),
        torch.full((p,), 0.1))
    paths = tpe.revocation_walk(params, torch.zeros_like(a0), us, zs)
    assert bool(paths.available.all())
    assert not bool(paths.interrupted.any())


def test_outputs_are_views_of_hour_major_storage():
    """The walk writes (T, N, P), the layout a warp's lanes read and write
    coalesced, and hands out (N, P, T) views without a copy."""
    _, _, tnoise = _draws(CLOUDS, 20, 2, 7)
    tp = tpe.params_for_clouds(CLOUDS, device="cpu")
    raw = revocation_walk_ref(tp.hazard, tp.recovery, tp.price_band,
                              *tnoise)
    views = ops.revocation_walk(tp.hazard, tp.recovery, tp.price_band,
                                *tnoise)
    for r, v in zip(raw, views):
        assert r.shape == (20, 2, len(CLOUDS)) and r.is_contiguous()
        assert v.shape == (2, len(CLOUDS), 20)
        torch.testing.assert_close(v, r.movedim(0, -1), rtol=0, atol=0)


def test_params_and_process_constants_equal_reference():
    jp = jpe.params_for_clouds(list(CLOUDS))
    tp = tpe.params_for_clouds(CLOUDS, device="cpu")
    conv = convert.preemption_params_from_reference(jp)
    for name in ("hazard", "recovery", "discount", "price_band"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                      np.asarray(getattr(jp, name)))
        np.testing.assert_array_equal(getattr(conv, name).numpy(),
                                      np.asarray(getattr(jp, name)))
    np.testing.assert_allclose(tpe.stationary_availability(tp).numpy(),
                               np.asarray(jpe.stationary_availability(jp)),
                               rtol=1e-6)
    np.testing.assert_allclose(tpe.interruption_rate(tp).numpy(),
                               np.asarray(jpe.interruption_rate(jp)),
                               rtol=1e-6)
    with pytest.raises(KeyError, match="oracle"):
        tpe.params_for_clouds(["aws", "oracle"], device="cpu")


def test_path_statistics_and_requeue_equal_reference():
    jp, jnoise, tnoise = _draws(CLOUDS, 400, 4, 8)
    jpaths = jpe.revocation_walk_loop(jp, *jnoise)
    tpaths = tpe.revocation_walk(
        tpe.params_for_clouds(CLOUDS, device="cpu"), *tnoise)
    np.testing.assert_allclose(tpaths.availability(),
                               jpaths.availability(), rtol=1e-6)
    np.testing.assert_allclose(tpaths.interruptions_per_hour(),
                               jpaths.interruptions_per_hour(), rtol=1e-6)
    usage = np.random.default_rng(0).gamma(2.0, 3.0, (len(CLOUDS), 400))
    usage = usage.astype(np.float32)
    np.testing.assert_allclose(
        tpe.requeue_cost_hours(tpaths, torch.tensor(usage), 2.0).numpy(),
        np.asarray(jpe.requeue_cost_hours(jpaths, usage, 2.0)), rtol=1e-5)


def test_own_draws_match_the_process_on_distribution():
    """The port's generator draws other numbers than jax.random, so its
    paths are held to the process: empirical availability and revocation
    rate near the stationary ones, prices inside the band with mean ~1
    (the reference's own checks, tests/test_spot.py)."""
    tp = tpe.params_for_clouds(["aws", "azure", "gcp"], device="cpu")
    gen = torch.Generator().manual_seed(0)
    paths = tpe.simulate_revocations(tp, 24 * 7 * 26, num_draws=64,
                                     generator=gen)
    np.testing.assert_allclose(paths.availability(),
                               tpe.stationary_availability(tp).numpy(),
                               atol=0.01)
    np.testing.assert_allclose(paths.interruptions_per_hour(),
                               tpe.interruption_rate(tp).numpy(), rtol=0.1)
    band = tp.price_band[None, :, None]
    assert bool((paths.price >= 1.0 - band - 1e-6).all())
    assert bool((paths.price <= 1.0 + band + 1e-6).all())
    assert float((paths.price.mean() - 1.0).abs()) < 0.01
    again = tpe.simulate_revocations_loop(
        tp, 24 * 7 * 26, num_draws=64,
        generator=torch.Generator().manual_seed(0))
    for field in FIELDS:
        assert torch.equal(getattr(paths, field), getattr(again, field))


def test_default_generator_stays_on_the_params_device():
    """With no generator the walk draws from one seeded 0 on the
    parameters' own device; the parameters are never moved."""
    tp = tpe.params_for_clouds(CLOUDS, device="cpu")
    for walk in (tpe.simulate_revocations, tpe.simulate_revocations_loop):
        got = walk(tp, 30, num_draws=3)
        want = walk(tp, 30, num_draws=3,
                    generator=torch.Generator().manual_seed(0))
        for field in FIELDS:
            assert getattr(got, field).device == tp.hazard.device
            assert torch.equal(getattr(got, field), getattr(want, field))
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="generator on cuda"):
            tpe.simulate_revocations(
                tp, 30, generator=torch.Generator(device="cuda"))


def test_cuda_wrapper_takes_cuda_tensors_only():
    """On a CPU tensor the kernel's wrapper raises instead of running
    anything; ops sends CPU tensors to the plain version and refuses
    tensors split across devices."""
    _, _, (a0, us, zs) = _draws(CLOUDS, 5, 2, 9)
    tp = tpe.params_for_clouds(CLOUDS, device="cpu")
    before = tker.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        tker.revocation_walk_cuda(tp.hazard, tp.recovery, tp.price_band,
                                  a0, us, zs)
    with pytest.raises(TypeError, match="float32"):
        tker.revocation_walk_cuda(tp.hazard, tp.recovery, tp.price_band,
                                  a0, us.double(), zs)
    with pytest.raises(ValueError, match="different devices"):
        ops.revocation_walk(tp.hazard, tp.recovery, tp.price_band,
                            a0.to("meta"), us, zs)
    assert tker.LAUNCHES == before
