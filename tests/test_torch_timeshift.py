"""Paper §4's time shifting in the PyTorch port (``core/timeshift.py``,
``capacity/scheduler.py``) against the JAX package, on the same
numpy-seeded demand traces.

* ``schedule_jobs``, ``schedule`` and ``shiftable_supply_stats`` are host
  numpy in both packages, the port's a copy: bit for bit, placements
  included.
* ``shift_demand``'s water-fill runs on the tensor's device in both, in
  float32 with sums in another order: each hour within 1e-6 of the
  trace's peak (measured ~6e-8), and the total conserved to rel 1e-6 of
  the input's float64 total, the over-full budget of
  ``tests/test_planner.py::test_fluid_shift_overfull_budget_stays_finite``
  among the cases.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.capacity import scheduler as jsch  # noqa: E402
from repro.core import commitment as jcm  # noqa: E402
from repro.core import demand as jdm  # noqa: E402
from repro.core import timeshift as jts  # noqa: E402
from repro_torch.capacity import scheduler as tsch  # noqa: E402
from repro_torch.core import commitment as tcm  # noqa: E402
from repro_torch.core import demand as tdm  # noqa: E402
from repro_torch.core import timeshift as tts  # noqa: E402

WK = 168
HOUR_TOL = 1e-6       # shift_demand per hour, of the trace's peak
CONSERVE_RTOL = 1e-6  # shift_demand's total against the input's


def _trace(weeks, seed, sigma=0.05, **cfg):
    """The noise-free synthetic profile (the same in both packages) times
    numpy-seeded multiplicative noise, float32."""
    base = np.asarray(jdm.synth_demand(weeks * WK, jdm.DemandConfig(
        noise_sigma=0.0, **cfg)))
    rng = np.random.default_rng(seed)
    return (base * (1.0 + sigma * rng.standard_normal(base.shape))
            ).astype(np.float32)


def _level(f):
    return float(jcm.optimal_commitment_quantile(jnp.asarray(f)))


def _job_tuple(j):
    return (j.arrival, j.work, j.deadline, j.interruptible, j.deferrable)


def _jobs(pkg, f, n, frac=0.05):
    work = float(f.sum() * frac / n)
    out = [pkg.Job(arrival=int(h), work=work, deadline=int(h) + WK)
           for h in np.linspace(0, len(f) - WK - 1, n)]
    # one job of each other kind: pinned to its arrival, and one that
    # must run in one slice (it falls back to its arrival hour)
    out.append(pkg.Job(arrival=30, work=40.0, deadline=90, deferrable=False))
    out.append(pkg.Job(arrival=50, work=500.0, deadline=200,
                       interruptible=False))
    return out


@pytest.mark.parametrize("weeks,n_jobs,seed,dtype", [
    (4, 4, 0, np.float64), (12, 12, 1, np.float32)])
def test_schedule_jobs_bit_for_bit(weeks, n_jobs, seed, dtype):
    f = _trace(weeks, seed).astype(dtype)
    c = _level(f)
    want = jts.schedule_jobs(f, c, _jobs(jts, f, n_jobs))
    got = tts.schedule_jobs(f, c, _jobs(tts, f, n_jobs))
    np.testing.assert_array_equal(got["demand"], want["demand"])
    assert [(_job_tuple(j), s) for j, s in got["placements"]] == [
        (_job_tuple(j), s) for j, s in want["placements"]]
    for key in ("on_demand_cost_naive", "on_demand_cost_shifted",
                "on_demand_savings"):
        assert got[key] == want[key], key
    assert got["on_demand_savings"] >= 0.0
    work = sum(j.work for j in _jobs(tts, f, n_jobs))
    np.testing.assert_allclose(got["demand"].sum(dtype=np.float64),
                               f.sum(dtype=np.float64) + work, rtol=1e-6)


def test_schedule_bit_for_bit():
    base = _trace(1, 3, base_level=100.0, annual_growth=0.0)
    c = float(np.asarray(jcm.optimal_commitment_quantile(
        jnp.asarray(base))))
    assert tsch.FRAMEWORK_WORKLOADS == jsch.FRAMEWORK_WORKLOADS
    for off in (0, 24):
        tw, jw = tsch.default_workloads(off), jsch.default_workloads(off)
        assert [dataclasses.asdict(w) for w in tw] == [
            dataclasses.asdict(w) for w in jw]
        got = tsch.schedule(base, c, tw)
        want = jsch.schedule(base, c, jw)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.savings >= 0.0
    assert set(got.placements) == {w.name for w in tw}
    for name, slices in got.placements.items():
        assert sum(w for _, w in slices) > 0, name


@pytest.mark.parametrize("case", ["half", "overfull", "light", "none"])
def test_shift_demand_matches_reference(case):
    f = _trace(8, 4)
    c = _level(f)
    c, frac = {"half": (c, 0.5), "overfull": (float(f.min()) + 0.5, 0.9),
               "light": (c, 0.3), "none": (c, 0.0)}[case]
    want = np.asarray(jts.shift_demand(jnp.asarray(f), c, frac))
    got = tts.shift_demand(torch.from_numpy(f.copy()), c, frac)
    assert got.dtype == torch.float32 and got.shape == f.shape
    got = got.numpy()
    peak = float(np.abs(f).max())
    assert np.abs(got - want).max() <= HOUR_TOL * peak
    total = f.astype(np.float64).sum()
    assert abs(got.astype(np.float64).sum() / total - 1) <= CONSERVE_RTOL
    assert np.isfinite(got).all()
    assert got.max() <= f.max() * 1.01
    if frac > 0 and case != "overfull":
        # shifting flattens the peak above the line
        assert np.maximum(got - c, 0).sum() < np.maximum(f - c, 0).sum()


def test_shift_demand_overfull_budget_on_own_trace():
    """``tests/test_planner.py::test_fluid_shift_overfull_budget_stays_finite``
    on the port's own noise-free trace: the fill is capped at the room and
    the excess stays on the timeline."""
    f = tdm.synth_demand(WK, tdm.DemandConfig(annual_growth=0.0,
                                              noise_sigma=0.0))
    g = tts.shift_demand(f, float(f.min()) + 0.5, 0.9)
    assert bool(torch.isfinite(g).all())
    assert float(g.max()) <= float(f.max()) * 1.01
    assert abs(float(g.double().sum()) / float(f.double().sum()) - 1) <= (
        CONSERVE_RTOL)


@pytest.mark.parametrize("weeks,seed", [(4, 5), (52, 6)])
def test_shiftable_supply_stats_bit_for_bit(weeks, seed):
    f = _trace(weeks, seed)
    c = _level(f)
    assert tts.shiftable_supply_stats(f, c) == jts.shiftable_supply_stats(f, c)
    np.testing.assert_array_equal(tts.trough_capacity(f, c),
                                  jts.trough_capacity(f, c))


def test_weekend_troughs_on_own_trace():
    """``tests/test_planner.py::test_shiftable_supply_weekend_concentration``
    with the port's own level: weekends hold most of the trough."""
    f = tdm.synth_demand(4 * WK, tdm.DemandConfig(annual_growth=0.0,
                                                  noise_sigma=0.0))
    c = float(tcm.optimal_commitment_quantile(f))
    stats = tts.shiftable_supply_stats(f.numpy(), c)
    assert stats["weekend_share"] > 0.5
    assert 0.0 < stats["unused_frac"] < 0.2
