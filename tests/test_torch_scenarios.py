"""Scenario families (``data.scenarios``): the PyTorch port against the JAX
package.

* ``scenario_batch`` (the perturbation families behind ``scenarios=``) bit
  for bit with the reference for every family and several seeds, its rows
  built on the CPU device; a scenario built alone equals its row of the
  batch; the port's numpy ``_perturb`` equals the reference's rows; the
  growth ramp's guard keeps the bits when the float64 ``exp`` is off in
  its last bits.
* ``ScenarioConfig`` and ``resolve_scenarios`` validate as the reference
  does.
* The tournament families: ``_transform`` on the reference's own
  ``synth_demand`` rows is bit for bit (shared numpy streams); the port's
  paths draw their noise from ``torch.Generator`` (the reference's from
  ``jax.random``), so each family's defining property is held per seed at
  the thresholds of the reference's ``tests/test_scenarios.py::
  TestFamilyProperties``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.core  # noqa: E402,F401  (the reference package's import order)
from repro.core import demand as jdm  # noqa: E402
from repro.data import scenarios as jsc  # noqa: E402
from repro.data import traces as jtr  # noqa: E402
from repro_torch.data import scenarios as tsc  # noqa: E402

WK = 168
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def demand():
    """5 pools x 60 weeks of the reference's synthetic demand."""
    return np.asarray(
        jtr.synthetic_pool_set(num_pools=5, num_hours=60 * WK).demand,
        np.float32)


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


@pytest.mark.parametrize("seed", [0, 3, 11])
@pytest.mark.parametrize("family", jsc.PERTURBATIONS)
def test_scenario_batch_bit_for_bit(demand, family, seed):
    want = jsc.scenario_batch(demand, jsc.ScenarioConfig(
        n_scenarios=4, family=family, seed=seed))
    got = tsc.scenario_batch(demand, tsc.ScenarioConfig(
        n_scenarios=4, family=family, seed=seed), device=CPU)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("family", jsc.PERTURBATIONS)
def test_single_scenario_built_alone(demand, family):
    cfg = tsc.ScenarioConfig(n_scenarios=5, family=family, seed=2)
    batch = tsc.scenario_batch(demand, cfg, device=CPU)
    for s in (0, 3, 4):
        alone = tsc.scenario_block(demand, cfg, s, s + 1, device=CPU)
        np.testing.assert_array_equal(_bits(alone[0]), _bits(batch[s]))
    chunk = tsc.scenario_block(demand, cfg, 1, 4, device=CPU)
    np.testing.assert_array_equal(_bits(chunk), _bits(batch[1:4]))
    with pytest.raises(ValueError, match="out of range"):
        tsc.scenario_block(demand, cfg, 4, 6, device=CPU)


@pytest.mark.parametrize("family", jsc.PERTURBATIONS)
def test_plain_perturb_equals_reference_rows(demand, family):
    want = jsc.scenario_batch(demand, jsc.ScenarioConfig(
        n_scenarios=3, family=family, seed=5))
    for s in (1, 2):
        rows = np.stack([
            tsc._perturb(family, demand[p], tsc._rng(family, 5, s, p))
            for p in range(demand.shape[0])]).astype(np.float32)
        np.testing.assert_array_equal(_bits(rows), _bits(want[s]))


@pytest.mark.parametrize("ulps,guard", [(1, None), (4, None),
                                        (4, 2.0 ** -30)])
def test_growth_guard_keeps_the_bits_under_another_exp(demand, monkeypatch,
                                                       ulps, guard):
    """A float64 exp a few ulps off (another library's last bits) still
    gives the reference's float32 batch: the products near a float32
    rounding boundary are recomputed with numpy's exp.  A wider guard
    (2^-30: ~1/64 of the elements) runs that host recomputation on
    thousands of elements."""
    if guard is not None:
        monkeypatch.setattr(tsc, "_GROWTH_GUARD", guard)
    cfg = dict(n_scenarios=6, family="growth", seed=1)
    want = jsc.scenario_batch(demand, jsc.ScenarioConfig(**cfg))
    exp = torch.exp

    def off_exp(x):
        out = exp(x)
        for _ in range(ulps):
            out = torch.nextafter(out, out.new_tensor(np.inf))
        return out

    monkeypatch.setattr(torch, "exp", off_exp)
    got = tsc.scenario_batch(demand, tsc.ScenarioConfig(**cfg), device=CPU)
    monkeypatch.setattr(torch, "exp", exp)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_rounding_guard_flags_boundaries():
    """``_round_f32`` flags float64 values within 64 ulps of the midpoint
    between two float32 neighbours, and no value farther away."""
    lo = np.float32(1.5)
    hi = np.nextafter(lo, np.float32(2.0))
    mid = (np.float64(lo) + np.float64(hi)) / 2
    ulp = np.spacing(mid)
    vals = np.array([mid, mid + 10 * ulp, mid - 60 * ulp, mid + 200 * ulp,
                     np.float64(lo), mid - 1e6 * ulp], np.float64)
    out, near = tsc._round_f32(torch.from_numpy(vals))
    assert near.tolist() == [True, True, True, False, False, False]
    np.testing.assert_array_equal(out.numpy(), vals.astype(np.float32))


def test_config_validation_matches_reference():
    for kw, match in (({"n_scenarios": 0}, "n_scenarios"),
                      ({"family": "chaotic"}, "unknown scenario family"),
                      ({"chunk": 0}, "chunk")):
        for mod in (jsc, tsc):
            with pytest.raises(ValueError, match=match):
                mod.ScenarioConfig(**kw)
    assert tsc.PERTURBATIONS == jsc.PERTURBATIONS
    assert tsc.FAMILIES == jsc.FAMILIES


def test_resolve_spellings_match_reference():
    assert tsc.resolve_scenarios(None) is None
    assert tsc.resolve_scenarios(5) == tsc.ScenarioConfig(n_scenarios=5)
    cfg = tsc.ScenarioConfig(n_scenarios=3, family="burst", chunk=2)
    assert tsc.resolve_scenarios(cfg) is cfg
    for bad, match in ((True, "bool"), (False, "bool"), ("many", "got str"),
                       (2.0, "got float")):
        for mod in (jsc, tsc):
            with pytest.raises(TypeError, match=match):
                mod.resolve_scenarios(bad)


@pytest.mark.parametrize("family", jsc.FAMILIES)
def test_transform_bit_for_bit_on_reference_rows(family):
    """The reference's own driver rows (its jax.random noise) through both
    packages' family transforms, with the shared numpy streams."""
    fam_idx = jsc.FAMILIES.index(family)
    for seed in (0, 4):
        for p in range(3):
            y = np.asarray(jdm.synth_demand(
                20 * WK, jsc._family_config(family, p),
                key=jax.random.PRNGKey(100_000 * fam_idx + 100 * seed + p)))
            want = jsc._transform(family, y,
                                  np.random.default_rng((fam_idx, seed, p)))
            got = tsc._transform(family, y,
                                 np.random.default_rng((fam_idx, seed, p)))
            np.testing.assert_array_equal(
                _bits(np.asarray(got).astype(np.float32)),
                _bits(np.asarray(want).astype(np.float32)))


@pytest.mark.parametrize("family", jsc.FAMILIES)
def test_family_configs_and_keys_match_reference(family):
    for p in range(4):
        want, got = jsc._family_config(family, p), tsc._family_config(
            family, p)
        for name in ("base_level", "annual_growth", "diurnal_amplitude",
                     "weekly_amplitude", "noise_sigma", "holiday_drop"):
            assert getattr(got, name) == getattr(want, name), name
    assert tsc.scenario_keys(7) == jsc.scenario_keys(7)


def _weekly_means(path):
    p, t = path.shape
    return path.reshape(p, t // WK, WK).mean(-1)


def _cv(path):
    wm = _weekly_means(path)
    return float((wm.std(-1) / wm.mean(-1)).mean())


def _lag_autocorr(x, lag):
    a, b = x[..., :-lag], x[..., lag:]
    a = a - a.mean(-1, keepdims=True)
    b = b - b.mean(-1, keepdims=True)
    return float(((a * b).mean(-1) / (a.std(-1) * b.std(-1) + 1e-12)).mean())


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_family_properties(seed):
    """Each family's defining property on the port's own paths, at the
    reference's thresholds (TestFamilyProperties)."""
    path = {f: tsc.scenario_path(f, num_weeks=24, seed=seed)
            for f in tsc.FAMILIES}
    steady = path["steady"]
    assert _cv(steady) < 0.15

    def exceed(p):
        return int((p > 1.8 * np.median(p, axis=-1, keepdims=True)).sum())

    burst = path["burst"]
    assert 6 <= exceed(burst) < 0.1 * burst.size
    assert exceed(burst) > exceed(steady)
    ac_c = _lag_autocorr(path["cyclic"], WK)
    assert ac_c > 0.4 and ac_c > _lag_autocorr(steady, WK)
    wm = _weekly_means(path["declining"]).mean(0)
    sm = _weekly_means(steady).mean(0)
    assert wm[-8:].mean() < 0.7 * wm[:8].mean()
    assert sm[-8:].mean() > 0.9 * sm[:8].mean()
    assert _cv(path["unpredictable"]) > max(0.15, _cv(steady))


def test_path_contract():
    path = tsc.scenario_path("steady", num_pools=4, num_weeks=10, seed=3)
    assert path.shape == (4, 10 * WK) and path.dtype == np.float32
    assert (path >= 0).all() and np.isfinite(path).all()
    paths = tsc.scenario_paths("cyclic", num_pools=2, num_weeks=8,
                               num_seeds=3, base_seed=4)
    assert paths.shape == (3, 2, 8 * WK)
    for s in range(3):
        np.testing.assert_array_equal(
            paths[s], tsc.scenario_path("cyclic", num_pools=2, num_weeks=8,
                                        seed=4 + s))
    assert not np.array_equal(paths[0], paths[1])
    ps = tsc.scenario_pool_set("burst", num_pools=3, num_weeks=8, seed=2)
    np.testing.assert_array_equal(
        ps.demand, tsc.scenario_path("burst", num_pools=3, num_weeks=8,
                                     seed=2))
    assert ps.keys == tsc.scenario_keys(3) and len(ps.configs) == 3
    with pytest.raises(ValueError, match="unknown family"):
        tsc.scenario_path("spiky", num_weeks=8)


def test_path_levels_match_reference_on_distribution():
    """The noise differs in its draws only: each family's mean level and
    weekly variation over 8 seeds within 5% / 0.03 of the reference's."""
    for family in jsc.FAMILIES:
        want = jsc.scenario_paths(family, num_weeks=12, num_seeds=8)
        got = tsc.scenario_paths(family, num_weeks=12, num_seeds=8)
        assert got.mean() == pytest.approx(want.mean(), rel=0.05), family
        assert np.mean([_cv(p) for p in got]) == pytest.approx(
            np.mean([_cv(p) for p in want]), abs=0.03), family
