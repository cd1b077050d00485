"""The port's dataset loader, efficiency events and §2.2 statistics against
the JAX package's.

The loader is host numpy on both sides: on every CSV (written here, in the
released dataset's schema) the arrays must be equal.  The statistics run
in float32 on both sides and agree within rel 1e-5 (reductions in other
orders).
"""

import csv

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import demand as jdm  # noqa: E402
from repro.data import traces as jtr  # noqa: E402
from repro_torch.core import demand as tdm  # noqa: E402
from repro_torch.data import traces as ttr  # noqa: E402

REL = 1e-5
FIELDS = ["timestamp", "cloud", "region", "machine_type", "normalized_count"]


def _write_csv(path, rows):
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=FIELDS)
        w.writeheader()
        for r in rows:
            w.writerow(dict(zip(FIELDS, r)))


def _ts(h, minute=0):
    return f"2023-01-{1 + h // 24:02d}T{h % 24:02d}:{minute:02d}:00"


def _ragged_rows():
    rows = [(_ts(h), "aws", "r0", "m1", 1.0 + h) for h in range(48)]
    rows += [(_ts(h), "gcp", "r1", "n2", 5.0) for h in range(12, 30)]
    rows += [(_ts(40), "azure", "r2", "d4", 2.5)]          # one-row pool
    return rows


def _cases():
    dup = _ragged_rows() + [(_ts(13), "gcp", "r1", "n2", 1.25),
                            (_ts(13), "gcp", "r1", "n2", 0.5)]
    snapped = _ragged_rows() + [(_ts(20, 30), "aws", "r0", "m1", 3.0)]
    half_hour = [(f"2023-01-01T{h // 2:02d}:{30 * (h % 2):02d}:00", "aws",
                  "r0", "m1", 3.0) for h in range(8)]
    non_iso = [(f"week {w:02d} hour {h}", c, "r0", "m", 1.0 + w + h)
               for w in range(3) for h in range(2) for c in ("aws", "gcp")]
    gap = [(_ts(h), "aws", "r0", "m1", float(h)) for h in range(30)
           if not 10 <= h < 14]
    return {"ragged": _ragged_rows(), "duplicates": dup,
            "snapped_sub_hour": snapped, "half_hour_cadence": half_hour,
            "non_iso": non_iso, "global_gap": gap}


@pytest.mark.parametrize("case", sorted(_cases()))
def test_load_dataset_csv_equals_reference(tmp_path, case):
    path = tmp_path / f"{case}.csv"
    _write_csv(path, _cases()[case])
    want = jtr.load_dataset_csv(str(path))
    got = ttr.load_dataset_csv(str(path))
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype == np.float32
        np.testing.assert_array_equal(got[key], want[key], err_msg=str(key))
    pools = tdm.PoolSet.from_dict(got)
    assert pools.demand.shape == jdm.PoolSet.from_dict(want).demand.shape


def test_empty_csv_raises(tmp_path):
    path = tmp_path / "empty.csv"
    _write_csv(path, [])
    with pytest.raises(ValueError, match="no rows"):
        ttr.load_dataset_csv(str(path))
    with pytest.raises(ValueError, match="zero pools"):
        tdm.PoolSet.from_dict({})


def test_time_index_equals_reference():
    stamps = {_ts(h) for h in range(0, 30, 3)} | {_ts(7, 30)}
    assert ttr._time_index(stamps) == jtr._time_index(stamps)
    assert ttr.DATASET_ENV == jtr.DATASET_ENV


def test_load_pool_set_reads_the_dataset_env(tmp_path, monkeypatch):
    path = tmp_path / "dataset.csv"
    _write_csv(path, _ragged_rows())
    monkeypatch.setenv(ttr.DATASET_ENV, str(path))
    got, want = ttr.load_pool_set(), jtr.load_pool_set()
    assert got.keys == want.keys
    np.testing.assert_array_equal(got.demand, want.demand)
    assert sorted(ttr.load_pools()) == sorted(jtr.load_pools())
    # a path that does not exist falls back to the synthetic fleet
    monkeypatch.setenv(ttr.DATASET_ENV, str(tmp_path / "missing.csv"))
    fleet = ttr.load_pool_set(num_pools=3, num_hours=48)
    assert fleet.keys == jtr.load_pool_set(num_pools=3, num_hours=48).keys
    assert len(ttr.load_pools(num_pools=2, num_hours=24)) == 2


@pytest.fixture(scope="module")
def trace():
    return np.array(jdm.synth_demand(
        24 * 7 * 9, key=jax.random.PRNGKey(3)))


def test_apply_efficiency_events(trace):
    hours, gains = (100, 600, 1300), (0.25, 0.1, -0.05)
    want = jdm.apply_efficiency_events(jnp.asarray(trace), hours, gains)
    got = tdm.apply_efficiency_events(torch.from_numpy(trace), hours, gains)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=REL)


@pytest.mark.parametrize("name", ["hourly_to_daily", "weekly_peak_trough_ratio",
                                  "diurnal_peak_trough_ratio",
                                  "week_over_week_growth"])
def test_statistics(trace, name):
    x = np.stack([trace, trace[::-1] * 0.5 + 3.0])[:, :-5]   # ragged tail
    want = getattr(jdm, name)(jnp.asarray(x))
    got = getattr(tdm, name)(torch.from_numpy(x.copy()))
    # growth is a ratio minus one: its absolute error is the ratio's relative
    tol = dict(atol=REL) if name == "week_over_week_growth" else dict(rtol=REL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


@pytest.mark.parametrize("lag", [0, 1, 7, 24])
def test_autocorrelation(trace, lag):
    want = jdm.autocorrelation(jnp.asarray(trace), lag)
    got = tdm.autocorrelation(torch.from_numpy(trace), lag)
    assert float(got) == pytest.approx(float(want), rel=REL)


def test_characterize(trace):
    want = jdm.characterize(trace)
    got = tdm.characterize(trace, device="cpu")
    assert sorted(got) == sorted(want)
    for key, val in want.items():
        assert got[key] == pytest.approx(val, rel=REL, abs=1e-7), key


def test_characterize_needs_a_device_without_a_card(trace):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tdm.characterize(trace)
