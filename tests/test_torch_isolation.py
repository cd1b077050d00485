"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, keeps its own data, and its synthetic demand agrees with the
reference's — exactly without noise, on distribution with it (``jax.random``
and ``torch.Generator`` draw different numbers from one seed).
"""

import ast
import json
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import demand as jdm  # noqa: E402
from repro.data import traces as jtr  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import demand as tdm  # noqa: E402
from repro_torch.data import traces as ttr  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
PORT = SRC / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_modules():
    import repro_torch
    return sorted(
        m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, prefix="repro_torch.")
    )


def test_importing_the_port_loads_no_jax_and_no_reference():
    mods = ["repro_torch"] + _port_modules()
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(json.dumps(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True,
        text=True, check=True,
    )
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    assert "repro_torch.core.replan" in mods
    assert "repro_torch.kernels.commitment_sweep.commitment_sweep" in mods
    for name in ("repro_torch.serve.engine", "repro_torch.models.model",
                 "repro_torch.models.rwkv", "repro_torch.models.transformer",
                 "repro_torch.configs",
                 "repro_torch.data.scenarios", "repro_torch.core.tournament",
                 "repro_torch.core.policy",
                 "repro_torch.kernels.flash_attention.flash_attention",
                 "repro_torch.kernels.linrec.linrec",
                 "repro_torch.kernels.build"):
        assert name in mods


def test_no_import_of_jax_or_reference_in_source():
    offenders = []
    for path in sorted(PORT.rglob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                if name.split(".")[0] in FORBIDDEN:
                    offenders.append(f"{path.relative_to(SRC)}: {name}")
    assert offenders == []


@pytest.mark.parametrize("cfg_index", [0, 5, 10])
def test_synth_demand_profile_without_noise_equals_reference(cfg_index):
    jcfg = list(jtr._pool_configs(12).values())[cfg_index]
    tcfg = list(ttr._pool_configs(12).values())[cfg_index]
    assert jcfg.__dict__ == tcfg.__dict__
    want = np.asarray(jdm.synth_demand(24 * 400, jcfg))
    got = tdm.synth_demand(24 * 400, tcfg).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5)


def _lag1(x):
    a, b = x[:-1] - x[:-1].mean(), x[1:] - x[1:].mean()
    return float((a * b).sum() / np.sqrt((a * a).sum() * (b * b).sum()))


def test_synth_demand_noise_distribution_matches_reference():
    """AR(1) multiplicative noise: x_t = 0.95 x_{t-1} + 0.01 e_t, so a
    lag-1 autocorrelation of 0.95 and a spread of 0.01/sqrt(1 - 0.95^2)
    ~= 0.032, in both packages."""
    n = 24 * 365 * 2
    cfg = tdm.DemandConfig()
    clean = tdm.synth_demand(n, cfg).numpy().astype(np.float64)
    stats = {}
    for name, noisy in (
        ("port", tdm.synth_demand(
            n, cfg, generator=torch.Generator().manual_seed(7)).numpy()),
        ("reference", np.asarray(jdm.synth_demand(
            n, jdm.DemandConfig(), key=jax.random.PRNGKey(7)))),
    ):
        ar = noisy.astype(np.float64) / clean - 1.0
        stats[name] = (_lag1(ar), ar.std())
    theory = 0.01 / np.sqrt(1 - 0.95 ** 2)
    for lag1, std in stats.values():
        assert lag1 == pytest.approx(0.95, abs=0.01)
        assert std == pytest.approx(theory, rel=0.15)
    assert stats["port"][1] == pytest.approx(stats["reference"][1], rel=0.2)


def test_ar1_filter_is_the_recurrence():
    eps = torch.randn(1000, generator=torch.Generator().manual_seed(1))
    got = tdm._ar1(eps, 0.01).numpy()
    want, x = np.zeros(1000), 0.0
    for i, e in enumerate(eps.double().numpy()):
        x = 0.95 * x + 0.01 * e
        want[i] = x
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-15)


def test_one_seed_one_fleet():
    a = ttr.synthetic_pool_set(num_pools=3, num_hours=24 * 30, seed=4)
    b = ttr.synthetic_pool_set(num_pools=3, num_hours=24 * 30, seed=4)
    c = ttr.synthetic_pool_set(num_pools=3, num_hours=24 * 30, seed=5)
    np.testing.assert_array_equal(a.demand, b.demand)
    assert not np.array_equal(a.demand, c.demand)


def test_synthetic_fleet_shape_and_keys_match_reference():
    j = jtr.synthetic_pool_set(num_pools=7, num_hours=24 * 60, seed=0)
    t = ttr.synthetic_pool_set(num_pools=7, num_hours=24 * 60, seed=0)
    assert t.keys == j.keys
    assert [c.__dict__ for c in t.configs] == [c.__dict__ for c in j.configs]
    assert t.demand.shape == j.demand.shape and t.demand.dtype == np.float32
    # same profiles, different noise draws: row means agree to ~1%
    np.testing.assert_allclose(t.demand.mean(-1), j.demand.mean(-1),
                               rtol=0.02)
    # the turnover fleet: the reference's keys, built on the asked device
    jm = jtr.synthetic_pool_set(num_pools=4, num_hours=24, migration=True)
    tm = ttr.synthetic_pool_set(num_pools=4, num_hours=24, migration=True,
                                device="cpu")
    assert tm.keys == jm.keys and tm.demand.shape == jm.demand.shape


def test_convert_round_trips_the_reference_fleet():
    j = jtr.synthetic_pool_set(num_pools=5, num_hours=24 * 14, seed=2)
    t = convert.pool_set_from_reference(j)
    assert t.keys == j.keys and t.clouds == j.clouds
    np.testing.assert_array_equal(t.demand, j.demand)
    assert isinstance(t.configs[0], tdm.DemandConfig)
    assert t.select(cloud="gcp").keys == j.select(cloud="gcp").keys


def test_device_resolution():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="cuda"):
        resolve_device("meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            resolve_device(None)
        with pytest.raises(RuntimeError, match='device="cpu"'):
            resolve_device("cuda")


def test_scenario_entry_points_default_to_the_card():
    """The scenario batch and the tournament run on the card unless the
    caller asks for the CPU, like the planners."""
    from repro_torch.core import tournament as ttn
    from repro_torch.data import scenarios as tsc
    demand = np.ones((2, 24 * 14), np.float32)
    cfg = tsc.ScenarioConfig(n_scenarios=2, family="scale")
    cpu = tsc.scenario_batch(demand, cfg, device="cpu")
    assert cpu.device.type == "cpu" and cpu.shape == (2, 2, 24 * 14)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            tsc.scenario_batch(demand, cfg)
        with pytest.raises(RuntimeError, match='device="cpu"'):
            ttn.run_tournament(num_seeds=1)
