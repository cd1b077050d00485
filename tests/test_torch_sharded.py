"""The multi-rank pieces of the PyTorch port, on the CPU over gloo, against
the JAX package's multi-device runs and against the port's one-rank runs.

Processes of their own, all started at once (``file://`` rendezvous, no
network): the port without a process group (the one-rank runs), two port
ranks (world 2), four port ranks (world 4, a ``("data", "model") = (2,
2)`` mesh), each on one thread, and the JAX package on 2 forced host
devices and on 4.

* ``launch/mesh.py::shard_rows``: the scenario replay
  (``replan_fleet_pools(..., scenarios=ScenarioConfig(4, "growth"))`` on
  the 3-pool, 20-week fleet of ``tests/test_torch_replan.py``, quantile
  and grid solvers) at world 2 gives every rank the port's one-rank
  report, every field bit for bit; against the JAX replay on 2 host
  devices, whose rows ``shard_rows`` really splits, the tolerances of
  ``test_batched_replay_matches_reference`` (costs rel 1e-3; quantile
  targets rtol 1e-3 / atol 1e-2; grid targets within one grid cell).  The
  tournament (2 families x 4 seeds) at world 2 equals one rank bit for
  bit.  The block rule, a world larger than the rows (raises), and the
  identity without a group or at world 1.
* ``Model.param_shardings`` on the (2, 2) mesh under ``TRAIN_RULES``, the
  reduced stablelm-1.6b and granite-moe: each rank's local shard of every
  parameter equals the JAX device's shard of the stacked leaf at that
  layer, and DTensor's own ``full_tensor`` gives the parameter back.
* The elastic re-mesh restore: a tree (float32 and bfloat16 leaves, 1-D
  and 2-D meshes) saved at world 4 restores at world 2 and one saved at
  world 2 restores at world 4, as the reference's ``TestElasticRemesh``:
  every local shard equals the JAX ``addressable_shards`` of the same
  ``NamedSharding``, the restored full tensors equal the saved ones bit
  for bit, and both checkpoints restore at world 1.
* ``Trainer(shardings=)`` at world 2 restores the params and AdamW state
  onto the placements, and ``fit`` raises ``NotImplementedError``.
"""

import json
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402

from repro.data import traces as jtr  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.ckpt.manager import CheckpointManager  # noqa: E402
from repro_torch.core import forecast as tfc  # noqa: E402
from repro_torch.data import scenarios as tsc  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models.model import build, stacked_leaf  # noqa: E402
from repro_torch.models.params import Spec  # noqa: E402
from repro_torch.sharding import placement  # noqa: E402

SRC = str(Path(__file__).resolve().parents[1] / "src")
TIMEOUT = 420
WK = 168
NUM_GRID = 128
SOLVERS = ("quantile", "grid")
ARCHS = ("stablelm-1.6b", "granite-moe-1b-a400m")
COSTS = ("scenario_cost", "scenario_one_shot_cost",
         "scenario_hindsight_cost", "scenario_cr")

# Shared by every process: the elastic tree, its shardings on each mesh
# (the JAX PartitionSpec as a tuple), and the parameter draws by leaf
# name (multiples of 1/64 below 2: exact in bfloat16, so both packages'
# casts agree).
COMMON = textwrap.dedent("""
    import zlib
    import numpy as np

    def elastic_tree():
        rng = np.random.default_rng(7)
        return {"w": np.arange(64 * 8, dtype=np.float32).reshape(64, 8),
                "b": (rng.integers(-128, 128, (16, 12)) / 64).astype(
                    np.float32),
                "v": rng.standard_normal(40).astype(np.float32),
                "s": np.asarray(5, np.int32)}

    BF16 = ("b",)
    # leaf -> (mesh, spec) per world; mesh "1d" is ("data",) over every
    # rank, "2d" ("data", "model") = (2, 2)
    ELASTIC = {
        4: {"w": ("1d", ("data", None)), "b": ("2d", ("data", "model")),
            "v": ("2d", (("data", "model"),)), "s": None},
        2: {"w": ("1d", ("data", None)), "b": ("1d", (None, "data")),
            "v": ("1d", ("data",)), "s": None},
    }

    def draw(name, shape):
        rng = np.random.default_rng(zlib.crc32(name.encode()))
        return (rng.integers(-128, 128, shape) / 64).astype(np.float32)

    def named_leaves(tree, prefix=""):
        if isinstance(tree, dict):
            items = tree.items()
        elif isinstance(tree, (list, tuple)):
            items = enumerate(tree)
        else:
            return {prefix[:-1]: tree}
        out = {}
        for k, v in items:
            out.update(named_leaves(v, f"{prefix}{k}."))
        return out
""")

REFERENCE = COMMON + textwrap.dedent("""
    import os, sys
    n_dev = int(sys.argv[1])
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={n_dev}")
    import jax, jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    out = sys.argv[2]
    assert len(jax.devices()) == n_dev
    devs = jax.devices()
    res = {}

    def shards(arr, prefix):
        for d, dev in enumerate(devs):
            for s in arr.addressable_shards:
                if s.device == dev:
                    res[f"{prefix}/{d}"] = np.asarray(
                        s.data.astype(jnp.float32))

    if n_dev == 2:
        from repro.core import replan as rp
        from repro.data import scenarios as sc
        from repro.data import traces
        from repro.launch import mesh as mesh_mod
        y = mesh_mod.shard_rows(jnp.zeros((12, 3)))
        assert len(y.sharding.device_set) == 2, y.sharding
        pools = traces.synthetic_pool_set(num_pools=3, num_hours=20 * 168)
        for solver in ("quantile", "grid"):
            rep = rp.replan_fleet_pools(
                pools, scenarios=sc.ScenarioConfig(n_scenarios=4,
                                                   family="growth"),
                solver=solver, cadence_weeks=2, start_weeks=6,
                horizon_weeks=4, num_grid=128)
            for name in ("targets", "scenario_cost",
                         "scenario_one_shot_cost",
                         "scenario_hindsight_cost", "scenario_cr",
                         "scenario_regret", "weekly_cost"):
                res[f"replay/{solver}/{name}"] = np.asarray(
                    getattr(rep, name))
            for name in ("total_cost", "one_shot_cost", "hindsight_cost"):
                res[f"replay/{solver}/{name}"] = np.asarray(
                    getattr(rep, name))
    else:
        from repro import configs
        from repro.models.model import build
        from repro.sharding.rules import TRAIN_RULES
        mesh = Mesh(np.array(devs).reshape(2, 2), ("data", "model"))
        for arch in ("stablelm-1.6b", "granite-moe-1b-a400m"):
            cfg = configs.reduced(arch)
            m = build(cfg)
            leaves = named_leaves(m.param_specs)
            shardings = named_leaves(m.param_shardings(mesh, TRAIN_RULES))
            for name, spec in leaves.items():
                dtype = spec.dtype or jnp.bfloat16
                a = jax.device_put(
                    jnp.asarray(draw(name, spec.shape), dtype),
                    shardings[name])
                shards(a, f"params/{arch}/{name}")
    # the elastic tree on the meshes of the worlds this process can hold
    meshes = {4: {"1d": lambda: Mesh(np.array(devs), ("data",)),
                  "2d": lambda: mesh}} if n_dev == 4 else {}
    meshes[2] = {"1d": lambda: Mesh(np.array(devs[:2]), ("data",))}
    tree = elastic_tree()
    for world, leaves in ELASTIC.items():
        if world not in meshes:
            continue
        for name, sh in leaves.items():
            if sh is None:
                continue
            dtype = jnp.bfloat16 if name in BF16 else jnp.float32
            a = jax.device_put(
                jnp.asarray(tree[name], dtype),
                NamedSharding(meshes[world][sh[0]](), P(*sh[1])))
            shards(a, f"elastic/{world}/{name}")
    np.savez(out, **res)
    print("REFERENCE_OK")
""")

PORT_RANK = COMMON + textwrap.dedent("""
    import itertools, os, pickle, sys, time
    import torch
    import torch.distributed as dist

    # world 1: no process group, the one-rank runs the others are held to
    rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    if world > 1:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/rdv{world}",
                                rank=rank, world_size=world)
    from repro_torch import configs, convert
    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.core import replan as rp
    from repro_torch.core import tournament as tn
    from repro_torch.data import scenarios as sc
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models.model import build, param_specs
    from repro_torch.sharding import placement
    from repro_torch.sharding.rules import TRAIN_RULES

    res = {}
    meshes = {}
    if world > 1:
        meshes["1d"] = mesh_mod.make_mesh({"data": world}, device="cpu")
    if world == 4:
        meshes["2d"] = mesh_mod.make_mesh({"data": 2, "model": 2},
                                          device="cpu")
    tree = {k: torch.from_numpy(v) for k, v in elastic_tree().items()}
    tree["b"] = tree["b"].to(torch.bfloat16)

    def shardings(w):
        from repro_torch.sharding.placement import placements_for
        return {k: None if sh is None else
                (meshes[sh[0]], placements_for(sh[1], meshes[sh[0]], k))
                for k, sh in ELASTIC[w].items()}

    def local_f32(t):
        return (t.to_local() if placement.is_placed(t) else t).to(
            torch.float32).numpy().copy()

    # 1) the elastic save at this world, first, so the other world can
    #    restore it while this one works
    if world > 1:
        mgr = CheckpointManager(f"{tmp}/ckpt{world}")
        mgr.save(1, placement.place(tree, shardings(world)),
                 metadata={"world": world})

    if world <= 2:
        # 2) the scenario replay and the tournament, sharded at world 2
        with open(f"{tmp}/pools.pkl", "rb") as f:
            pools = pickle.load(f)
        for solver in ("quantile", "grid"):
            rep = rp.replan_fleet_pools(
                pools, scenarios=sc.ScenarioConfig(n_scenarios=4,
                                                   family="growth"),
                solver=solver, cadence_weeks=2, start_weeks=6,
                horizon_weeks=4, num_grid=128, device="cpu")
            with open(f"{tmp}/replay_{solver}_{world}_{rank}.pkl",
                      "wb") as f:
                pickle.dump(rep, f)
        rep = tn.run_tournament(
            families=("steady", "cyclic"), num_pools=3, num_weeks=30,
            num_seeds=4, start_weeks=12, cadence_weeks=2, horizon_weeks=4,
            device="cpu")
        res["tour/cost"], res["tour/hindsight"] = (rep.cost,
                                                   rep.hindsight_cost)
    if world == 2:
        res["rows"] = np.asarray([mesh_mod.shard_rows(n) for n in
                                  (2, 3, 4, 5)])
        for n in (1,):
            try:
                mesh_mod.shard_rows(n)
            except ValueError as exc:
                res["too_few"] = np.asarray(str(exc))
        try:
            rp.replan_fleet_pools(pools, scenarios=1, device="cpu",
                                  **dict(cadence_weeks=2, start_weeks=6,
                                         horizon_weeks=4))
        except ValueError as exc:
            res["replay_too_few"] = np.asarray(str(exc))

        # 3) Trainer(shardings=): restore onto the placements, fit refuses
        from repro_torch.data.pipeline import DataConfig, TokenPipeline
        from repro_torch.train.optimizer import AdamWConfig
        from repro_torch.train.trainer import Trainer, TrainerConfig
        model = build(configs.reduced("stablelm-1.6b"), device="cpu")

        def trainer():
            data = TokenPipeline(DataConfig(vocab_size=model.cfg.vocab_size,
                                            seq_len=16, global_batch=4))
            return Trainer(
                model, data, TrainerConfig(total_steps=4, ckpt_every=2,
                                           opt=AdamWConfig(lr=1e-3)),
                f"{tmp}/train", clock=itertools.count().__next__,
                shardings=model.param_shardings(meshes["1d"], TRAIN_RULES))

        first = trainer()
        assert first.init_or_restore(torch.Generator().manual_seed(3)) == 0
        for p in first.opt_state["m"].values():
            p.to_local().normal_(generator=torch.Generator().manual_seed(5))
        first.step = 2
        first._checkpoint()
        first.ckpt.wait()
        again = trainer()
        res["train/step"] = np.asarray(
            again.init_or_restore(torch.Generator().manual_seed(4)))
        res["train/equal"] = np.asarray(all(
            torch.equal(again.params[n].to_local(),
                        first.params[n].to_local())
            and torch.equal(again.opt_state[k][n].to_local(),
                            first.opt_state[k][n].to_local())
            for n in first.params for k in ("master", "m", "v")))
        res["train/placed"] = np.asarray(all(
            placement.is_placed(t) for t in again.params.values()))
        try:
            again.fit(max_steps=3)
        except NotImplementedError as exc:
            res["train/fit"] = np.asarray(str(exc))
    if world == 4:
        # 2) the parameters placed on the (2, 2) mesh
        for arch in ("stablelm-1.6b", "granite-moe-1b-a400m"):
            cfg = configs.reduced(arch)
            model = build(cfg, device="cpu")
            drawn = {}
            for name, spec in named_leaves(param_specs(cfg)).items():
                drawn[name] = draw(name, spec.shape)
            tree_np = {}
            for name, value in drawn.items():   # back to the nested tree
                node = tree_np
                parts = name.split(".")
                for part in parts[:-1]:
                    node = node.setdefault(part, {})
                node[parts[-1]] = value
            model.load_state_dict(convert.model_params_from_reference(
                cfg, tree_np))
            placed = model.placed_params(meshes["2d"], TRAIN_RULES)
            for name, t in placed.items():
                res[f"params/{arch}/{name}"] = local_f32(t)
                full = t.full_tensor()
                res[f"params_full_ok/{arch}/{name}"] = np.asarray(
                    torch.equal(full, dict(model.named_parameters())[name]))

    if world == 1:
        np.savez(f"{tmp}/rank1_0.npz", **res)
        print("RANK_OK")
        sys.exit(0)

    # 4) restore the other world's checkpoint onto this world's meshes
    other = 2 if world == 4 else 4
    done = f"{tmp}/ckpt{other}/step_00000001"
    deadline = time.monotonic() + 200
    while not os.path.isdir(done):
        assert time.monotonic() < deadline, "no checkpoint from the other world"
        time.sleep(0.05)
    target = {k: torch.zeros(v.shape, dtype=v.dtype) for k, v in tree.items()}
    got, meta = CheckpointManager(f"{tmp}/ckpt{other}").restore(
        1, target, shardings=shardings(world))
    assert meta == {"world": other}, meta
    for k, t in got.items():
        res[f"elastic/{world}/{k}"] = local_f32(t)
        res[f"elastic_dtype/{world}/{k}"] = np.asarray(str(t.dtype))
    for k, t in got.items():
        if placement.is_placed(t):
            full = placement.gather_to_host(t)
            if rank == 0:
                res[f"elastic_full_ok/{world}/{k}"] = np.asarray(
                    torch.equal(full.view(torch.int16) if
                                full.dtype == torch.bfloat16 else full,
                                tree[k].view(torch.int16) if
                                tree[k].dtype == torch.bfloat16 else tree[k]))
    np.savez(f"{tmp}/rank{world}_{rank}.npz", **res)
    dist.destroy_process_group()
    print("RANK_OK")
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every process started at once; returns (tmp, the JAX outputs by
    device count, the port's outputs by (world, rank), world 1 the
    one-rank runs, and the fleet).  The replays' reports are pickled by
    the ranks under tmp."""
    tmp = tmp_path_factory.mktemp("sharded")
    jpools = jtr.synthetic_pool_set(num_pools=3, num_hours=20 * WK)
    pools = convert.pool_set_from_reference(jpools)
    with open(tmp / "pools.pkl", "wb") as f:
        pickle.dump(pools, f)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    # every port process, the one-rank one included, on one thread: the
    # same arithmetic everywhere, and seven processes do not crowd the
    # CPUs the other test files run on
    port_env = dict(env, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")

    def start(code, *args, env=env):
        return subprocess.Popen(
            [sys.executable, "-c", code, *map(str, args)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    procs = {("jax", n): start(REFERENCE, n, tmp / f"ref{n}.npz")
             for n in (2, 4)}
    procs.update({(w, r): start(PORT_RANK, r, w, tmp, env=port_env)
                  for w in (1, 2, 4) for r in range(w)})
    try:
        outs = {k: p.communicate(timeout=TIMEOUT) for k, p in procs.items()}
    finally:
        for p in procs.values():
            p.kill()
    for k, (out, err) in outs.items():
        assert ("REFERENCE_OK" if k[0] == "jax" else "RANK_OK") in out, (
            k, err[-4000:])
    ref = {n: dict(np.load(tmp / f"ref{n}.npz")) for n in (2, 4)}
    port = {(w, r): dict(np.load(tmp / f"rank{w}_{r}.npz"))
            for w in (1, 2, 4) for r in range(w)}
    return tmp, ref, port, pools


def _fields_equal(a, b, path="report"):
    """Every field of two reports (dataclasses, arrays, scalars, nested),
    bit for bit."""
    import dataclasses
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert type(a) is type(b), path
        for f in dataclasses.fields(a):
            _fields_equal(getattr(a, f.name), getattr(b, f.name),
                          f"{path}.{f.name}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.ascontiguousarray(a).tobytes() == \
            np.ascontiguousarray(b).tobytes(), path
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), path
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _fields_equal(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _fields_equal(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and np.isnan(a):
        assert np.isnan(b), path
    else:
        assert a == b, (path, a, b)


def _replay(tmp, solver, world, rank):
    with open(tmp / f"replay_{solver}_{world}_{rank}.pkl", "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("solver", SOLVERS)
def test_world2_replay_every_field_bit_for_bit(runs, solver):
    tmp = runs[0]
    one = _replay(tmp, solver, 1, 0)
    for rank in range(2):
        got = _replay(tmp, solver, 2, rank)
        assert got.n_scenarios == 4 and got.targets.shape[1] == 4
        _fields_equal(got, one)


@pytest.mark.parametrize("solver", SOLVERS)
def test_world2_replay_matches_jax_on_two_devices(runs, solver):
    tmp, ref, _, pools = runs
    want = {k.split("/")[-1]: v for k, v in ref[2].items()
            if k.startswith(f"replay/{solver}/")}
    got = _replay(tmp, solver, 2, 1)
    assert got.targets.shape == want["targets"].shape
    if solver == "quantile":
        np.testing.assert_allclose(got.targets, want["targets"], rtol=1e-3,
                                   atol=1e-2)
    else:
        cells = _scenario_cells(pools, got)[..., None]
        assert (np.abs(got.targets - want["targets"]) <= cells + 1e-4).all()
    for name in COSTS:
        np.testing.assert_allclose(getattr(got, name), want[name],
                                   rtol=1e-3, err_msg=name)
    assert (np.abs(got.scenario_regret - want["scenario_regret"])
            <= 1e-3 * want["scenario_cost"]).all()
    for name in ("total_cost", "one_shot_cost", "hindsight_cost"):
        assert getattr(got, name) == pytest.approx(float(want[name]),
                                                   rel=1e-3), name
    np.testing.assert_allclose(got.weekly_cost, want["weekly_cost"],
                               rtol=1e-3)


def _scenario_cells(pools, rep):
    """(S, N, P) grid-cell width of every replayed week's forecast of each
    scenario's demand (``tests/test_torch_replan.py``'s rule)."""
    rows = tsc.scenario_batch(pools.demand, rep.scenario_config,
                              device="cpu").reshape(-1, pools.num_hours)
    state = tfc.prefix_fit_state(
        rows, tfc.ForecastConfig(), horizon_hours=rep.horizon_weeks * WK,
        min_prefix_hours=rep.start_weeks * WK)
    return np.stack([
        (tfc.predict_from_beta(state, tfc.solve_prefix(state, int(w)),
                               int(w) * WK, rep.horizon_weeks * WK)
         .amax(-1) / (NUM_GRID - 1)).numpy()
        for w in rep.weeks
    ]).reshape(len(rep.weeks), rep.n_scenarios, -1)


def test_world2_tournament_bit_for_bit(runs):
    port = runs[2]
    want = port[(1, 0)]
    for rank in range(2):
        got = port[(2, rank)]
        assert got["tour/cost"].shape == (4, 2, 4)
        np.testing.assert_array_equal(got["tour/cost"], want["tour/cost"])
        np.testing.assert_array_equal(got["tour/hindsight"],
                                      want["tour/hindsight"])


def test_row_blocks_rule_and_world_larger_than_rows(runs):
    port = runs[2]
    # ranks 0 and 1 of n = 2, 3, 4, 5: the larger block first
    want = {0: [(0, 1), (0, 2), (0, 2), (0, 3)],
            1: [(1, 2), (2, 3), (2, 4), (3, 5)]}
    for rank in range(2):
        got = port[(2, rank)]
        assert [tuple(b) for b in got["rows"]] == want[rank]
        assert "world of 2" in str(got["too_few"])
        assert "world of 2" in str(got["replay_too_few"])
    assert tmesh.row_blocks(7, 3) == [(0, 3), (3, 5), (5, 7)]
    assert tmesh.row_blocks(5, 5) == [(i, i + 1) for i in range(5)]
    with pytest.raises(ValueError, match="world of 6"):
        tmesh.row_blocks(5, 6)


def test_world1_is_the_identity(tmp_path):
    """Without a group, and at world 1, the block is every row and the
    gather hands the array back as it is, on its device."""
    assert not dist.is_initialized()
    x = np.arange(6.0).reshape(3, 2)
    assert tmesh.shard_rows(3) == (0, 3)
    assert tmesh.gather_rows(x, 3) is x
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'pg'}",
                            rank=0, world_size=1)
    try:
        assert tmesh.shard_rows(3) == (0, 3)
        assert tmesh.gather_rows(x, 3, axis=0) is x
    finally:
        dist.destroy_process_group()


def _layer_index(cfg, name):
    """The index into its stacked reference leaf of a per-layer parameter
    (None for a parameter outside the layers)."""
    head, _, tail = name.partition(".")
    index = tail.partition(".")[0]
    if head != "layers" or not index.isdigit():
        return None
    return int(index) - cfg.first_dense_layers


@pytest.mark.parametrize("arch", ARCHS)
def test_param_shardings_match_jax_shards(runs, arch):
    _, ref, port, _ = runs
    cfg = configs.reduced(arch)
    names = [n for n, _ in build(cfg, device="meta").named_parameters()]
    for rank in range(4):
        got = port[(4, rank)]
        for name in names:
            leaf = stacked_leaf(cfg, name)
            want = ref[4][f"params/{arch}/{leaf}/{rank}"]
            i = _layer_index(cfg, name)
            if i is not None:
                want = want[i]
            np.testing.assert_array_equal(
                got[f"params/{arch}/{name}"], want, err_msg=name)
            assert bool(got[f"params_full_ok/{arch}/{name}"]), name


def test_param_shardings_spec_out_of_mesh_order_raises(tmp_path):
    """A dimension split over mesh axes out of the mesh's order (the
    spill of ``sanitize_partition_spec``) cannot be a DTensor placement:
    named and refused."""
    from repro_torch.models.params import sanitize_partition_spec

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'pg'}",
                            rank=0, world_size=1)
    try:
        mesh = tmesh.make_mesh({"data": 1, "model": 1}, device="cpu")
        spec = Spec((4, 3), ("heads", "embed"))
        pspec = sanitize_partition_spec(
            spec, {"heads": "model", "embed": "data"},
            {"data": 2, "model": 2})
        assert pspec == (("model", "data"), None)
        with pytest.raises(ValueError, match="out of the mesh's order"):
            placement.placements_for(pspec, mesh, "w")
        with pytest.raises(ValueError, match="names mesh axis 'pod'"):
            placement.placements_for(("pod",), mesh, "w")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("world", [2, 4])
def test_elastic_restore_shards_match_jax(runs, world):
    """Saved at the other world, restored at ``world``: each rank's local
    shard equals the JAX shard of the same NamedSharding on its device,
    bfloat16 kept."""
    _, ref, port, _ = runs
    jax_run = ref[4]
    for rank in range(world):
        got = port[(world, rank)]
        for name in ("w", "b", "v"):
            np.testing.assert_array_equal(
                got[f"elastic/{world}/{name}"],
                jax_run[f"elastic/{world}/{name}/{rank}"], err_msg=name)
        assert str(got[f"elastic_dtype/{world}/b"]) == "torch.bfloat16"
        assert str(got[f"elastic_dtype/{world}/s"]) == "torch.int32"
        assert int(got[f"elastic/{world}/s"]) == 5
    # the 2-device JAX run places the world-2 tree the same way
    for rank in range(2):
        for name in ("w", "b", "v"):
            np.testing.assert_array_equal(
                ref[2][f"elastic/2/{name}/{rank}"],
                jax_run[f"elastic/2/{name}/{rank}"])
    for name in ("w", "b", "v"):
        assert bool(port[(world, 0)][f"elastic_full_ok/{world}/{name}"])


@pytest.mark.parametrize("world", [2, 4])
def test_checkpoint_saved_on_a_mesh_restores_on_one_device(runs, world):
    tmp = runs[0]
    mgr = CheckpointManager(str(tmp / f"ckpt{world}"))
    with open(tmp / f"ckpt{world}" / "step_00000001" / "manifest.json") as f:
        manifest = json.load(f)
    assert manifest["names"] == ["w", "b", "v", "s"]
    assert manifest["dtypes"] == ["float32", "bfloat16", "float32", "int32"]
    target = {"w": torch.zeros(64, 8), "b": torch.zeros(16, 12,
                                                        dtype=torch.bfloat16),
              "v": torch.zeros(40), "s": torch.zeros((), dtype=torch.int32)}
    got, meta = mgr.restore(1, target, device="cpu")
    assert meta == {"world": world}
    rng = np.random.default_rng(7)
    np.testing.assert_array_equal(got["w"].numpy(),
                                  np.arange(512, dtype=np.float32).reshape(
                                      64, 8))
    b = torch.from_numpy((rng.integers(-128, 128, (16, 12)) / 64).astype(
        np.float32)).to(torch.bfloat16)
    assert got["b"].dtype == torch.bfloat16
    assert torch.equal(got["b"].view(torch.int16), b.view(torch.int16))
    np.testing.assert_array_equal(
        got["v"].numpy(), rng.standard_normal(40).astype(np.float32))
    assert int(got["s"]) == 5


def test_trainer_restores_onto_placements_and_fit_refuses(runs):
    port = runs[2]
    for rank in range(2):
        got = port[(2, rank)]
        assert int(got["train/step"]) == 2
        assert bool(got["train/equal"]) and bool(got["train/placed"])
        assert "the sharded train step" in str(got["train/fit"])


def test_placed_tree_round_trip_at_world1(tmp_path):
    """On a one-rank mesh the placed tensors are the full ones: save,
    restore with shardings, and gather back, bit for bit."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'pg'}",
                            rank=0, world_size=1)
    try:
        mesh = tmesh.make_mesh({"data": 1}, device="cpu")
        sh = (mesh, placement.placements_for(("data",), mesh))
        tree = {"a": torch.arange(6.0).reshape(3, 2)}
        placed = placement.place(tree, {"a": sh})
        assert placement.is_placed(placed["a"])
        mgr = CheckpointManager(str(tmp_path / "ck"))
        mgr.save_async(3, placed)
        mgr.wait()
        got, _ = mgr.restore(3, {"a": torch.zeros(3, 2)}, shardings={"a": sh})
        assert torch.equal(got["a"].to_local(), tree["a"])
        assert torch.equal(placement.gather_to_host(got["a"]), tree["a"])
    finally:
        dist.destroy_process_group()


def test_host_group_made_once_per_process_group(tmp_path, monkeypatch):
    """Under a default backend other than gloo (NCCL on the card) the host
    bytes move over one gloo group, made on the first call and kept until
    the default group changes; a row exchange and a save of a placed leaf
    go through it.  The default group here is gloo reporting itself as
    NCCL, so the CPU takes the card's route."""
    made = []
    new_group = dist.new_group

    def counted(*args, **kw):
        made.append(kw.get("backend"))
        return new_group(*args, **kw)

    monkeypatch.setattr(dist, "new_group", counted)
    for i in range(2):
        dist.init_process_group(
            "gloo", init_method=f"file://{tmp_path / f'pg{i}'}", rank=0,
            world_size=1)
        try:
            assert tmesh.host_group() is None
            with monkeypatch.context() as m:
                m.setattr(dist, "get_backend", lambda group=None: "nccl")
                group = tmesh.host_group()
                assert group is not None and tmesh.host_group() is group
                x = np.arange(6, dtype=np.float32).reshape(3, 2)
                assert tmesh.gather_rows(x, 3) is x
                mesh = tmesh.make_mesh({"data": 1}, device="cpu")
                sh = (mesh, placement.placements_for(("data",), mesh))
                tree = {"a": torch.arange(6.0).reshape(3, 2)}
                mgr = CheckpointManager(str(tmp_path / f"ck{i}"))
                mgr.save(1, placement.place(tree, {"a": sh}))
                assert tmesh.host_group() is group
            got, _ = mgr.restore(1, {"a": torch.zeros(3, 2)})
            assert torch.equal(got["a"], tree["a"])
        finally:
            dist.destroy_process_group()
        assert made == ["gloo"] * (i + 1)
