"""The EF-int8 compressed gradient sync and the compressed train step in
the PyTorch port (``train/compression.py``, ``train/step.py``), on the CPU
over gloo, against the JAX package's.

* ``ef_int8_allreduce`` at world 4 (four ranks, each its own process,
  gloo over a ``file://`` rendezvous, mesh ``("pod",) = (4,)``) on the
  reference's inputs (``default_rng(0).normal((4, 64))``) against
  ``ef_int8_psum`` under ``shard_map`` on four forced host devices, in a
  process of its own: the same float32 operations in the same order, so
  the averages and error states are held bit for bit, one step and 200
  steps of error feedback.
* The 200-step bias test of ``tests/test_fault_tolerance.py`` on the port.
* The reduced float32 stablelm-1.6b's compressed step at world 1 against
  the reference's ``build_compressed_train_step`` on a one-device
  ``("pod",)`` mesh: the loss within rel 1e-5; the parameters as in
  ``tests/test_torch_train.py`` (1e-5 where AdamW's direction is well
  conditioned, twice the learning rate elsewhere), where "elsewhere" also
  takes the elements whose int8 level differs between the packages: their
  float32 gradients differ in the last bits (~1e-6 of a leaf's largest),
  and an element that sits that close to a rounding boundary lands one
  level (1/127 of the leaf's largest) apart.  Such elements are found by
  their error state, which then differs by about one level, and are held
  to be rare.
* A ``"pod"`` mesh without a process group raises; a mesh without a
  ``"pod"`` axis passes the gradients through.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402

from repro import compat  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import TokenPipeline as JTokenPipeline  # noqa: E402
from repro.models.model import build as jbuild  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models.model import build  # noqa: E402
from repro_torch.train import compression as tcomp  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

SRC = str(Path(__file__).resolve().parents[1] / "src")
WORLD, STEPS = 4, 200
TIMEOUT = 240
OPT = dict(lr=1e-3, warmup_steps=2)
COND = 1e-3

REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro import compat
    from repro.train.compression import ef_int8_psum

    mesh = jax.make_mesh((4,), ("pod",))
    gs = np.random.default_rng(0).normal(size=(4, 64)).astype(np.float32)
    f = jax.jit(compat.shard_map(
        lambda g, e: ef_int8_psum(g, e, "pod"), mesh=mesh,
        in_specs=(P("pod"), P("pod")), out_specs=(P("pod"), P("pod")),
        check_vma=False))
    g = jax.device_put(jnp.asarray(gs), NamedSharding(mesh, P("pod")))
    e = jnp.zeros_like(g)
    avg1, err1 = f(g, e)
    avgs = []
    for _ in range(%d):
        a, e = f(g, e)
        avgs.append(np.asarray(a))
    np.savez(sys.argv[1], avg1=np.asarray(avg1), err1=np.asarray(err1),
             avgs=np.stack(avgs), err=np.asarray(e))
    print("REFERENCE_OK")
""" % STEPS)

PORT_RANK = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_pod_mesh
    from repro_torch.train.compression import (
        compressed_pod_sync, ef_int8_allreduce, init_error_state)

    rank, init, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=4)
    try:
        mesh = make_pod_mesh(4, device="cpu")
        gs = np.random.default_rng(0).normal(size=(4, 64)).astype(
            np.float32)
        g = torch.from_numpy(gs[rank:rank + 1].copy())
        grads = {"g": g}
        err = init_error_state(grads)
        avg1, err1 = compressed_pod_sync(grads, err, mesh)
        e = err["g"]
        avgs = []
        for _ in range(%d):
            a, e = ef_int8_allreduce(g, e, mesh.get_group("pod"))
            avgs.append(a.numpy())
        np.savez(out, avg1=avg1["g"].numpy(), err1=err1["g"].numpy(),
                 avgs=np.stack(avgs), err=e.numpy())
    finally:
        dist.destroy_process_group()
    print("RANK_OK")
""" % STEPS)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """(reference outputs, per-rank port outputs), both runs started at
    once, each in processes of its own."""
    tmp = tmp_path_factory.mktemp("ef_int8")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    ref = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(tmp / "ref.npz")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    init = f"file://{tmp / 'rendezvous'}"
    ranks = [subprocess.Popen(
        [sys.executable, "-c", PORT_RANK, str(r), init,
         str(tmp / f"rank{r}.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(WORLD)]
    outs = []
    try:
        for p in [ref, *ranks]:
            outs.append(p.communicate(timeout=TIMEOUT))
    finally:
        for p in [ref, *ranks]:
            p.kill()
    assert "REFERENCE_OK" in outs[0][0], outs[0][1]
    for out, err in outs[1:]:
        assert "RANK_OK" in out, err
    return (np.load(tmp / "ref.npz"),
            [np.load(tmp / f"rank{r}.npz") for r in range(WORLD)])


def test_world4_first_step_bit_for_bit(world4):
    ref, ranks = world4
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["avg1"][0], ref["avg1"][r])
        np.testing.assert_array_equal(got["err1"][0], ref["err1"][r])
    # every rank holds the same average
    for got in ranks[1:]:
        np.testing.assert_array_equal(got["avg1"], ranks[0]["avg1"])


def test_world4_error_feedback_bit_for_bit(world4):
    ref, ranks = world4
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["avgs"][:, 0], ref["avgs"][:, r])
        np.testing.assert_array_equal(got["err"][0], ref["err"][r])


def test_world4_compressed_mean_and_vanishing_bias(world4):
    """The reference's two properties on the port: one step within 0.05
    of the true mean, and 200 steps of error feedback within 0.005."""
    _, ranks = world4
    gs = np.random.default_rng(0).normal(size=(4, 64)).astype(np.float32)
    true = gs.mean(0)
    for got in ranks:
        np.testing.assert_allclose(got["avg1"][0], true, atol=0.05)
        np.testing.assert_allclose(got["avgs"][:, 0].mean(0), true,
                                   atol=0.005)
    # without the error feedback the bias does not vanish: the same
    # quantized mean every step
    single = ranks[0]["avg1"][0]
    assert np.abs(single - true).max() > 0.005


# ------------------------------------------------------------ world 1 step
@pytest.fixture
def gloo1(tmp_path):
    """A one-rank gloo process group in this process, destroyed after."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'pg'}",
                            rank=0, world_size=1)
    try:
        yield tmesh.make_pod_mesh(1, device="cpu")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module", autouse=True)
def _full_f32_matmuls():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_float32_matmul_precision(prev)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def test_world1_compressed_step_matches_jax(gloo1, monkeypatch):
    from jax.sharding import PartitionSpec as P

    arch = "stablelm-1.6b"
    jm = jbuild(dataclasses.replace(jconfigs.reduced(arch), dtype="float32"))
    params = jax.jit(jm.init)(jax.random.PRNGKey(0))
    tm = build(dataclasses.replace(configs.reduced(arch), dtype="float32"),
               device="cpu")
    tm.load_state_dict(convert.model_params_from_reference(tm.cfg,
                                                           _np(params)))
    pipe = JTokenPipeline(JDataConfig(vocab_size=tm.cfg.vocab_size,
                                      seq_len=32, global_batch=2, seed=0))
    batches = [pipe.next_batch() for _ in range(2)]

    jmesh = compat.make_mesh((1,), ("pod",),
                             axis_types=compat.auto_axis_types(1))
    pspecs = jax.tree.map(lambda _: P(), params)
    bspecs = {"tokens": P("pod", None), "labels": P("pod", None)}
    jcfg, tcfg = jopt.AdamWConfig(**OPT), topt.AdamWConfig(**OPT)
    jfn = jax.jit(jstep.build_compressed_train_step(jm, jmesh, pspecs,
                                                    bspecs, jcfg))
    tfn = tstep.build_compressed_train_step(tm, gloo1, tcfg)

    # each leaf's quantization level (its stacked leaf's shared scale),
    # as the sync hands it on
    scales = []
    real = tcomp._quantized_mean

    def recorded(x, scale, dtype, group):
        scales.append(float(scale))
        return real(x, scale, dtype, group)

    monkeypatch.setattr(tcomp, "_quantized_mean", recorded)

    js = jopt.init_opt_state(params)
    jerr = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), params)
    tparams = dict(tm.named_parameters())
    ts = topt.init_opt_state(tparams)
    terr = tcomp.init_error_state(tparams)
    for i, batch in enumerate(batches):
        scales.clear()
        jl, params, js, jerr = jfn(params, js, jerr,
                                   {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        tl, tparams, ts, terr = tfn(tparams, ts, terr, batch)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
        if i == 0:
            flipped_total, elements = _step_one_state_close(
                tm, ts, terr, js, jerr, scales, tcfg)
    assert flipped_total <= 1e-3 * elements, (flipped_total, elements)


def _step_one_state_close(tm, ts, terr, js, jerr, scales, tcfg):
    """After step 1: the error states equal up to the gradients' last bits
    except where the int8 levels differ (module docstring), and the
    parameters and master weights as in ``tests/test_torch_train.py``,
    those elements counted as ill conditioned.  Returns (elements whose
    level differs, elements).  Later steps part further: a level apart
    moves a parameter by a learning rate, and every gradient after it."""
    want = convert.opt_state_from_reference(tm.cfg, _np(js))
    want_err = convert.model_params_from_reference(tm.cfg, _np(jerr))
    bound = 2 * topt._schedule(tcfg, 0)
    named = list(tm.named_parameters())
    assert len(scales) == len(named)
    flipped_total = elements = 0
    for (name, p), scale in zip(named, scales):
        m, v = want["m"][name], want["v"][name]
        # |error| <= scale / 2, and a level apart moves it by the scale
        diff_err = (terr[name] - want_err[name]).abs()
        flipped = diff_err > scale / 2
        flipped_total += int(flipped.sum())
        elements += flipped.numel()
        # elsewhere the gradients' own difference: 1e-5 of the largest
        assert float(torch.where(flipped, 0.0, diff_err).max()) <= (
            1e-5 * 127 * scale), name
        m_hat = m / (1.0 - tcfg.b1)
        v_hat = v / (1.0 - tcfg.b2)
        good = ((v_hat.sqrt() > COND * m_hat.abs().max()) | (v == 0)) \
            & ~flipped
        for got in (ts["master"][name], p.detach()):
            diff = (got.float() - want["master"][name]).abs()
            assert float(torch.where(good, diff, 0).max()) <= 1e-5, name
            assert float(diff.max()) <= bound, name
    return flipped_total, elements


def test_pod_mesh_without_process_group_raises(tmp_path):
    """The sync refuses to skip: a mesh with a "pod" axis whose process
    group is gone raises, in the sync and in the compressed step."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'pg'}",
                            rank=0, world_size=1)
    mesh = tmesh.make_pod_mesh(1, device="cpu")
    dist.destroy_process_group()
    grads = {"w": torch.ones(3)}
    with pytest.raises(RuntimeError, match="no process group"):
        tcomp.compressed_pod_sync(grads, tcomp.init_error_state(grads), mesh)
    tm = build(configs.reduced("stablelm-1.6b"), device="cpu")
    params, opt = tstep.init_train_state(tm, torch.Generator().manual_seed(0))
    step = tstep.build_compressed_train_step(tm, mesh)
    batch = {"tokens": np.zeros((2, 8), np.int32),
             "labels": np.zeros((2, 8), np.int32)}
    with pytest.raises(RuntimeError, match="no process group"):
        step(params, opt, tcomp.init_error_state(params), batch)


def test_meshes_need_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialized process group"):
        tmesh.make_pod_mesh(2, device="cpu")
    with pytest.raises(RuntimeError, match="initialized process group"):
        tmesh.make_host_mesh(device="cpu")


def test_host_mesh_and_backend_checks(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'pg'}",
                            rank=0, world_size=1)
    try:
        mesh = tmesh.make_host_mesh(device="cpu")
        assert tmesh.mesh_axes(mesh) == ("data",)
        assert mesh.size() == 1
        with pytest.raises(ValueError, match="world of 2"):
            tmesh.make_pod_mesh(2, device="cpu")
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                tmesh.make_pod_mesh(1)
    finally:
        dist.destroy_process_group()


def test_no_pod_axis_passes_through(tmp_path):
    """The reference returns the gradients unchanged when the mesh has no
    "pod" axis; so does the port, process group or not."""
    grads = {"w": torch.arange(4.0)}
    err = tcomp.init_error_state(grads)
    for mesh in ({"data": 16, "model": 16}, {}):
        g, e = tcomp.compressed_pod_sync(grads, err, mesh)
        assert g is grads and e is err
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'pg'}",
                            rank=0, world_size=1)
    try:
        g, e = tcomp.compressed_pod_sync(
            grads, err, tmesh.make_host_mesh(device="cpu"))
        assert g is grads and e is err
    finally:
        dist.destroy_process_group()


def test_production_mesh_shapes():
    assert tmesh.production_mesh_shape() == {"data": 16, "model": 16}
    assert tmesh.production_mesh_shape(multi_pod=True) == {
        "pod": 2, "data": 16, "model": 16}
    assert json.dumps(tmesh.production_mesh_shape(multi_pod=True))


@pytest.mark.parametrize("arch", sorted(configs.ARCHS))
def test_stacked_leaf_groups_are_the_reference_leaves(arch):
    """The compressed step's scale groups: the port's per-layer parameters
    grouped by ``stacked_leaf`` are the reference's leaves, element for
    element (full published configs, on the meta device)."""
    import math

    from repro_torch.models.model import stacked_leaf

    tm = build(configs.get(arch), device="meta")
    want = {name: math.prod(spec.shape) for name, spec in convert._flatten(
        jbuild(jconfigs.get(arch)).param_specs)}
    got: dict[str, int] = {}
    for name, p in tm.named_parameters():
        key = stacked_leaf(tm.cfg, name)
        got[key] = got.get(key, 0) + p.numel()
    assert got == want
