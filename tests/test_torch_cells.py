"""The shape cells and their dry run in the PyTorch port
(``sharding/rules.py``, ``models/params.py``'s partition specs,
``launch/{mesh,cells,roofline,dryrun}.py``) against the JAX package's
``repro.sharding.rules``, ``repro.launch.cells`` and the analytic half of
``repro.launch.hlo_analysis``.

Everything here is integer bookkeeping and closed forms, so it is held
equal, not close: the rules tables, ``resolve_rules``,
``sanitize_partition_spec`` on every parameter and cache Spec of the ten
architectures, ``default_microbatches``, ``all_cells`` (32 cells), and
for every cell under both production mesh shapes (the reference given a
``FakeMesh`` with ``.shape``, as ``tests/test_dryrun_unit.py`` does) the
per-device parameter and cache bytes, ``active_params``,
``model_flops_for``, ``analytic_hbm_bytes``, ``analytic_temp_bytes`` and
``inner_recurrence_flops``.  The port counts its per-layer parameters
(the meta model's Specs, dotted names); the reference its stacked leaves
(tree paths): the totals agree.  ``tests/test_dryrun_unit.py``'s cases
follow, minus HLO parsing and the delta configs, which have no
counterpart, then the dry run's JSON cache and CLI.
"""

import dataclasses
import json
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from repro import compat
from repro import configs as jconfigs
from repro.launch import cells as jcells
from repro.launch import hlo_analysis as ha
from repro.models import params as jparams
from repro.models.config import SHAPES as JSHAPES
from repro.models.model import build as jbuild
from repro.sharding import rules as jrules
from repro_torch import configs
from repro_torch.launch import cells, dryrun, mesh, roofline
from repro_torch.models import params as tparams
from repro_torch.models.config import SHAPES
from repro_torch.sharding import rules

H100 = "NVIDIA H100 80GB HBM3"
BUDGET = 80 * 1024**3
MESHES = {"single": mesh.production_mesh_shape(),
          "multi": mesh.production_mesh_shape(multi_pod=True)}


class FakeMesh:
    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


def _tspec(spec):
    """The reference's Spec as the port's (dtype by name)."""
    import torch
    dtype = None if spec.dtype is None else getattr(
        torch, np.dtype(spec.dtype).name)
    return tparams.Spec(tuple(spec.shape), tuple(spec.axes), spec.init,
                        spec.fan_in, dtype)


def _norm(pspec):
    """A one-axis tuple entry as the axis (``PartitionSpec`` normalizes
    ``("model",)`` so)."""
    return tuple(p[0] if isinstance(p, tuple) and len(p) == 1 else p
                 for p in pspec)


def _jleaves(tree):
    return jax.tree.leaves(tree,
                           is_leaf=lambda x: isinstance(x, jparams.Spec))


@pytest.fixture(scope="module")
def jmodels():
    return {a: jbuild(jconfigs.get(a)) for a in sorted(jconfigs.ARCHS)}


@pytest.fixture(scope="module")
def tcells():
    return {(a, s): cells.make_cell(a, s) for a, s in cells.all_cells()}


# --------------------------------------------------------------- the rules
def test_rules_tables_match():
    assert rules.TRAIN_RULES == jrules.TRAIN_RULES
    assert rules.PREFILL_RULES == jrules.PREFILL_RULES
    assert rules.DECODE_RULES == jrules.DECODE_RULES
    assert rules.RULESETS == jrules.RULESETS
    for r in rules.RULESETS.values():
        assert rules.batch_spec(r) == tuple(jrules.batch_pspec(r))
        for ndim in (1, 2, 4):
            assert rules.data_spec(r, ndim) == tuple(
                jrules.data_pspec(r, ndim))


def test_all_cells_match():
    got = cells.all_cells()
    assert got == jcells.all_cells()
    assert len(got) == 32  # 10x3 + 2 long_500k
    assert ("rwkv6-3b", "long_500k") in got
    assert ("jamba-v0.1-52b", "long_500k") in got
    assert ("phi3-medium-14b", "long_500k") not in got


@pytest.mark.parametrize("which", sorted(MESHES))
def test_resolve_rules_and_microbatches_match(which):
    ms = MESHES[which]
    for arch, shape in cells.all_cells():
        sc = SHAPES[shape]
        for name, r in rules.RULESETS.items():
            assert cells.resolve_rules(dict(r), ms, sc.global_batch) == \
                jcells.resolve_rules(dict(r), FakeMesh(ms), sc.global_batch)
        assert cells.default_microbatches(
            configs.get(arch), sc, ms) == jcells.default_microbatches(
            jconfigs.get(arch), JSHAPES[shape], FakeMesh(ms))


def test_resolve_drops_missing_axes():
    rules_ = cells.resolve_rules(dict(rules.RULESETS["train"]),
                                 {"data": 1}, 256)
    assert rules_["batch"] == ("data",)
    assert rules_["heads"] is None  # "model" axis doesn't exist


def test_batch_1_unsharded():
    rules_ = cells.resolve_rules(dict(rules.RULESETS["decode"]),
                                 {"data": 16, "model": 16}, 1)
    assert rules_["batch"] is None  # 1 % 16 != 0 -> replicate batch


def test_even_dims_untouched():
    spec = tparams.Spec((32, 64), ("heads", None))
    assert tparams.sanitize_partition_spec(
        spec, {"heads": "model"}, {"model": 1}) == ("model", None)


def test_uneven_dim_spills():
    spec = tparams.Spec((40, 128), ("heads", "head_dim"))  # 40 % 16 != 0
    assert tparams.sanitize_partition_spec(
        spec, {"heads": "model"}, {"model": 16}) == (None, "model")


def test_unplaceable_axis_dropped():
    spec = tparams.Spec((6, 7), ("heads", None))
    assert tparams.sanitize_partition_spec(
        spec, {"heads": "model"}, {"model": 16}) == (None, None)


def test_sanitize_on_a_real_mesh_matches():
    """The reference on a real one-device mesh, as its own test runs it."""
    jmesh = compat.make_mesh((1,), ("model",),
                             axis_types=compat.auto_axis_types(1))
    spec = jparams.Spec((32, 64), ("heads", None))
    assert tuple(jparams.sanitize_partition_spec(
        spec, {"heads": "model"}, jmesh)) == P("model", None) == \
        tparams.sanitize_partition_spec(_tspec(spec), {"heads": "model"},
                                        {"model": 1})


@pytest.mark.parametrize("which", sorted(MESHES))
def test_sanitize_every_spec_matches(jmodels, which):
    """Every parameter and cache Spec of the ten architectures (the
    reference's stacked leaves) under every ruleset resolved for the
    mesh: the same partition spec, and the same unsanitized one."""
    ms = MESHES[which]
    fake = FakeMesh(ms)
    n = 0
    for arch, jm in jmodels.items():
        leaves = _jleaves(jm.param_specs) + _jleaves(jm.cache_specs(4, 4096))
        for kind, r in rules.RULESETS.items():
            r = cells.resolve_rules(dict(r), ms, 256)
            for spec in leaves:
                ts = _tspec(spec)
                assert _norm(tparams.partition_spec(ts, r)) == tuple(
                    jparams.partition_spec(spec, r))
                assert tparams.sanitize_partition_spec(ts, r, ms) == tuple(
                    jparams.sanitize_partition_spec(spec, r, fake)), (
                    arch, kind, spec)
                n += 1
    assert n > 500


# --------------------------------------------------------------- the cells
def _jcell(jm, shape):
    return types.SimpleNamespace(cfg=jm.cfg, model=jm, cell=JSHAPES[shape])


@pytest.mark.parametrize("which", sorted(MESHES))
def test_cell_bytes_and_flops_match(jmodels, tcells, which):
    ms = MESHES[which]
    fake = FakeMesh(ms)
    nchips = 512 if which == "multi" else 256
    for (arch, shape), c in tcells.items():
        jm, sc = jmodels[arch], JSHAPES[shape]
        r = cells.cell_rules(c, ms)
        jr = jcells.resolve_rules(dict(jrules.RULESETS[sc.kind]), fake,
                                  sc.global_batch)
        assert r == jr
        got = c.device_bytes(ms, r)
        assert got["params"] == ha._local_bytes(jm.param_specs, fake, jr)
        cache = (0.0 if sc.kind == "train" else ha._local_bytes(
            jm.cache_specs(sc.global_batch, sc.seq_len), fake, jr))
        assert got["cache"] == cache
        # the reference's float32 master, m and v (cells._opt_abstract)
        f32 = jax.tree.map(lambda s: dataclasses.replace(s, dtype=jnp.float32),
                           jm.param_specs,
                           is_leaf=lambda x: isinstance(x, jparams.Spec))
        assert got["opt_state"] == (
            3 * ha._local_bytes(f32, fake, jr) if sc.kind == "train" else 0.0)
        assert roofline.active_params(c.cfg, c.param_specs) == \
            ha.active_params(jm.cfg, jm)
        assert roofline.model_flops_for(c.cfg, c.param_specs, c.cell) == \
            ha.model_flops_for(jm.cfg, jm, sc)
        assert roofline.analytic_hbm_bytes(c, ms, r) == \
            ha.analytic_hbm_bytes(_jcell(jm, shape), fake, jr)
        micro = cells.default_microbatches(c.cfg, c.cell, ms)
        assert roofline.analytic_temp_bytes(
            c.cfg, c.cell, nchips // 16, 16, micro) == \
            ha.analytic_temp_bytes(jm.cfg, sc, nchips // 16, 16, micro)
        assert roofline.inner_recurrence_flops(c.cfg, c.cell) == \
            ha.inner_recurrence_flops(jm.cfg, sc)


def test_param_and_cache_counts_match(jmodels, tcells):
    """The meta model's parameters are the reference's elements, and its
    stacked cache Specs hold the reference's cache elements (the port
    stacks an MLA model's dense first layer with the rest)."""
    for (arch, shape), c in tcells.items():
        jm = jmodels[arch]
        assert c.model.num_params() == jm.num_params()
        assert sum(p.numel() for p in c.model.parameters()) == sum(
            math.prod(s.shape) for s in c.param_specs.values())
        if c.cell.kind != "train":
            got = sum(math.prod(s.shape) for s in c.cache_specs)
            want = sum(math.prod(s.shape) for s in _jleaves(jm.cache_specs(
                c.cell.global_batch, c.cell.seq_len)))
            assert got == want


def test_active_params_moe_discount(tcells):
    c = tcells[("deepseek-v2-lite-16b", "train_4k")]
    total = c.model.num_params()
    active = roofline.active_params(c.cfg, c.param_specs)
    assert active < 0.25 * total  # 6/64 routing + shared + dense


def test_model_flops_formulas(tcells):
    c = tcells[("stablelm-1.6b", "train_4k")]
    specs = c.param_specs
    n = roofline.active_params(c.cfg, specs)
    assert roofline.model_flops_for(c.cfg, specs, SHAPES["train_4k"]) == \
        pytest.approx(6 * n * 256 * 4096)
    assert roofline.model_flops_for(c.cfg, specs, SHAPES["prefill_32k"]) \
        == pytest.approx(2 * n * 32 * 32768)
    assert roofline.model_flops_for(c.cfg, specs, SHAPES["decode_32k"]) == \
        pytest.approx(2 * n * 128)


def test_roofline_dominance():
    peaks = roofline.peaks_for(H100)
    assert peaks is roofline.PEAKS["sxm"]
    assert roofline.peaks_for("NVIDIA H100 PCIe") is roofline.PEAKS["pcie"]
    r = roofline.roofline_terms(
        flops=peaks["bf16_flops"], hbm_bytes=1e9, collective_bytes=1e9,
        model_flops=100e12, peaks=peaks)
    assert r.dominant == "compute"
    assert r.compute_s == pytest.approx(1.0)
    r = roofline.roofline_terms(
        flops=1e12, hbm_bytes=peaks["bytes"] * 2, collective_bytes=0,
        model_flops=1e12, peaks=peaks)
    assert r.dominant == "memory"
    assert r.memory_s == pytest.approx(2.0)
    r = roofline.roofline_terms(
        flops=1e12, hbm_bytes=1e9, collective_bytes=peaks["link_bytes"] * 3,
        model_flops=1e12, peaks=peaks)
    assert r.dominant == "collective"
    assert r.collective_s == pytest.approx(3.0)


def test_pick_chunk_matches():
    from repro.models.scan_utils import pick_chunk
    for s in (1, 100, 2048, 4096, 32768, 524288, 1000, 3):
        for kw in (dict(target_iters=16, max_chunk=2048),
                   dict(target_iters=32, max_chunk=256), {}):
            assert roofline.pick_chunk(s, **kw) == pick_chunk(s, **kw)


# ------------------------------------------------------------- the dry run
def test_run_cell_record():
    rec = dryrun.run_cell("stablelm-1.6b", "train_4k", memory_bytes=BUDGET,
                          card=H100, verbose=False)
    m = rec["memory"]
    assert rec["chips"] == 256 and rec["mesh_axes"] == ["data", "model"]
    assert m["budget_bytes"] == BUDGET
    assert m["total_per_device"] == pytest.approx(
        m["params_bytes"] + m["opt_state_bytes"] + m["cache_bytes"]
        + m["temp_bytes"])
    assert m["fits"] == (m["total_per_device"] < BUDGET)
    assert rec["roofline"]["model_flops"] == pytest.approx(
        rec["model_flops_global"] / 256)
    assert rec["roofline"]["collective_s"] == 0.0
    from repro_torch.models.model import num_params
    assert rec["params_total"] == num_params(configs.get("stablelm-1.6b"))
    # a budget below the bytes does not fit
    small = dryrun.run_cell("stablelm-1.6b", "train_4k", memory_bytes=1,
                            card=H100, verbose=False)
    assert not small["memory"]["fits"]


def test_dryrun_writes_and_rereads_json(tmp_path):
    out = tmp_path / "dryrun"
    argv = ["--all", "--both-meshes", "--out", str(out), "--memory-bytes",
            str(BUDGET), "--card", H100]
    assert dryrun.main(argv) == 0
    files = sorted(out.glob("*.json"))
    assert len(files) == 64
    rec = json.loads((out / "jamba-v0.1-52b__long_500k__multi.json")
                     .read_text())
    assert rec["chips"] == 512 and rec["kind"] == "decode"
    # cached: a rerun reads the records back unchanged
    records, failures = dryrun.run_all(cells.all_cells(), [False, True],
                                       str(out), memory_bytes=1, card=H100,
                                       verbose=False)
    assert not failures and len(records) == 64
    on_disk = {f.name: json.loads(f.read_text()) for f in files}
    for r in records:
        multi = r["chips"] == 512
        tag = dryrun.cell_tag(r["arch"], r["shape"], multi)
        assert r == on_disk[tag + ".json"]
        assert r["memory"]["budget_bytes"] == BUDGET


def test_dryrun_needs_a_card_or_a_budget():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.run_cell("stablelm-1.6b", "train_4k", verbose=False)
    assert dryrun.run_cell("stablelm-1.6b", "train_4k", memory_bytes=BUDGET,
                           card=H100, verbose=False)["card"] == H100
