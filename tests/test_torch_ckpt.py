"""The port's checkpoint manager and crash/restart, mirroring the JAX
package's ``tests/test_fault_tolerance.py`` (atomic round trip, keep-k
pruning, tmp dirs ignored, incompatible trees rejected, async saves, and a
restart that reproduces the uninterrupted losses bit for bit).

Documented differences, each pinned here: the manifest adds the leaf
names; a bfloat16 leaf is written as its 16-bit view with the dtype
``"bfloat16"`` in the manifest; ``restore(..., device=)`` takes the place
of ``shardings=``; an incompatible tree raises ``ValueError`` (the
reference asserts).  The elastic re-mesh restore needs several cards and
is not ported.
"""

import itertools
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.ckpt.manager import CheckpointManager  # noqa: E402
from repro_torch.data.pipeline import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.models.model import build  # noqa: E402
from repro_torch.train.optimizer import AdamWConfig  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402


def _tree():
    return {"a": torch.arange(6).reshape(2, 3).to(torch.bfloat16),
            "b": [torch.ones(4), torch.zeros((2, 2), dtype=torch.int32)]}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


class TestCheckpointManager:
    def test_atomic_roundtrip(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep_last=2)
        tree = _tree()
        mgr.save(5, tree, {"note": "x"})
        restored, meta = mgr.restore(5, tree)
        assert meta["note"] == "x"
        for x, y in zip(_leaves(tree), _leaves(restored)):
            assert x.dtype == y.dtype
            assert torch.equal(x, y)

    def test_manifest_names_and_bf16_view(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(1, _tree())
        path = tmp_path / "step_00000001"
        manifest = json.loads((path / "manifest.json").read_text())
        assert manifest["names"] == ["a", "b.0", "b.1"]
        assert manifest["dtypes"] == ["bfloat16", "float32", "int32"]
        assert manifest["shapes"] == [[2, 3], [4], [2, 2]]
        assert manifest["num_leaves"] == 3 and manifest["step"] == 1
        assert manifest["treedef"] == "{'a': *, 'b': [*, *]}"
        assert np.load(path / "arr_00000.npy").dtype == np.int16

    def test_bf16_roundtrip_bit_for_bit(self, tmp_path):
        bits = torch.arange(-2**15, 2**15, dtype=torch.int32).to(torch.int16)
        tree = {"w": bits.view(torch.bfloat16)}  # every pattern, NaNs too
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(3, tree)
        got, _ = mgr.restore(3, tree)
        assert got["w"].dtype == torch.bfloat16
        assert torch.equal(got["w"].view(torch.int16), bits)

    def test_keep_last_prunes(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep_last=2)
        tree = {"a": torch.zeros(3)}
        for s in (1, 2, 3, 4):
            mgr.save(s, tree)
        assert mgr.all_steps() == [3, 4]

    def test_tmp_dirs_ignored(self, tmp_path):
        """A crash mid-save leaves only a .tmp dir, which restore ignores."""
        mgr = CheckpointManager(str(tmp_path), keep_last=3)
        tree = {"a": torch.zeros(3)}
        mgr.save(1, tree)
        os.makedirs(str(tmp_path / "step_00000002.tmp"))
        assert mgr.latest_step() == 1

    @pytest.mark.parametrize("target", [
        {"a": torch.zeros(3), "b": torch.zeros(2)},   # leaf count
        {"c": torch.zeros(3)},                        # leaf name
        {"a": torch.zeros(4)},                        # leaf shape
    ])
    def test_incompatible_tree_rejected(self, tmp_path, target):
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(1, {"a": torch.zeros(3)})
        with pytest.raises(ValueError):
            mgr.restore(1, target)

    def test_async_save_snapshots_before_returning(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        tree = {"a": torch.arange(10_000, dtype=torch.float32)}
        want = tree["a"].clone()
        mgr.save_async(7, tree)
        tree["a"].mul_(-1.0)          # the next step changes it in place
        mgr.wait()
        restored, _ = mgr.restore(7, tree)
        assert torch.equal(restored["a"], want)

    def test_async_save_error_raised_by_wait(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        (tmp_path / "blocker").write_text("")
        mgr.root = str(tmp_path / "blocker")     # not a directory
        mgr.save_async(1, {"a": torch.zeros(2)})
        with pytest.raises(OSError):
            mgr.wait()

    def test_restore_device_and_latest(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        assert mgr.restore_latest({"a": torch.zeros(2)}) is None
        mgr.save(2, {"a": torch.ones(2)})
        step, tree, _ = mgr.restore_latest({"a": torch.zeros(2)},
                                           device="cpu")
        assert step == 2 and tree["a"].device.type == "cpu"
        assert torch.equal(tree["a"], torch.ones(2))


def tiny_trainer(path, total=24, ckpt_every=8):
    model = build(configs.reduced("stablelm-1.6b"), device="cpu")
    data = TokenPipeline(DataConfig(
        vocab_size=model.cfg.vocab_size, seq_len=16, global_batch=4,
    ))
    return Trainer(
        model, data,
        TrainerConfig(total_steps=total, ckpt_every=ckpt_every,
                      opt=AdamWConfig(lr=1e-3, warmup_steps=2)),
        str(path / "ckpt"), clock=itertools.count().__next__,
    )


class TestCrashRestart:
    def test_restart_is_bit_exact(self, tmp_path):
        ref = tiny_trainer(tmp_path / "ref", total=24)
        ref.init_or_restore()
        ref_losses = ref.fit()

        # dies at step 19, after the step-16 checkpoint
        crash = tiny_trainer(tmp_path / "crash", total=24)
        crash.init_or_restore()
        with pytest.raises(RuntimeError, match="injected failure"):
            crash.fit(fail_at_step=19)
        assert crash.ckpt.all_steps() == [8, 16]

        resumed = tiny_trainer(tmp_path / "crash", total=24)
        assert resumed.init_or_restore() == 16
        assert resumed.pipeline.step == 16
        resumed_losses = resumed.fit()
        assert resumed_losses == ref_losses[16:]
        for (name, p), q in zip(resumed.model.named_parameters(),
                                ref.model.parameters()):
            assert torch.equal(p, q), name
        for key in ("master", "m", "v"):
            for name, t in resumed.opt_state[key].items():
                assert torch.equal(t, ref.opt_state[key][name]), (key, name)
        assert int(resumed.opt_state["step"]) == 24

    def test_restart_without_checkpoint_starts_fresh(self, tmp_path):
        t = tiny_trainer(tmp_path, total=4, ckpt_every=100)
        assert t.init_or_restore() == 0
