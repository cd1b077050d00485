"""Training the vlm, audio and hybrid families: the port's train step
against the JAX package's on the reduced float32 qwen2-vl-7b (embedding
inputs, M-RoPE), whisper-small (encoder-decoder: non-causal attention
through the trainable flash op) and jamba-v0.1-52b (Mamba through the
scan's trainable op, attention, MoE), from the same carried weights and
numpy batch; ``build_loss_fn`` on each family's batch; and every registry
config's ``Model.forward`` at reduced size.

Tolerances (float32), those of ``tests/test_torch_train.py``: the loss
within rel 1e-6, every leaf's gradient within 1e-5 of that leaf's largest
(the same float32 products summed in other orders; jamba's scan runs step
by step in the port and as an associative scan in the reference), m and
v of one AdamW step within 1e-5 / 2e-5 of their leaf's largest, and its
master weights and parameters within 1e-5 where the reference's AdamW
direction is well conditioned, within twice the step's learning rate
elsewhere.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.models.model import build as jbuild  # noqa: E402
from repro.models.params import tree_specs_map  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.models.model import build  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

ARCHS = ["qwen2-vl-7b", "whisper-small", "jamba-v0.1-52b"]
SEQ, BATCH = 24, 2
OPT = dict(lr=1e-3, warmup_steps=2)
COND = 1e-3     # a well-conditioned AdamW direction (test_torch_train.py)


@pytest.fixture(scope="module", autouse=True)
def _full_f32_matmuls():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_float32_matmul_precision(prev)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(cfg, seed=0, seq=SEQ, batch=BATCH):
    """The family's train batch as numpy arrays: labels always; tokens,
    or embeddings for a config that takes them; frames for the audio
    family."""
    rng = np.random.default_rng(seed)
    out = {"labels": rng.integers(0, cfg.vocab_size, (batch, seq)).astype(
        np.int32)}
    if cfg.embeds_input:
        out["embeds"] = rng.normal(size=(batch, seq, cfg.d_model)).astype(
            np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(
            np.int32)
    if cfg.family == "audio":
        out["enc_frames"] = rng.normal(
            size=(batch, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return out


def _init(jm, seed=0):
    """The JAX model's parameters drawn by numpy by its specs' rules
    (zeros, ones, normal over sqrt(fan in)), float32: the reference's
    init without compiling it."""
    rng = np.random.default_rng(seed)

    def make(spec):
        if spec.init in ("zeros", "ones"):
            return np.full(spec.shape, spec.init == "ones", np.float32)
        fan = spec.fan_in or (spec.shape[-2] if len(spec.shape) >= 2
                              else spec.shape[-1])
        return (rng.normal(size=spec.shape) / np.sqrt(max(fan, 1))).astype(
            np.float32)

    return tree_specs_map(make, jm.param_specs)


def _grad_close(got, want, rel=1e-5):
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=0, atol=rel * scale + 1e-12)


@pytest.fixture(scope="module", params=ARCHS)
def jax_step(request):
    """One JAX build per config: its parameters, a batch, the loss and
    gradients of the live JAX ``build_loss_fn`` (the loss its
    ``build_train_step`` differentiates), and the AdamW state of one step
    on them (its update)."""
    arch = request.param
    jm = jbuild(dataclasses.replace(jconfigs.reduced(arch), dtype="float32"))
    params = _init(jm)
    batch = _batch(jm.cfg)
    jloss, jgrads = jax.jit(jax.value_and_grad(jstep.build_loss_fn(jm)))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    update = jax.jit(functools.partial(jopt.adamw_update,
                                       cfg=jopt.AdamWConfig(**OPT)))
    _, jstate = update(jgrads, jopt.init_opt_state(params))
    return arch, _np(params), batch, float(jloss), _np(jgrads), _np(jstate)


def _port(arch, params):
    tm = build(dataclasses.replace(configs.reduced(arch), dtype="float32"),
               device="cpu")
    tm.load_state_dict(convert.model_params_from_reference(tm.cfg, params))
    return tm


def test_train_step_matches_jax(jax_step):
    """Loss and every leaf's gradient against the JAX loss; then one
    AdamW step of the port's ``build_train_step``: its loss, m, v and
    master weights against the JAX update of the JAX gradients."""
    arch, params, batch, jloss, jgrads, jstate = jax_step
    tm = _port(arch, params)
    loss = tstep.build_loss_fn(tm)(batch)
    named = list(tm.named_parameters())
    grads = torch.autograd.grad(loss, [p for _, p in named])
    np.testing.assert_allclose(float(loss.detach()), jloss, rtol=1e-6)
    want = convert.model_params_from_reference(tm.cfg, jgrads)
    assert sorted(want) == sorted(n for n, _ in named)
    for (name, _), g in zip(named, grads):
        assert torch.isfinite(g).all(), name
        _grad_close(g, want[name].float())

    tparams = dict(tm.named_parameters())
    cfg = topt.AdamWConfig(**OPT)
    tl, _, ts = tstep.build_train_step(tm, cfg)(
        tparams, topt.init_opt_state(tparams), batch)
    np.testing.assert_allclose(float(tl), jloss, rtol=1e-6)
    wstate = convert.opt_state_from_reference(tm.cfg, jstate)
    assert int(ts["step"]) == int(wstate["step"]) == 1
    bound = 2 * topt._schedule(cfg, 0)
    for name, p in named:
        m, v = wstate["m"][name], wstate["v"][name]
        _grad_close(ts["m"][name], m)
        _grad_close(ts["v"][name], v, rel=2e-5)
        m_hat, v_hat = m / (1.0 - cfg.b1), v / (1.0 - cfg.b2)
        good = (v_hat.sqrt() > COND * m_hat.abs().max()) | (v == 0)
        for got in (ts["master"][name], p.detach()):
            diff = (got.float() - wstate["master"][name]).abs()
            assert float(torch.where(good, diff, 0).max()) <= 1e-5, name
            assert float(diff.max()) <= bound, name


@pytest.mark.parametrize("arch,keys", [
    ("qwen2-vl-7b", {"embeds", "labels"}),
    ("whisper-small", {"tokens", "enc_frames", "labels"}),
])
def test_loss_fn_passes_every_input_but_labels(arch, keys):
    """``build_loss_fn`` hands the model every batch input but the labels:
    its loss is the cross-entropy of ``apply``'s train logits on them;
    without the family's own input the forward raises ``apply``'s
    ``ValueError``."""
    tm = build(dataclasses.replace(configs.reduced(arch), dtype="float32"),
               device="cpu").init(torch.Generator().manual_seed(1))
    batch = _batch(tm.cfg, seed=2, seq=8)
    assert set(batch) == keys
    loss = tstep.build_loss_fn(tm)(batch)
    inputs = {k: torch.from_numpy(v) for k, v in batch.items()
              if k != "labels"}
    logits, _ = tm.apply(**inputs, mode="train")
    want = tstep.cross_entropy(logits, torch.from_numpy(batch["labels"]))
    torch.testing.assert_close(loss.detach(), want, rtol=1e-6, atol=0)
    missing = "enc_frames" if "enc_frames" in keys else "embeds"
    with pytest.raises(ValueError, match=missing):
        tstep.build_loss_fn(tm)({k: v for k, v in batch.items()
                                 if k != missing})


@pytest.mark.parametrize("arch", sorted(configs.ARCHS))
def test_every_registry_config_trains_at_reduced_size(arch):
    """``Model.forward`` of every registry config (reduced, float32, 8
    positions) gives finite logits equal to ``apply``'s train logits and a
    finite gradient on every parameter."""
    tm = build(dataclasses.replace(configs.reduced(arch), dtype="float32"),
               device="cpu").init(torch.Generator().manual_seed(0))
    batch = _batch(tm.cfg, seed=3, seq=8, batch=1)
    inputs = {k: torch.from_numpy(v) for k, v in batch.items()
              if k != "labels"}
    logits = tm(**inputs)
    want, _ = tm.apply(**inputs, mode="train")
    torch.testing.assert_close(logits.detach(), want, rtol=1e-5, atol=1e-5)
    loss = tstep.cross_entropy(logits, torch.from_numpy(batch["labels"]))
    params = list(tm.parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    assert all(g is not None and torch.isfinite(g).all() for g in grads)
