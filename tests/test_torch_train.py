"""The port's training path against the JAX package's: the loss, AdamW,
one train step and the gradient-accumulated step on the reduced float32
stablelm-1.6b and rwkv6-3b, from the same carried weights and the same
numpy batches; and, within the port, remat, determinism, descent and the
straggler watchdog.

Tolerances (float32):
- the loss within rel 1e-6; every leaf's gradient within 1e-5 of that
  leaf's largest gradient (the same float32 products summed in other
  orders; measured ~1e-6 for stablelm-1.6b, ~1e-5 for rwkv6-3b, whose
  recurrence runs in other chunks);
- AdamW alone, on the same gradients: rel 1e-5 / abs 1e-6;
- m within 1e-5 and v within 2e-5 of their leaf's largest;
- parameters and master weights within 1e-5 where every step so far was
  well conditioned on the reference: sqrt(v_hat) above 1e-3 of the leaf's
  largest |m_hat| (for the measured gradient errors, ~1e-6 of the leaf's
  largest, AdamW's direction m_hat / (sqrt(v_hat) + eps) then moves by
  ~1e-3 at most), or v = 0 (no gradient yet: the step is the weight decay
  alone).  Elsewhere (~8% of the elements here) the direction turns on
  the gradients' last bits (a clipped gradient of ~1e-8 against eps 1e-8,
  or a moment that summed to ~0), and the two are held to twice the
  learning rates summed, the step's own bound.
RWKV steps run at T = 16: at T >= 32 the reference's chunked recurrence
(``repro.models.rwkv._chunked_wkv``, exp of prefix-sum differences) gives
NaN gradients (an infinite decay times a masked zero); the port's chunks
sum each decay over its own stretch and stay finite at any T.
"""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import TokenPipeline as JTokenPipeline  # noqa: E402
from repro.models.model import build as jbuild  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.data.pipeline import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.models.model import build  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402
from repro_torch.train.trainer import (  # noqa: E402
    StragglerWatchdog,
    Trainer,
    TrainerConfig,
)

SEQ = {"stablelm-1.6b": 32, "rwkv6-3b": 16}
OPT = dict(lr=1e-3, warmup_steps=2)
COND = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _full_f32_matmuls():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_float32_matmul_precision(prev)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(arch, **over):
    jm = jbuild(dataclasses.replace(jconfigs.reduced(arch), dtype="float32",
                                    **over))
    params = jm.init(jax.random.PRNGKey(0))
    tm = build(dataclasses.replace(configs.reduced(arch), dtype="float32",
                                   **over), device="cpu")
    tm.load_state_dict(convert.model_params_from_reference(tm.cfg,
                                                           _np(params)))
    return jm, params, tm


def _batches(vocab, seq, n, batch=2, seed=0):
    pipe = JTokenPipeline(JDataConfig(vocab_size=vocab, seq_len=seq,
                                      global_batch=batch, seed=seed))
    return [pipe.next_batch() for _ in range(n)]


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _grad_close(got, want, rel=1e-5):
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=0, atol=rel * scale + 1e-12)


def _conditioned(m, v, step, cfg):
    """Where the reference's AdamW direction is well conditioned (module
    docstring)."""
    m_hat = m / (1.0 - cfg.b1 ** step)
    v_hat = v / (1.0 - cfg.b2 ** step)
    return (v_hat.sqrt() > COND * m_hat.abs().max()) | (v == 0)


def _state_close(tm, topt_state, jopt_state, steps, cfg, good=None):
    """The port's parameters and AdamW state against the reference's after
    ``steps`` steps.  A parameter is held to 1e-5 where every step so far
    was well conditioned (``good``, carried from step to step; returned),
    to twice the learning rates summed elsewhere."""
    want = convert.opt_state_from_reference(tm.cfg, _np(jopt_state))
    assert int(topt_state["step"]) == int(want["step"]) == steps
    bound = 2 * sum(topt._schedule(cfg, s) for s in range(steps))
    good = {} if good is None else good
    for name, p in tm.named_parameters():
        m, v = want["m"][name], want["v"][name]
        _grad_close(topt_state["m"][name], m)
        _grad_close(topt_state["v"][name], v, rel=2e-5)
        good[name] = _conditioned(m, v, steps, cfg) & good.get(name, True)
        for got in (topt_state["master"][name], p.detach()):
            diff = (got.float() - want["master"][name]).abs()
            assert float(torch.where(good[name], diff, 0).max()) <= 1e-5
            assert float(diff.max()) <= bound
    return good


# ----------------------------------------------------------------- the loss
@pytest.mark.parametrize("z_loss", [1e-4, 0.0])
def test_cross_entropy_matches_jax(z_loss):
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(3, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    want = jstep.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                               z_loss=z_loss)
    got = tstep.cross_entropy(torch.from_numpy(logits),
                              torch.from_numpy(labels), z_loss=z_loss)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    if z_loss:
        plain = tstep.cross_entropy(torch.from_numpy(logits),
                                    torch.from_numpy(labels), z_loss=0.0)
        assert float(got) > float(plain)


# ------------------------------------------------------------------- AdamW
def _random_tree(rng):
    shapes = {"w": (8, 16), "b": (16,), "scale": (16,), "emb": (33, 4)}
    return {k: rng.normal(size=s).astype(np.float32)
            for k, s in shapes.items()}


@pytest.mark.parametrize("grad_scale", [1e-2, 1e3])   # clip off, clip on
def test_adamw_update_matches_jax_step_by_step(grad_scale):
    rng = np.random.default_rng(1)
    params = _random_tree(rng)
    cfg_kw = dict(lr=3e-3, warmup_steps=3, grad_clip=1.0)
    jcfg, tcfg = jopt.AdamWConfig(**cfg_kw), topt.AdamWConfig(**cfg_kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jopt.init_opt_state(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = topt.init_opt_state(tp)
    clipped = []
    for _ in range(5):
        grads = {k: (rng.normal(size=v.shape) * grad_scale).astype(
            np.float32) for k, v in params.items()}
        clipped.append(float(jopt.global_norm(grads)) > cfg_kw["grad_clip"])
        jp, js = jopt.adamw_update({k: jnp.asarray(v) for k, v in
                                    grads.items()}, js, jcfg)
        tp, ts = topt.adamw_update({k: torch.from_numpy(v) for k, v in
                                    grads.items()}, ts, tcfg, tp)
        assert int(ts["step"]) == int(js["step"])
        for k in params:
            for got, want in ((tp[k], jp[k]), (ts["master"][k],
                                               js["master"][k]),
                              (ts["m"][k], js["m"][k]),
                              (ts["v"][k], js["v"][k])):
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=1e-5, atol=1e-6)
    assert all(clipped) == (grad_scale > 1)
    assert any(clipped) == (grad_scale > 1)


def test_schedule_and_global_norm_match_jax():
    cfg = topt.AdamWConfig(lr=3e-4, warmup_steps=5)
    jcfg = jopt.AdamWConfig(lr=3e-4, warmup_steps=5)
    for s in range(8):
        assert topt._schedule(cfg, s) == float(
            jopt._schedule(jcfg, jnp.asarray(s, jnp.int32)))
    tree = _random_tree(np.random.default_rng(2))
    np.testing.assert_allclose(
        float(topt.global_norm([torch.from_numpy(v) for v in
                                tree.values()])),
        float(jopt.global_norm(tree)), rtol=1e-6)


def test_grad_clip_bounds_update():
    tm = build(configs.reduced("stablelm-1.6b"), device="cpu")
    params, opt = tstep.init_train_state(tm, torch.Generator().manual_seed(0))
    before = {n: p.detach().float().clone() for n, p in params.items()}
    huge = {n: torch.full(p.shape, 1e6) for n, p in params.items()}
    topt.adamw_update(huge, opt, topt.AdamWConfig(lr=1e-3, warmup_steps=1),
                      params)
    delta = topt.global_norm([p.detach().float() - before[n]
                              for n, p in params.items()])
    assert float(delta) < 1.0


# ------------------------------------------------------------- train steps
@pytest.mark.parametrize("arch", ["stablelm-1.6b", "rwkv6-3b"])
def test_train_step_matches_jax(arch):
    jm, params, tm = _pair(arch)
    (batch,) = _batches(tm.cfg.vocab_size, SEQ[arch], 1)
    jloss, jgrads = jax.jit(jax.value_and_grad(jstep.build_loss_fn(jm)))(
        params, _jnp(batch))
    loss = tstep.build_loss_fn(tm)(batch)
    named = list(tm.named_parameters())
    grads = torch.autograd.grad(loss, [p for _, p in named])
    loss = loss.detach()
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    want = convert.model_params_from_reference(tm.cfg, _np(jgrads))
    assert sorted(want) == sorted(n for n, _ in named)
    for (name, _), g in zip(named, grads):
        assert torch.isfinite(g).all(), name
        _grad_close(g, want[name].float())

    jcfg, tcfg = jopt.AdamWConfig(**OPT), topt.AdamWConfig(**OPT)
    jl, _, js = jax.jit(jstep.build_train_step(jm, jcfg))(
        params, jopt.init_opt_state(params), _jnp(batch))
    tparams = dict(tm.named_parameters())
    tl, _, ts = tstep.build_train_step(tm, tcfg)(
        tparams, topt.init_opt_state(tparams), batch)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    _state_close(tm, ts, js, 1, tcfg)


def test_grad_accum_step_matches_jax():
    arch = "stablelm-1.6b"
    jm, params, tm = _pair(arch)
    batches = _batches(tm.cfg.vocab_size, 16, 2, batch=8)
    jcfg, tcfg = jopt.AdamWConfig(**OPT), topt.AdamWConfig(**OPT)
    jfn = jax.jit(jstep.build_grad_accum_train_step(jm, jcfg, 4))
    tfn = tstep.build_grad_accum_train_step(tm, tcfg, 4)
    js = jopt.init_opt_state(params)
    tparams = dict(tm.named_parameters())
    ts = topt.init_opt_state(tparams)
    good = None
    for i, batch in enumerate(batches):
        jl, params, js = jfn(params, js, _jnp(batch))
        tl, tparams, ts = tfn(tparams, ts, batch)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
        good = _state_close(tm, ts, js, i + 1, tcfg, good)


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "rwkv6-3b"])
def test_remat_policies_agree(arch):
    """remat off, "full" and "dots" compute one loss and one gradient:
    each recomputes the same float32 ops in the same order."""
    out = []
    for policy, remat in (("full", False), ("full", True), ("dots", True)):
        tm = build(dataclasses.replace(configs.reduced(arch),
                                       dtype="float32",
                                       remat_policy=policy), device="cpu")
        tm.init(torch.Generator().manual_seed(0))
        (batch,) = _batches(tm.cfg.vocab_size, 24, 1)
        loss = tstep.cross_entropy(tm(torch.from_numpy(batch["tokens"]),
                                      remat=remat),
                                   torch.from_numpy(batch["labels"]))
        out.append((loss.detach(), torch.autograd.grad(
            loss, list(tm.parameters()))))
    for loss, grads in out[1:]:
        torch.testing.assert_close(loss, out[0][0], rtol=1e-6, atol=0)
        for g, g0 in zip(grads, out[0][1]):
            _grad_close(g, g0, rel=1e-6)


def test_remat_reruns_the_layers_forward(monkeypatch):
    """Under remat each layer's forward runs twice per step (forward and
    the backward's recompute), once without it."""
    tm = build(configs.reduced("stablelm-1.6b"), device="cpu")
    tm.init(torch.Generator().manual_seed(0))
    from repro_torch.models import attention
    calls = []
    real = attention.flash_attention_trainable

    def counted(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(attention, "flash_attention_trainable", counted)
    (batch,) = _batches(tm.cfg.vocab_size, 16, 1)
    for remat, want in ((True, 2), (False, 1)):
        calls.clear()
        loss = tm(torch.from_numpy(batch["tokens"]), remat=remat).sum()
        torch.autograd.grad(loss, list(tm.parameters()))
        assert len(calls) == want * tm.cfg.num_layers


def test_train_step_is_bit_for_bit_on_rerun():
    out = []
    for _ in range(2):
        tm = build(configs.reduced("stablelm-1.6b"), device="cpu")
        params, opt = tstep.init_train_state(
            tm, torch.Generator().manual_seed(3))
        (batch,) = _batches(tm.cfg.vocab_size, 16, 1, batch=4)
        loss, params, opt = tstep.build_train_step(
            tm, topt.AdamWConfig(lr=1e-3))(params, opt, batch)
        out.append((float(loss), {n: p.detach().clone()
                                  for n, p in params.items()}))
    assert out[0][0] == out[1][0]
    for name, p in out[0][1].items():
        assert torch.equal(p, out[1][1][name]), name


def test_train_step_takes_only_the_models_params():
    tm = build(configs.reduced("stablelm-1.6b"), device="cpu")
    params, opt = tstep.init_train_state(tm, torch.Generator().manual_seed(0))
    other = {n: p.detach().clone() for n, p in params.items()}
    (batch,) = _batches(tm.cfg.vocab_size, 16, 1)
    with pytest.raises(ValueError, match="own named parameters"):
        tstep.build_train_step(tm)(other, opt, batch)


def test_serve_and_prefill_steps_equal_apply():
    tm = build(configs.reduced("stablelm-1.6b"), device="cpu")
    tm.init(torch.Generator().manual_seed(0))
    tok = torch.from_numpy(_batches(tm.cfg.vocab_size, 9, 1)[0]["tokens"])
    logits, cache = tstep.build_prefill_step(tm, 32)({"tokens": tok[:, :8]})
    want, want_cache = tm.apply(tok[:, :8], mode="prefill",
                                cache=tm.init_cache(2, 32), pos=0)
    assert torch.equal(logits, want)
    dec, _ = tstep.build_serve_step(tm)(cache, {"tokens": tok[:, 8:]}, 8)
    want_dec, _ = tm.apply(tok[:, 8:], mode="decode", cache=want_cache,
                           pos=8)
    assert torch.equal(dec, want_dec)


# ------------------------------------------------------------------ trainer
def test_loss_descends(tmp_path):
    tm = build(configs.reduced("stablelm-1.6b"), device="cpu")
    data = TokenPipeline(DataConfig(vocab_size=tm.cfg.vocab_size,
                                    seq_len=16, global_batch=4))
    trainer = Trainer(
        tm, data,
        TrainerConfig(total_steps=30, ckpt_every=100,
                      opt=topt.AdamWConfig(lr=1e-2, warmup_steps=5)),
        str(tmp_path / "ckpt"), clock=itertools.count().__next__)
    trainer.init_or_restore()
    losses = trainer.fit()
    assert len(losses) == 30 and np.isfinite(losses).all()
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    assert last < first * 0.9, f"no descent: {first} -> {last}"
    assert trainer.step_seconds() == [1.0] * 30   # the fake clock's ticks


def test_trainer_without_clock_needs_the_card(tmp_path):
    tm = build(configs.reduced("stablelm-1.6b"), device="cpu")
    data = TokenPipeline(DataConfig(vocab_size=512, seq_len=8,
                                    global_batch=2))
    with pytest.raises(ValueError, match="CUDA"):
        Trainer(tm, data, TrainerConfig(), str(tmp_path))


def test_trainer_config_fields_match_reference_but_log_every():
    """The port's TrainerConfig has the reference's fields and defaults,
    less ``log_every``, which neither trainer reads."""
    from repro.train.trainer import TrainerConfig as JTrainerConfig

    def fields(cls):
        return {f.name: f.default for f in dataclasses.fields(cls)
                if f.name != "opt"}

    want = fields(JTrainerConfig)
    assert want.pop("log_every") == 10
    assert fields(TrainerConfig) == want


def test_embedding_sorted_backward_only_under_grad(monkeypatch):
    """The train forward reaches the sorted-gradient lookup; ``apply``
    (prefill, decode: no gradient) gathers directly, with the same rows."""
    from repro_torch.models import common
    from repro_torch.models import model as tmodel
    calls = []
    real = common.embed
    monkeypatch.setattr(tmodel, "embed",
                        lambda *a: calls.append(1) or real(*a))
    tm = build(configs.reduced("stablelm-1.6b"), device="cpu")
    tm.init(torch.Generator().manual_seed(0))
    tokens = torch.randint(0, tm.cfg.vocab_size, (2, 8),
                           generator=torch.Generator().manual_seed(1))
    served, _ = tm.apply(tokens)
    assert calls == []
    trained = tm(tokens, remat=False)
    assert calls == [1]
    torch.testing.assert_close(trained.detach(), served, rtol=0, atol=0)


class TestStragglerWatchdog:
    def test_flags_slow_steps(self):
        wd = StragglerWatchdog(factor=3.0, ema=0.9)
        hits = []
        for i, dt in enumerate([1.0, 1.1, 0.9, 1.0, 5.0, 1.0, 1.05]):
            wd.observe(i, dt, mitigate=lambda: hits.append(i))
        assert wd.flagged_steps == [4]
        assert wd.mitigations == 1
        assert hits == [4]

    def test_slow_steps_do_not_poison_ema(self):
        wd = StragglerWatchdog(factor=3.0, ema=0.5)
        for i, dt in enumerate([1.0, 1.0, 100.0, 1.0, 1.0]):
            wd.observe(i, dt)
        assert wd.ema < 3.0
        assert wd.observe(5, 10.0) is True


def test_convert_carries_opt_state_and_grads():
    jm = jbuild(dataclasses.replace(jconfigs.reduced("rwkv6-3b"),
                                    dtype="float32"))
    params = jm.init(jax.random.PRNGKey(0))
    state = jopt.init_opt_state(params)
    state["step"] = jnp.asarray(7, jnp.int32)
    got = convert.opt_state_from_reference(jm.cfg, _np(state))
    tm = build(dataclasses.replace(configs.reduced("rwkv6-3b"),
                                   dtype="float32"), device="meta")
    names = [n for n, _ in tm.named_parameters()]
    assert int(got["step"]) == 7 and got["step"].dtype == torch.int32
    for key in ("master", "m", "v"):
        assert sorted(got[key]) == sorted(names)
        assert all(t.dtype == torch.float32 for t in got[key].values())
    np.testing.assert_array_equal(
        got["master"]["layers.1.wk"].numpy(),
        np.asarray(params["layers"]["wk"][1]))
    grads = convert.model_params_from_reference(jm.cfg, _np(params))
    assert sorted(grads) == sorted(names)
