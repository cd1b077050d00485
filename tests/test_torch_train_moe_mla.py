"""Training the MoE family and MLA: the port's train step against the JAX
package's on the reduced float32 granite-moe-1b-a400m (MoE, GQA),
deepseek-v2-lite-16b (MoE, MLA, a dense first layer) and minicpm3-4b
(dense, MLA with q-LoRA), from the same carried weights and numpy batch;
the trainable flash op at Dqk != Dv against ``jax.vjp`` of the reference
model's ``sdpa_chunked`` (the reference's MLA train mode attends there:
its Pallas wrapper pads v to Dqk and takes no Dv of its own); and, within
the port, remat, a rerun bit for bit, the float32 router of a bf16 model
and ``convert`` across the dense prefix.

Tolerances (float32), those of ``tests/test_torch_train.py``: the loss
within rel 1e-5, every leaf's gradient within 1e-5 of that leaf's largest
(the same float32 products summed in other orders, the MoE's routing and
MLA's expansions included; the reduced MoE configs are dropless, so no
assignment's fate turns on the last bits of a router score), m and v of
one AdamW step within 1e-5 / 2e-5 of their leaf's largest, and its master
weights and parameters within 1e-5 where the reference's AdamW direction
is well conditioned, within twice the step's learning rate elsewhere (the
rule of ``tests/test_torch_train.py``, float32 router included).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import TokenPipeline as JTokenPipeline  # noqa: E402
from repro.models.attention import sdpa_chunked  # noqa: E402
from repro.models.model import build as jbuild  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.kernels.flash_attention import ops as tops  # noqa: E402
from repro_torch.models.model import build  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

ARCHS = ["granite-moe-1b-a400m", "deepseek-v2-lite-16b", "minicpm3-4b"]
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


def _batch(vocab, seq=SEQ, batch=BATCH, seed=0):
    pipe = JTokenPipeline(JDataConfig(vocab_size=vocab, seq_len=seq,
                                      global_batch=batch, seed=seed))
    return pipe.next_batch()


def _grad_close(got, want, rel=1e-5):
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=0, atol=rel * scale + 1e-12)


@pytest.fixture(scope="module", params=ARCHS)
def jax_step(request):
    """One JAX build per config: its parameters, a batch, the loss and
    gradients of the live JAX loss, and its AdamW state after one step."""
    arch = request.param
    jm = jbuild(dataclasses.replace(jconfigs.reduced(arch), dtype="float32"))
    params = jax.jit(jm.init)(jax.random.PRNGKey(0))
    batch = _batch(jm.cfg.vocab_size)
    jloss, jgrads = jax.jit(jax.value_and_grad(jstep.build_loss_fn(jm)))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    update = jax.jit(functools.partial(jopt.adamw_update,
                                       cfg=jopt.AdamWConfig(**OPT)))
    _, jstate = update(jgrads, jopt.init_opt_state(params))
    return arch, _np(params), batch, float(jloss), _np(jgrads), _np(jstate)


def _port(arch, params, **over):
    tm = build(dataclasses.replace(configs.reduced(arch), dtype="float32",
                                   **over), device="cpu")
    tm.load_state_dict(convert.model_params_from_reference(tm.cfg, params))
    return tm


def test_train_step_matches_jax(jax_step):
    """Loss and every leaf's gradient against the JAX loss; then one
    AdamW step's m, v and master weights against the JAX update of the
    JAX gradients."""
    arch, params, batch, jloss, jgrads, jstate = jax_step
    tm = _port(arch, params)
    loss = tstep.build_loss_fn(tm)(batch)
    named = list(tm.named_parameters())
    grads = torch.autograd.grad(loss, [p for _, p in named])
    np.testing.assert_allclose(float(loss.detach()), jloss, rtol=1e-5)
    want = convert.model_params_from_reference(tm.cfg, jgrads)
    assert sorted(want) == sorted(n for n, _ in named)
    for (name, _), g in zip(named, grads):
        assert torch.isfinite(g).all(), name
        _grad_close(g, want[name].float())

    tparams = dict(tm.named_parameters())
    cfg = topt.AdamWConfig(**OPT)
    tl, _, ts = tstep.build_train_step(tm, cfg)(
        tparams, topt.init_opt_state(tparams), batch)
    np.testing.assert_allclose(float(tl), jloss, rtol=1e-5)
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


# ---------------------------------------------- the trainable op, Dqk != Dv
@pytest.mark.parametrize("b,h,hkv,s,dqk,dv", [
    (2, 4, 4, 40, 24, 16),      # the reduced MLA configs' pair
    (1, 4, 2, 70, 96, 64),      # minicpm3's pair, GQA group 2
])
def test_trainable_two_head_dims_match_jax_vjp(b, h, hkv, s, dqk, dv):
    rng = np.random.default_rng(s + dqk)
    q = rng.normal(size=(b, s, h, dqk)).astype(np.float32)
    k = rng.normal(size=(b, s, hkv, dqk)).astype(np.float32)
    v = rng.normal(size=(b, s, hkv, dv)).astype(np.float32)
    g = rng.normal(size=(b, s, h, dv)).astype(np.float32)
    scale = dqk ** -0.5

    def attend(q_, k_, v_):
        return sdpa_chunked(q_, k_, v_, causal=True, q_offset=0, kv_len=s,
                            scale=scale, chunk=32)

    jout, pullback = jax.vjp(jax.jit(attend),
                             *(jnp.asarray(x) for x in (q, k, v)))
    jgrads = pullback(jnp.asarray(g))
    targs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = tops.flash_attention_trainable(*targs, scale=scale, layout="bshd")
    grads = torch.autograd.grad(out, targs, torch.from_numpy(g))
    tol = dict(atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **tol)
    for name, got, want, x in zip("qkv", grads, jgrads, targs):
        assert got.shape == x.shape, name
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol,
                                   err_msg=f"d{name}")


# ------------------------------------------------------- within the port
def test_remat_policies_agree_on_moe_mla():
    """remat off, "full" and "dots" give deepseek (MoE, MLA, the dense
    prefix) one loss and one gradient."""
    batch = _batch(512)
    out = []
    for policy, remat in (("full", False), ("full", True), ("dots", True)):
        tm = build(dataclasses.replace(
            configs.reduced("deepseek-v2-lite-16b"), dtype="float32",
            remat_policy=policy), device="cpu")
        tm.init(torch.Generator().manual_seed(0))
        loss = tstep.cross_entropy(tm(torch.from_numpy(batch["tokens"]),
                                      remat=remat),
                                   torch.from_numpy(batch["labels"]))
        out.append((loss.detach(), torch.autograd.grad(
            loss, list(tm.parameters()))))
    for loss, grads in out[1:]:
        torch.testing.assert_close(loss, out[0][0], rtol=1e-6, atol=0)
        for g, g0 in zip(grads, out[0][1]):
            _grad_close(g, g0, rel=1e-6)


def _one_step(arch, dtype, seed=3):
    tm = build(dataclasses.replace(configs.reduced(arch), dtype=dtype),
               device="cpu")
    params, opt = tstep.init_train_state(tm, torch.Generator().manual_seed(
        seed))
    batch = _batch(tm.cfg.vocab_size, seq=16, batch=4)
    loss, params, opt = tstep.build_train_step(
        tm, topt.AdamWConfig(lr=1e-3))(params, opt, batch)
    return tm, float(loss), params, opt


def test_moe_train_step_is_bit_for_bit_on_rerun():
    runs = [_one_step("granite-moe-1b-a400m", "bfloat16") for _ in range(2)]
    assert runs[0][1] == runs[1][1]
    for name, p in runs[0][2].items():
        assert torch.equal(p, runs[1][2][name]), name


def test_bf16_model_keeps_a_float32_router():
    """The router (and the norms) are float32 leaves of a bf16 model: the
    step keeps each parameter's dtype, and its gradient and AdamW state
    are float32."""
    tm, loss, params, opt = _one_step("granite-moe-1b-a400m", "bfloat16")
    assert np.isfinite(loss)
    router = "layers.0.moe.router"
    assert params[router].dtype == torch.float32
    assert params["layers.0.moe.w_gate"].dtype == torch.bfloat16
    assert all(opt[key][router].dtype == torch.float32
               for key in ("master", "m", "v"))
    torch.testing.assert_close(params[router], opt["master"][router],
                               rtol=0, atol=0)
    grads = torch.autograd.grad(
        tstep.build_loss_fn(tm)(_batch(tm.cfg.vocab_size, 16, 4)),
        [params[router], params["layers.0.moe.w_gate"]])
    assert [g.dtype for g in grads] == [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b",
                                  "granite-moe-1b-a400m"])
def test_moe_layer_vjp_matches_jax_with_drops(arch):
    """The MoE layer's gradients (its input, router, experts, shared MLP)
    against ``jax.vjp`` of the reference ``moe`` at capacity factor 1.0,
    where assignments drop: dropped copies get no gradient in either, the
    kept ones reach their token through the dispatch's gather.
    Within 1e-5 of each gradient's largest."""
    from repro.models import ffn as jffn
    from repro.models.params import init_params
    from repro_torch.models.ffn import MoE
    upd = dict(dtype="float32", moe_capacity_factor=1.0)
    cfg = dataclasses.replace(configs.reduced(arch), **upd)
    jcfg = dataclasses.replace(jconfigs.reduced(arch), **upd)
    p = _np(jax.jit(functools.partial(init_params, jffn.moe_specs(jcfg),
                                      default_dtype=jnp.float32))(
        jax.random.PRNGKey(1)))
    layer = MoE(cfg, dtype=torch.float32, device="cpu")
    layer.load_state_dict({name: torch.from_numpy(np.array(leaf))
                           for name, leaf in convert._flatten(p)})
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 48, cfg.d_model)).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    jout, pullback = jax.vjp(jax.jit(functools.partial(jffn.moe, cfg=jcfg)),
                             jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    jgp, jgx = pullback(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    names = [n for n, _ in layer.named_parameters()]
    out = layer(xt)
    grads = torch.autograd.grad(out, [xt, *layer.parameters()],
                                torch.from_numpy(g))
    valid = layer.dispatch(xt.detach().reshape(-1, cfg.d_model))[3]
    assert (~valid).any()                    # capacity 1.0 drops some
    _grad_close(out.detach(), torch.from_numpy(np.array(jout)))
    _grad_close(grads[0], torch.from_numpy(np.array(jgx)))
    want = dict(convert._flatten(_np(jgp)))
    for name, got in zip(names, grads[1:]):
        _grad_close(got, torch.from_numpy(np.array(want[name])))


def test_convert_carries_grads_and_opt_state_across_the_prefix(jax_step):
    """JAX ``prefix.<i>`` leaves become port layer i and stacked layer j
    port layer first_dense_layers + j, for gradients and the AdamW state
    as for parameters."""
    arch, params, _, _, jgrads, jstate = jax_step
    tm = build(dataclasses.replace(configs.reduced(arch), dtype="float32"),
               device="meta")
    names = sorted(n for n, _ in tm.named_parameters())
    grads = convert.model_params_from_reference(tm.cfg, jgrads)
    state = convert.opt_state_from_reference(tm.cfg, jstate)
    assert sorted(grads) == names and int(state["step"]) == 1
    first = tm.cfg.first_dense_layers
    for key in ("master", "m", "v"):
        assert sorted(state[key]) == names
        if first:
            np.testing.assert_array_equal(
                state[key]["layers.0.mlp.w_up"].numpy(),
                np.asarray(jstate[key]["prefix"][0]["mlp"]["w_up"]))
        np.testing.assert_array_equal(
            state[key][f"layers.{first}.attn.wo"].numpy(),
            np.asarray(jstate[key]["layers"]["attn"]["wo"][0]))
    if first:
        np.testing.assert_array_equal(
            grads["layers.0.attn.wkv_a"].numpy(),
            np.asarray(jgrads["prefix"][0]["attn"]["wkv_a"]))
