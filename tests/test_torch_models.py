"""The PyTorch port's models against the JAX package's, on the reduced
configs of the ported families: stablelm-1.6b (dense, GQA), minicpm3-4b
(dense, MLA with q-LoRA), granite-moe-1b-a400m (MoE, GQA),
deepseek-v2-lite-16b (MoE, MLA, a dense first layer) and rwkv6-3b (RWKV).

The JAX model's parameters are carried across by
``convert.model_params_from_reference``, so both compute the same function
on the same weights.  Tolerances, float32 (``dtype="float32"``):
- transformer logits within 1e-4: the same float32 products and softmax,
  summed in other orders (MoE routing and its capacity drops, MLA's
  absorbed decode included: the reduced MoE configs are dropless);
- RWKV logits within 2e-3: the recurrence runs in chunks of 32 in the port
  and of ``pick_chunk(T)`` in the JAX model, and its decays are applied in
  log space — the reference kernels' own 2e-3.
In bfloat16 the two frameworks round at different places.  The port is held
to the reference's own prefill/decode consistency at 5e-2
(``tests/test_models.py``), the transformer to the JAX bf16 logits at
5e-2, and the RWKV model, whose bf16 logits move by up to ~0.1-0.4 against
float32 in the reference itself, to stay within 1.5 times the reference
bf16's own distance from the float32 reference (mean and max; the two
are within 10% of each other on these inputs).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.models.model import build as jbuild  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.models.model import build  # noqa: E402

# the bf16 checks' architectures; the float32 parity runs all of ARCHS
BF16_ARCHS = ["stablelm-1.6b", "rwkv6-3b"]
MOE_MLA = ["minicpm3-4b", "granite-moe-1b-a400m", "deepseek-v2-lite-16b"]
ARCHS = BF16_ARCHS + MOE_MLA
# registry architectures of the dense, MoE and RWKV families
BUILT = ["deepseek-v2-lite-16b", "granite-moe-1b-a400m", "internlm2-20b",
         "minicpm3-4b", "phi3-medium-14b", "rwkv6-3b", "stablelm-1.6b"]
# the vlm, audio and hybrid families' published parameter counts
SERVE_ONLY_PARAMS = {"jamba-v0.1-52b": 51_570_315_264,
                     "whisper-small": 304_217_088,
                     "qwen2-vl-7b": 7_070_490_112}
F32_TOL = {"stablelm-1.6b": 1e-4, "rwkv6-3b": 2e-3,
           **{arch: 1e-4 for arch in MOE_MLA}}


@pytest.fixture(scope="module", autouse=True)
def _full_f32_matmuls():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_float32_matmul_precision(prev)


def _pair(arch, dtype="float32"):
    jm = jbuild(dataclasses.replace(jconfigs.reduced(arch), dtype=dtype))
    params = jm.init(jax.random.PRNGKey(0))
    tm = build(dataclasses.replace(configs.reduced(arch), dtype=dtype),
               device="cpu")
    tm.load_state_dict(convert.model_params_from_reference(
        tm.cfg, jax.tree.map(np.asarray, params)))
    return jm, params, tm


@pytest.fixture(scope="module", params=ARCHS)
def f32_pair(request):
    return request.param, *_pair(request.param)


def _tokens(vocab, b, s, seed):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _close(got, want, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                               rtol=tol)


def _stacked(jcache, name):
    """The JAX cache's leaf ``name`` over every layer, as the port stacks
    it: the unstacked ``prefix`` layers (deepseek's dense first layer)
    first, then the scanned ``layers``."""
    prefix = [c[name][None] for c in jcache.get("prefix", [])]
    return np.concatenate([*prefix, jcache["layers"][name]], axis=0)


def _set_slot(jcache, single, slot):
    """Write a one-slot JAX cache into slot ``slot`` of a pool cache: the
    slot axis is 1 in the stacked ``layers``, 0 in the ``prefix`` layers."""
    out = {"layers": jax.tree.map(lambda c, n: c.at[:, slot].set(n[:, 0]),
                                  jcache["layers"], single["layers"])}
    if "prefix" in jcache:
        out["prefix"] = jax.tree.map(lambda c, n: c.at[slot].set(n[0]),
                                     jcache["prefix"], single["prefix"])
    return out


def test_train_logits_match_jax(f32_pair):
    arch, jm, params, tm = f32_pair
    tok = _tokens(tm.cfg.vocab_size, 2, 40, 0)
    jl, _ = jm.apply(params, tokens=jnp.asarray(tok), mode="train")
    tl, cache = tm.apply(torch.from_numpy(tok), mode="train")
    assert tl.shape == (2, 40, tm.cfg.vocab_size) and cache is None
    _close(tl, jl, F32_TOL[arch])


def test_prefill_then_decode_logits_match_jax(f32_pair):
    """Prefill 12 tokens, then three decode steps with per-row positions
    (the engine's vector ``pos``), against the JAX model step for step."""
    arch, jm, params, tm = f32_pair
    b, s, cache_len = 2, 12, 32
    tok = _tokens(tm.cfg.vocab_size, b, s + 3, 1)
    jcache = jm.init_cache(b, cache_len)
    tcache = tm.init_cache(b, cache_len)
    jl, jcache = jm.apply(params, tokens=jnp.asarray(tok[:, :s]),
                          mode="prefill", cache=jcache, pos=0)
    tl, tcache = tm.apply(torch.from_numpy(tok[:, :s]), mode="prefill",
                          cache=tcache, pos=0)
    assert tl.shape == (b, 1, tm.cfg.vocab_size)
    _close(tl, jl, F32_TOL[arch])
    for i in range(3):
        pos = np.full(b, s + i, np.int32)
        step = tok[:, s + i:s + i + 1]
        jl, jcache = jm.apply(params, tokens=jnp.asarray(step),
                              mode="decode", cache=jcache,
                              pos=jnp.asarray(pos))
        tl, tcache = tm.apply(torch.from_numpy(step), mode="decode",
                              cache=tcache, pos=torch.from_numpy(pos))
        _close(tl, jl, F32_TOL[arch])
    for name, t in tcache.items():
        _close(t, _stacked(jcache, name), F32_TOL[arch])


def test_decode_at_different_slot_positions_matches_jax(f32_pair):
    """Two slots prefilled to different lengths, one batched decode at
    positions (5, 9): the per-slot fill levels of continuous batching."""
    arch, jm, params, tm = f32_pair
    cache_len = 24
    jcache = jm.init_cache(2, cache_len)
    tcache = tm.init_cache(2, cache_len)
    lens = (5, 9)
    for slot, n in enumerate(lens):
        tok = _tokens(tm.cfg.vocab_size, 1, n, 10 + slot)
        single = jm.init_cache(1, cache_len)
        _, single = jm.apply(params, tokens=jnp.asarray(tok), mode="prefill",
                             cache=single, pos=0)
        jcache = _set_slot(jcache, single, slot)
        tm.apply(torch.from_numpy(tok), mode="prefill",
                 cache=tm.slot_view(tcache, slot), pos=0)
    step = _tokens(tm.cfg.vocab_size, 2, 1, 12)
    pos = np.asarray(lens, np.int32)
    jl, _ = jm.apply(params, tokens=jnp.asarray(step), mode="decode",
                     cache=jcache, pos=jnp.asarray(pos))
    tl, _ = tm.apply(torch.from_numpy(step), mode="decode", cache=tcache,
                     pos=torch.from_numpy(pos))
    _close(tl, jl, F32_TOL[arch])


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_prefill_decode_consistency(arch):
    """The reference's own check (tests/test_models.py) on the port in
    bfloat16: prefill on S tokens, then decode token S, against the train
    forward on S + 1 tokens, within 5e-2."""
    tm = build(configs.reduced(arch), device="cpu").init(
        torch.Generator().manual_seed(0))
    assert tm.embed.dtype == torch.bfloat16
    b, s = 2, 12
    tok = torch.from_numpy(_tokens(tm.cfg.vocab_size, b, s + 1, 2))
    ref, _ = tm.apply(tok, mode="train")
    cache = tm.init_cache(b, 32)
    pre, cache = tm.apply(tok[:, :s], mode="prefill", cache=cache, pos=0)
    torch.testing.assert_close(pre[:, 0], ref[:, s - 1], atol=5e-2,
                               rtol=5e-2)
    step, _ = tm.apply(tok[:, s:], mode="decode", cache=cache, pos=s)
    torch.testing.assert_close(step[:, 0], ref[:, s], atol=5e-2, rtol=5e-2)


@pytest.mark.parametrize("arch", BF16_ARCHS)
def test_bf16_logits_against_jax(arch):
    jm, params, tm = _pair(arch, "bfloat16")
    tok = _tokens(tm.cfg.vocab_size, 2, 13, 3)
    jl, _ = jm.apply(params, tokens=jnp.asarray(tok), mode="train")
    tl, _ = tm.apply(torch.from_numpy(tok), mode="train")
    got, want = tl.numpy(), np.asarray(jl, np.float32)
    if arch == "stablelm-1.6b":
        np.testing.assert_allclose(got, want, atol=5e-2, rtol=5e-2)
        return
    jf = jbuild(dataclasses.replace(jm.cfg, dtype="float32"))
    exact, _ = jf.apply(jax.tree.map(lambda a: a.astype(jnp.float32), params),
                        tokens=jnp.asarray(tok), mode="train")
    exact = np.asarray(exact)
    port_err, ref_err = np.abs(got - exact), np.abs(want - exact)
    assert port_err.mean() <= 1.5 * ref_err.mean()
    assert port_err.max() <= 1.5 * ref_err.max()


@pytest.mark.parametrize("arch", BUILT)
def test_full_config_parameter_count_equals_reference(arch):
    """The published configs, shapes only (the meta device)."""
    tm = build(configs.get(arch), device="meta")
    assert tm.num_params() == jbuild(jconfigs.get(arch)).num_params()
    for f in dataclasses.fields(configs.get(arch)):
        assert getattr(configs.get(arch), f.name) == getattr(
            jconfigs.get(arch), f.name), f.name


@pytest.mark.parametrize("arch", sorted(jconfigs.ARCHS))
def test_reduced_configs_equal_reference(arch):
    want = dataclasses.asdict(jconfigs.reduced(arch))
    assert dataclasses.asdict(configs.reduced(arch)) == want


def test_init_rule_and_seed():
    cfg = configs.reduced("rwkv6-3b")
    a = build(cfg, device="cpu").init(torch.Generator().manual_seed(3))
    b = build(cfg, device="cpu").init(torch.Generator().manual_seed(3))
    for (name, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(pa, pb), name
    layer = a.layers[0]
    assert layer.w0.dtype == layer.u.dtype == layer.ln_x.dtype == torch.float32
    assert layer.wr.dtype == torch.bfloat16
    assert torch.all(layer.w0 == 0) and torch.all(layer.ln_x == 1)
    assert torch.all(a.final_norm == 1)
    # normal x 1/sqrt(fan_in): embed has fan_in 1, cwv fan_in d_ff
    assert a.embed.float().std().item() == pytest.approx(1.0, rel=0.05)
    assert layer.cwv.float().std().item() == pytest.approx(
        cfg.d_ff ** -0.5, rel=0.05)


@pytest.mark.parametrize("arch", sorted(jconfigs.ARCHS))
def test_every_registry_arch_builds(arch):
    """Every registry config builds at full size on the meta device (the
    vlm, audio and hybrid families too), with as many
    parameters as its shape table and the JAX model count."""
    from repro_torch.models.model import num_params

    assert set(BUILT) | set(SERVE_ONLY_PARAMS) == set(jconfigs.ARCHS) == set(
        configs.ARCHS)
    cfg = configs.get(arch)
    tm = build(cfg, device="meta")
    assert tm.num_params() == num_params(cfg) == jbuild(
        jconfigs.get(arch)).num_params()
    if arch in SERVE_ONLY_PARAMS:
        assert tm.num_params() == SERVE_ONLY_PARAMS[arch]
    with pytest.raises(KeyError):
        configs.get("no-such-arch")


@pytest.mark.parametrize("arch", MOE_MLA)
def test_training_moe_and_mla_runs(arch):
    """The grad-enabled forward and the train step take MoE and MLA
    models: every parameter gets a finite gradient and the step moves the
    loss down on a repeated batch; apply(mode="train") gives the same
    logits as the train forward (their parity with the JAX train step:
    tests/test_torch_train_moe_mla.py)."""
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.step import build_train_step, init_train_state

    tm = build(configs.reduced(arch), device="cpu")
    params, opt = init_train_state(tm, torch.Generator().manual_seed(0))
    tok = torch.from_numpy(_tokens(tm.cfg.vocab_size, 2, 12, 3)).long()
    logits = tm(tok)
    served, _ = tm.apply(tok)
    torch.testing.assert_close(logits.detach(), served, rtol=0, atol=0)
    grads = torch.autograd.grad(logits.square().mean(), list(tm.parameters()))
    assert all(torch.isfinite(g).all() for g in grads)
    assert all(g.abs().max() > 0 for g in grads)
    batch = {"tokens": tok.numpy(), "labels": tok.numpy()}
    step = build_train_step(tm, AdamWConfig(lr=1e-2, warmup_steps=1))
    losses = []
    for _ in range(3):
        loss, params, opt = step(params, opt, batch)
        losses.append(float(loss))
    assert losses[-1] < losses[0]


def test_layer_list_keeps_the_dense_prefix_first():
    """deepseek's first layer is dense (its d_ff), the rest MoE with
    shared experts; granite-moe is MoE throughout; minicpm3 dense MLA."""
    from repro_torch.models.attention import GQAAttention, MLAAttention
    from repro_torch.models.transformer import DenseLayer, MoELayer

    ds = build(configs.get("deepseek-v2-lite-16b"), device="meta")
    assert [type(m) for m in ds.layers] == [DenseLayer] + [MoELayer] * 26
    assert ds.layers[0].mlp.w_gate.shape == (2048, 10944)
    assert isinstance(ds.layers[5].attn, MLAAttention)
    assert ds.layers[5].moe.w_gate.shape == (64, 2048, 1408)
    assert ds.layers[5].moe.shared.w_gate.shape == (2048, 2 * 1408)
    gr = build(configs.get("granite-moe-1b-a400m"), device="meta")
    assert {type(m) for m in gr.layers} == {MoELayer}
    assert isinstance(gr.layers[0].attn, GQAAttention)
    cache = ds.init_cache(2, 8)
    assert {k: tuple(t.shape) for k, t in cache.items()} == {
        "c_kv": (27, 2, 8, 512), "k_rope": (27, 2, 8, 64)}


def test_convert_maps_the_prefix_before_the_stack():
    jm, params, tm = _pair("deepseek-v2-lite-16b")
    tree = jax.tree.map(np.asarray, params)
    sd = convert.model_params_from_reference(tm.cfg, tree)
    assert set(sd) == set(tm.state_dict())
    np.testing.assert_array_equal(sd["layers.0.mlp.w_up"].numpy(),
                                  tree["prefix"][0]["mlp"]["w_up"])
    np.testing.assert_array_equal(sd["layers.1.moe.shared.w_down"].numpy(),
                                  tree["layers"]["moe"]["shared"]["w_down"][0])
    np.testing.assert_array_equal(sd["layers.1.attn.wkv_a"].numpy(),
                                  tree["layers"]["attn"]["wkv_a"][0])
    with pytest.raises(ValueError, match="prefix"):
        convert.model_params_from_reference(
            dataclasses.replace(tm.cfg, first_dense_layers=0), tree)


def test_build_defaults_to_the_card():
    cfg = configs.reduced("stablelm-1.6b")
    if torch.cuda.is_available():
        assert build(cfg).embed.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match='device="cpu"'):
        build(cfg)


def test_convert_splits_stacked_layers():
    jm, params, tm = _pair("stablelm-1.6b")
    sd = convert.model_params_from_reference(
        tm.cfg, jax.tree.map(np.asarray, params))
    assert set(sd) == set(tm.state_dict())
    np.testing.assert_array_equal(
        sd["layers.1.attn.wq"].numpy(),
        np.asarray(params["layers"]["attn"]["wq"][1]))
    with pytest.raises(ValueError, match="layers"):
        convert.model_params_from_reference(
            dataclasses.replace(tm.cfg, num_layers=3),
            jax.tree.map(np.asarray, params))
