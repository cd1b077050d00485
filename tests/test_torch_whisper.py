"""The PyTorch port's audio family (whisper-small: a bidirectional encoder
over frame embeddings, a causal decoder with cross-attention) against the
JAX package's, on the reduced float32 config.

The JAX model's parameters are carried across by
``convert.model_params_from_reference`` (the stacked ``enc_layers`` and
``dec_layers`` split per layer); frames and tokens are numpy draws handed
to both.  Tolerances, float32 with full float32 matmuls:
- the encoder's output, the non-causal attention layer (its output and,
  under autograd, its gradients), and the train, prefill and decode
  logits within 1e-4: the same float32 products and softmax as the other
  transformer families, summed in other orders; the train forward
  (``Model.forward``) equals ``apply``'s train logits within 1e-6;
- the four caches (self k/v, cross k/v) within 1e-5: projections of the
  same inputs, before any softmax.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import whisper as jwhisper  # noqa: E402
from repro.models.model import build as jbuild  # noqa: E402
from repro.models.params import init_params  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models.model import build  # noqa: E402

ARCH = "whisper-small"
TOL, CACHE_TOL = 1e-4, 1e-5


@pytest.fixture(scope="module", autouse=True)
def _full_f32_matmuls():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_float32_matmul_precision(prev)


@pytest.fixture(scope="module")
def pair():
    """The reduced float32 whisper in both packages, one set of weights,
    the JAX apply jitted per mode."""
    jm = jbuild(dataclasses.replace(jconfigs.reduced(ARCH), dtype="float32"))
    params = jax.jit(jm.init)(jax.random.PRNGKey(0))
    tm = build(dataclasses.replace(configs.reduced(ARCH), dtype="float32"),
               device="cpu")
    tm.load_state_dict(convert.model_params_from_reference(
        tm.cfg, jax.tree.map(np.asarray, params)))
    japply = {mode: jax.jit(functools.partial(jm.apply, mode=mode))
              for mode in ("train", "prefill", "decode")}
    return jm, params, japply, tm


def _frames(cfg, b, seed):
    return np.random.default_rng(seed).normal(
        size=(b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                               rtol=tol)


def test_convert_splits_encoder_and_decoder_stacks(pair):
    jm, params, _, tm = pair
    tree = jax.tree.map(np.asarray, params)
    sd = convert.model_params_from_reference(tm.cfg, tree)
    assert set(sd) == set(tm.state_dict())
    np.testing.assert_array_equal(sd["enc_layers.1.attn.wk"].numpy(),
                                  tree["enc_layers"]["attn"]["wk"][1])
    np.testing.assert_array_equal(sd["dec_layers.0.cross_attn.wq"].numpy(),
                                  tree["dec_layers"]["cross_attn"]["wq"][0])
    assert tm.num_params() == jm.num_params()


def test_encoder_matches_jax(pair):
    jm, params, _, tm = pair
    frames = _frames(tm.cfg, 2, 0)
    want = jax.jit(functools.partial(jwhisper._encode, cfg=jm.cfg))(
        params, enc_frames=jnp.asarray(frames))
    with torch.no_grad():
        _close(tm.encode(torch.from_numpy(frames)), want)
        with pytest.raises(ValueError, match="encoder_seq"):
            tm.encode(torch.from_numpy(frames[:, :-1]))


def test_noncausal_attention_layer_matches_jax():
    """GQAAttention(causal=False) in train mode against the reference's
    ``gqa_attention(causal=False)``: every query sees every key."""
    jcfg = dataclasses.replace(jconfigs.reduced(ARCH), dtype="float32")
    cfg = dataclasses.replace(configs.reduced(ARCH), dtype="float32")
    p = init_params(jattn.gqa_specs(jcfg), jax.random.PRNGKey(2), jnp.float32)
    layer = attn.GQAAttention(cfg, dtype=torch.float32, device="cpu")
    layer.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in p.items()})
    x = np.random.default_rng(3).normal(size=(2, 19, cfg.d_model)).astype(
        np.float32)
    pos = np.zeros((2, 19), np.int32)
    want, _ = jattn.gqa_attention(p, jnp.asarray(x), jcfg, mode="train",
                                  cache=None, pos=0,
                                  positions=jnp.asarray(pos), causal=False)
    with torch.no_grad():
        got = layer(torch.from_numpy(x), mode="train", cache=None, pos=0,
                    positions=torch.from_numpy(pos).long(), causal=False)
        causal = layer(torch.from_numpy(x), mode="train", cache=None, pos=0,
                       positions=torch.from_numpy(pos).long())
    _close(got, want)
    assert not torch.allclose(got, causal, atol=1e-3)
    # under autograd (the trainable op): the same output, and the
    # gradients of x and of every weight as jax.vjp of the reference's
    g = np.random.default_rng(4).normal(size=x.shape).astype(np.float32)
    _, pullback = jax.vjp(
        jax.jit(lambda p_, x_: jattn.gqa_attention(
            p_, x_, jcfg, mode="train", cache=None, pos=0,
            positions=jnp.asarray(pos), causal=False)[0]),
        p, jnp.asarray(x))
    jgp, jgx = pullback(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    out = layer(xt, mode="train", cache=None, pos=0,
                positions=torch.from_numpy(pos).long(), causal=False)
    _close(out.detach(), want)
    grads = torch.autograd.grad(out, [xt, *layer.parameters()],
                                torch.from_numpy(g))
    _close(grads[0], jgx)
    for (name, _), got_g in zip(layer.named_parameters(), grads[1:]):
        _close(got_g, jgp[name])


def test_train_logits_match_jax(pair):
    jm, params, japply, tm = pair
    frames, tok = _frames(tm.cfg, 2, 4), _tokens(tm.cfg, 2, 17, 5)
    jl, _ = japply["train"](params, tokens=jnp.asarray(tok),
                            enc_frames=jnp.asarray(frames))
    tl, cache = tm.apply(torch.from_numpy(tok),
                         enc_frames=torch.from_numpy(frames), mode="train")
    assert tl.shape == (2, 17, tm.cfg.vocab_size) and cache is None
    _close(tl, jl)
    # the train forward (remat, under autograd) gives apply's logits
    fl = tm(torch.from_numpy(tok).long(),
            enc_frames=torch.from_numpy(frames))
    assert fl.requires_grad
    torch.testing.assert_close(fl.detach(), tl, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="enc_frames"):
        tm(torch.from_numpy(tok).long())


def test_prefill_then_decode_logits_and_caches_match_jax(pair):
    """Prefill 9 decoder tokens over the encoded frames, then three decode
    steps at per-row positions reading the cached cross k/v; all four
    caches against the JAX model's."""
    jm, params, japply, tm = pair
    b, s, cache_len = 2, 9, 24
    frames, tok = _frames(tm.cfg, b, 6), _tokens(tm.cfg, b, s + 3, 7)
    jcache, tcache = jm.init_cache(b, cache_len), tm.init_cache(b, cache_len)
    jl, jcache = japply["prefill"](params, tokens=jnp.asarray(tok[:, :s]),
                                   enc_frames=jnp.asarray(frames),
                                   cache=jcache, pos=0)
    tl, tcache = tm.apply(torch.from_numpy(tok[:, :s]),
                          enc_frames=torch.from_numpy(frames),
                          mode="prefill", cache=tcache, pos=0)
    assert tl.shape == (b, 1, tm.cfg.vocab_size)
    _close(tl, jl)
    for i in range(3):
        pos = np.array([s + i, s - 3 + 2 * i], np.int32)
        step = tok[:, s + i:s + i + 1]
        jl, jcache = japply["decode"](params, tokens=jnp.asarray(step),
                                      cache=jcache, pos=jnp.asarray(pos))
        tl, tcache = tm.apply(torch.from_numpy(step), mode="decode",
                              cache=tcache, pos=torch.from_numpy(pos))
        _close(tl, jl)
    assert set(tcache) == set(jcache["dec_layers"]) == {
        "k", "v", "cross_k", "cross_v"}
    for name, t in tcache.items():
        _close(t, jcache["dec_layers"][name], CACHE_TOL)
    with pytest.raises(ValueError, match="enc_frames"):
        tm.apply(torch.from_numpy(tok[:, :s]), mode="prefill",
                 cache=tm.init_cache(b, cache_len), pos=0)
