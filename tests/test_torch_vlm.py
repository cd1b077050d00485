"""The PyTorch port's vlm family (qwen2-vl: embedding inputs, M-RoPE)
against the JAX package's.

The JAX model's parameters are carried across by
``convert.model_params_from_reference``; inputs are numpy draws handed to
both.  Tolerances:
- ``apply_mrope`` and ``rope_for`` within 1e-6: the same float32 angles,
  cosines and products (the two libraries' cos/sin may differ in the last
  bit);
- the reduced float32 qwen2-vl's logits and k/v caches within 1e-4, as the
  other transformer families (tests/test_torch_models.py): the same float32
  products and softmax, summed in other orders;
- in bfloat16 the port's own prefill/decode consistency against its train
  forward within the reference's 5e-2 (tests/test_models.py).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models.model import build as jbuild  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.models.model import build  # noqa: E402

ARCH = "qwen2-vl-7b"
TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _full_f32_matmuls():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_float32_matmul_precision(prev)


@pytest.fixture(scope="module")
def pair():
    """The reduced float32 qwen2-vl in both packages, one set of weights,
    and the JAX apply jitted per mode."""
    jm = jbuild(dataclasses.replace(jconfigs.reduced(ARCH), dtype="float32"))
    params = jax.jit(jm.init)(jax.random.PRNGKey(0))
    tm = build(dataclasses.replace(configs.reduced(ARCH), dtype="float32"),
               device="cpu")
    tm.load_state_dict(convert.model_params_from_reference(
        tm.cfg, jax.tree.map(np.asarray, params)))
    japply = {mode: jax.jit(functools.partial(jm.apply, mode=mode))
              for mode in ("train", "prefill", "decode")}
    return jm, params, japply, tm


def _embeds(d, b, s, seed):
    return np.random.default_rng(seed).normal(size=(b, s, d)).astype(
        np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("sections", [(4, 6, 6), (16, 24, 24)])
def test_apply_mrope_matches_jax_with_three_streams(sections):
    rng = np.random.default_rng(0)
    d = 2 * sum(sections)
    x = rng.normal(size=(2, 7, 3, d)).astype(np.float32)
    pos = np.stack([rng.integers(0, 4096, (2, 7)) for _ in range(3)]).astype(
        np.int32)
    assert not (pos[0] == pos[1]).all() and not (pos[1] == pos[2]).all()
    want = jcommon.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6,
                               sections)
    got = common.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                             sections)
    _close(got, want, 1e-6)
    with pytest.raises(ValueError, match="sections"):
        common.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                           (4, 4, 4))


def test_rope_for_repeats_two_dim_positions():
    """(B, S) positions are the one stream all three sections take, as the
    reference's ``rope_for``; three equal streams are the standard rotary
    embedding bit for bit."""
    cfg = configs.reduced(ARCH)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 9, 4, cfg.head_dim)).astype(np.float32)
    pos = rng.integers(0, 2048, (2, 9)).astype(np.int32)
    want = jcommon.rope_for(jconfigs.reduced(ARCH), jnp.asarray(x),
                            jnp.asarray(pos))
    got = common.rope_for(cfg, torch.from_numpy(x), torch.from_numpy(pos))
    _close(got, want, 1e-6)
    three = torch.from_numpy(np.stack([pos] * 3))
    torch.testing.assert_close(
        common.rope_for(cfg, torch.from_numpy(x), three), got, rtol=0, atol=0)
    torch.testing.assert_close(
        common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                          cfg.rope_theta), got, rtol=0, atol=0)


def test_train_logits_match_jax(pair):
    jm, params, japply, tm = pair
    assert "embed" not in dict(tm.named_parameters())
    emb = _embeds(tm.cfg.d_model, 2, 24, 0)
    jl, _ = japply["train"](params, embeds=jnp.asarray(emb))
    tl, cache = tm.apply(embeds=torch.from_numpy(emb), mode="train")
    assert tl.shape == (2, 24, tm.cfg.vocab_size) and cache is None
    _close(tl, jl)


def test_prefill_then_decode_logits_and_caches_match_jax(pair):
    """Prefill 12 embeddings, then three one-embedding decode steps at
    per-row positions (the engine's vector ``pos``)."""
    jm, params, japply, tm = pair
    b, s, cache_len = 2, 12, 32
    emb = _embeds(tm.cfg.d_model, b, s + 3, 1)
    jcache, tcache = jm.init_cache(b, cache_len), tm.init_cache(b, cache_len)
    jl, jcache = japply["prefill"](params, embeds=jnp.asarray(emb[:, :s]),
                                   cache=jcache, pos=0)
    tl, tcache = tm.apply(embeds=torch.from_numpy(emb[:, :s]),
                          mode="prefill", cache=tcache, pos=0)
    assert tl.shape == (b, 1, tm.cfg.vocab_size)
    _close(tl, jl)
    for i in range(3):
        pos = np.array([s + i, s + i - 1 + i], np.int32)  # per-row levels
        step = emb[:, s + i:s + i + 1]
        jl, jcache = japply["decode"](params, embeds=jnp.asarray(step),
                                      cache=jcache, pos=jnp.asarray(pos))
        tl, tcache = tm.apply(embeds=torch.from_numpy(step), mode="decode",
                              cache=tcache, pos=torch.from_numpy(pos))
        _close(tl, jl)
    assert set(tcache) == set(jcache["layers"]) == {"k", "v"}
    for name, t in tcache.items():
        _close(t, jcache["layers"][name])


def test_inputs_are_refused_where_they_do_not_belong(pair):
    _, _, _, tm = pair
    emb = torch.zeros(1, 4, tm.cfg.d_model)
    with pytest.raises(ValueError, match="embeds"):
        tm.apply(torch.zeros(1, 4, dtype=torch.long), mode="train")
    with pytest.raises(ValueError, match="enc_frames"):
        tm.apply(embeds=emb, enc_frames=emb, mode="train")
    # the train forward refuses the same inputs, and on embeds gives
    # apply's train logits with gradients
    with pytest.raises(ValueError, match="embeds"):
        tm(torch.zeros(1, 4, dtype=torch.long))
    emb = torch.from_numpy(_embeds(tm.cfg.d_model, 2, 10, 3))
    fl = tm(embeds=emb)
    assert fl.requires_grad
    want, _ = tm.apply(embeds=emb, mode="train")
    torch.testing.assert_close(fl.detach(), want, rtol=1e-6, atol=1e-6)


def test_bf16_prefill_decode_consistency():
    """The reference's own check (tests/test_models.py) on the port in
    bfloat16: prefill on S embeddings, then decode embedding S, against
    the train forward on S + 1, within 5e-2."""
    tm = build(configs.reduced(ARCH), device="cpu").init(
        torch.Generator().manual_seed(0))
    assert tm.lm_head.dtype == torch.bfloat16
    b, s = 2, 12
    emb = torch.from_numpy(_embeds(tm.cfg.d_model, b, s + 1, 2))
    ref, _ = tm.apply(embeds=emb, mode="train")
    cache = tm.init_cache(b, 32)
    pre, cache = tm.apply(embeds=emb[:, :s], mode="prefill", cache=cache,
                          pos=0)
    torch.testing.assert_close(pre[:, 0], ref[:, s - 1], atol=5e-2,
                               rtol=5e-2)
    step, _ = tm.apply(embeds=emb[:, s:], mode="decode", cache=cache, pos=s)
    torch.testing.assert_close(step[:, 0], ref[:, s], atol=5e-2, rtol=5e-2)
