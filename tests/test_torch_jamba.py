"""The PyTorch port's hybrid family (jamba: Mamba and attention layers,
MoE and dense feed-forwards, period-8 blocks) against the JAX package's.

The JAX model's parameters are carried across by
``convert.model_params_from_reference`` (block b's slot i becomes port
layer 8 b + i).  Tolerances, float32 with full float32 matmuls:
- train, prefill and decode logits within 1e-4, as the other transformer
  families (tests/test_torch_models.py); the Mamba scan is sequential in
  the port and associative in the reference, which the reduced model's
  logits do not tell apart at that level (tests/test_torch_mamba.py holds
  the scan itself to 1e-5 of its largest);
- the caches, mapped per kind (the port's k/v over the attention layers,
  conv/h over the Mamba layers; the reference's per-block trees), within
  1e-4;
- the serving engine's greedy tokens equal to the JAX engine's, token for
  token (the reduced MoE config is dropless, as in tests/test_torch_serve.py).
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
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.models.model import build  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

ARCH = "jamba-v0.1-52b"
TOL = 1e-4
PERIOD = 8


@pytest.fixture(scope="module", autouse=True)
def _full_f32_matmuls():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_float32_matmul_precision(prev)


@pytest.fixture(scope="module")
def pair():
    """The reduced float32 jamba (8 layers, one block) in both packages,
    one set of weights, the JAX apply jitted per mode."""
    jm = jbuild(dataclasses.replace(jconfigs.reduced(ARCH), dtype="float32"))
    params = jax.jit(jm.init)(jax.random.PRNGKey(0))
    tm = build(dataclasses.replace(configs.reduced(ARCH), dtype="float32"),
               device="cpu")
    tm.load_state_dict(convert.model_params_from_reference(
        tm.cfg, jax.tree.map(np.asarray, params)))
    japply = {mode: jax.jit(functools.partial(jm.apply, mode=mode))
              for mode in ("train", "prefill", "decode")}
    return jm, params, japply, tm


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                               rtol=tol)


def _per_kind(cfg, jcache, name):
    """The JAX cache's leaf ``name`` stacked as the port stacks it: over
    the layers of its kind in order, block by block."""
    blocks = jcache["blocks"]
    return np.concatenate([
        np.asarray(blocks[f"l{i}"][name])[b][None]
        for b in range(cfg.num_layers // PERIOD) for i in range(PERIOD)
        if name in blocks[f"l{i}"]], axis=0)


def test_layers_and_caches_by_kind(pair):
    _, _, _, tm = pair
    cfg = tm.cfg
    kinds = [("attn" if hasattr(m, "attn") else "mamba",
              "moe" if hasattr(m, "moe") else "mlp") for m in tm.layers]
    assert kinds == [("attn" if i == 4 else "mamba", "moe" if i % 2 else "mlp")
                     for i in range(PERIOD)]
    cache = tm.init_cache(3, 16)
    shapes = {k: tuple(t.shape) for k, t in cache.items()}
    assert shapes == {
        "k": (1, 3, 16, cfg.num_kv_heads, cfg.head_dim),
        "v": (1, 3, 16, cfg.num_kv_heads, cfg.head_dim),
        "conv": (7, 3, cfg.ssm_d_conv - 1, cfg.ssm_d_inner),
        "h": (7, 3, cfg.ssm_d_inner, cfg.ssm_d_state)}
    assert cache["h"].dtype == torch.float32
    assert set(tm.layer_cache(cache, 4)) == {"k", "v"}
    assert tm.layer_cache(cache, 5)["h"].data_ptr() == cache["h"][4].data_ptr()


def test_train_logits_match_jax(pair):
    jm, params, japply, tm = pair
    tok = _tokens(tm.cfg, 2, 29, 0)
    jl, _ = japply["train"](params, tokens=jnp.asarray(tok))
    tl, _ = tm.apply(torch.from_numpy(tok), mode="train")
    _close(tl, jl)
    # the train forward (remat, the scan's trainable op) gives apply's
    # logits with gradients
    fl = tm(torch.from_numpy(tok).long())
    assert fl.requires_grad
    torch.testing.assert_close(fl.detach(), tl, rtol=1e-6, atol=1e-6)


def test_prefill_then_decode_logits_and_caches_match_jax(pair):
    """Prefill 12 tokens, then three decode steps at per-row positions;
    the attention k/v and the Mamba conv tails and states per kind."""
    jm, params, japply, tm = pair
    b, s, cache_len = 2, 12, 32
    tok = _tokens(tm.cfg, b, s + 3, 1)
    jcache, tcache = jm.init_cache(b, cache_len), tm.init_cache(b, cache_len)
    jl, jcache = japply["prefill"](params, tokens=jnp.asarray(tok[:, :s]),
                                   cache=jcache, pos=0)
    tl, tcache = tm.apply(torch.from_numpy(tok[:, :s]), mode="prefill",
                          cache=tcache, pos=0)
    _close(tl, jl)
    for i in range(3):
        pos = np.full(b, s + i, np.int32)
        step = tok[:, s + i:s + i + 1]
        jl, jcache = japply["decode"](params, tokens=jnp.asarray(step),
                                      cache=jcache, pos=jnp.asarray(pos))
        tl, tcache = tm.apply(torch.from_numpy(step), mode="decode",
                              cache=tcache, pos=torch.from_numpy(pos))
        _close(tl, jl)
    for name, t in tcache.items():
        _close(t, _per_kind(tm.cfg, jcache, name))


def test_convert_maps_block_slots_to_layers():
    """At 16 layers (two blocks) ``blocks.l<i>.<name>[b]`` is port layer
    8 b + i; the tree is the JAX table's shapes filled with distinct
    numbers (nothing initialized)."""
    cfg = dataclasses.replace(configs.reduced(ARCH), num_layers=16)
    jm = jbuild(dataclasses.replace(jconfigs.reduced(ARCH), num_layers=16))
    counter = iter(range(10**6))
    tree = jax.tree.map(
        lambda s: np.full(s.shape, next(counter), np.float32), jm.abstract())
    tm = build(cfg, device="meta")
    sd = convert.model_params_from_reference(cfg, tree)
    assert set(sd) == set(tm.state_dict())
    assert tm.num_params() == jm.num_params()
    blocks = tree["blocks"]
    for b in range(2):
        for i, name in ((4, "attn.wq"), (1, "mamba.a_log"),
                        (3, "moe.w_up"), (6, "mlp.w_down")):
            want = blocks[f"l{i}"]
            for part in name.split("."):
                want = want[part]
            np.testing.assert_array_equal(
                sd[f"layers.{8 * b + i}.{name}"].numpy(), want[b])
    with pytest.raises(ValueError, match="period"):
        build(dataclasses.replace(cfg, num_layers=12), device="meta")


def _serve(engine, requests, admit, tick):
    pending = list(requests)
    for _ in range(1000):
        while pending and admit(engine, pending[0]):
            pending.pop(0)
        if not pending and engine.active_slots == 0:
            return
        tick(engine)
    raise AssertionError("engine did not drain")


def test_greedy_tokens_equal_jax_engine(pair):
    """Five requests of two prompt lengths (the JAX engine compiles a
    prefill per length) and ragged budgets through three slots, two
    admitted into reused slots: the Mamba states are overwritten whole by
    each prefill, the attention caches masked by the fill levels."""
    jm, params, _, tm = pair
    rng = np.random.default_rng(7)
    specs = [(rng.integers(0, tm.cfg.vocab_size, n).astype(np.int32), m)
             for n, m in ((5, 4), (11, 3), (5, 6), (11, 2), (5, 5))]
    jreqs = [JRequest(i, p, m) for i, (p, m) in enumerate(specs)]
    treqs = [Request(i, p, m) for i, (p, m) in enumerate(specs)]
    _serve(JServeEngine(jm, num_slots=3, cache_len=48), jreqs,
           lambda e, r: e.try_admit(params, r), lambda e: e.tick(params))
    _serve(ServeEngine(tm, num_slots=3, cache_len=48), treqs,
           lambda e, r: e.try_admit(r), lambda e: e.tick())
    for j, t in zip(jreqs, treqs):
        assert t.done and j.done
        assert t.generated == j.generated, t.rid


@pytest.mark.parametrize("arch,missing", [("qwen2-vl-7b", "embeds"),
                                          ("whisper-small", "enc_frames")])
def test_engine_refuses_models_it_cannot_prefill(arch, missing):
    """The JAX engine feeds tokens only, so the port's refuses a model that
    prefills on embeddings or encoder frames."""
    tm = build(configs.reduced(arch), device="cpu")
    with pytest.raises(ValueError, match=missing):
        ServeEngine(tm, num_slots=2, cache_len=16)
