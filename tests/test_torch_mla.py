"""The PyTorch port's MLA attention against the JAX package's
``mla_attention``, with and without q-LoRA (the reduced deepseek-v2-lite
and minicpm3), in its three modes.

The JAX layer's float32 parameters are loaded into the port's
``MLAAttention``; inputs, caches and fill levels come from numpy seeds.
Outputs and written caches within 1e-4 (atol and rtol), float32 with full
float32 matmuls: the same products and softmax summed in other orders.
Decode is the absorbed form in both packages, at per-slot fill levels.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models.params import init_params  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import attention  # noqa: E402

ARCHS = ["deepseek-v2-lite-16b", "minicpm3-4b"]
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def _full_f32_matmuls():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_float32_matmul_precision(prev)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    arch = request.param
    cfg = dataclasses.replace(configs.reduced(arch), dtype="float32")
    jcfg = dataclasses.replace(jconfigs.reduced(arch), dtype="float32")
    p = init_params(jattn.mla_specs(jcfg), jax.random.PRNGKey(2), jnp.float32)
    layer = attention.MLAAttention(cfg, dtype=torch.float32, device="cpu")
    layer.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in p.items()})
    return cfg, jcfg, p, layer


def _x(cfg, b, s, seed):
    return np.random.default_rng(seed).normal(
        size=(b, s, cfg.d_model)).astype(np.float32)


def _positions(pos, b, s):
    return (np.asarray(pos, np.int32).reshape(-1, 1)
            + np.arange(s, dtype=np.int32)[None, :]) * np.ones((b, 1),
                                                               np.int32)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _run_port(layer, x, mode, cache, pos):
    b, s, _ = x.shape
    positions = torch.from_numpy(_positions(pos, b, s)).long()
    tpos = torch.from_numpy(pos) if isinstance(pos, np.ndarray) else pos
    with torch.no_grad():
        return layer(torch.from_numpy(x), mode=mode, cache=cache, pos=tpos,
                     positions=positions)


def _run_jax(p, jcfg, x, mode, cache, pos):
    b, s, _ = x.shape
    return jattn.mla_attention(
        p, jnp.asarray(x), jcfg, mode=mode, cache=cache, pos=pos,
        positions=jnp.asarray(_positions(pos, b, s)))


def _caches(cfg, b, t, seed=None):
    """(port cache, JAX cache): zeros, or normal draws from ``seed``."""
    shapes = {"c_kv": (b, t, cfg.kv_lora_rank),
              "k_rope": (b, t, cfg.qk_rope_dim)}
    rng = np.random.default_rng(seed)
    arrs = {k: (np.zeros(s, np.float32) if seed is None
                else rng.normal(size=s).astype(np.float32))
            for k, s in shapes.items()}
    return ({k: torch.from_numpy(a.copy()) for k, a in arrs.items()},
            {k: jnp.asarray(a) for k, a in arrs.items()})


def test_cache_specs_are_the_latent_and_rope_key(pair):
    cfg, jcfg, _, _ = pair
    got = {k: s.shape for k, s in attention.cache_specs(cfg, 3, 16).items()}
    want = {k: s.shape for k, s in jattn.cache_specs(jcfg, 3, 16).items()}
    assert got == want == {"c_kv": (3, 16, cfg.kv_lora_rank),
                           "k_rope": (3, 16, cfg.qk_rope_dim)}


def test_train_mode_matches_jax(pair):
    cfg, jcfg, p, layer = pair
    x = _x(cfg, 2, 17, 0)
    got = _run_port(layer, x, "train", None, 0)
    want, _ = _run_jax(p, jcfg, x, "train", None, 0)
    _close(got, want)


def test_prefill_matches_jax_and_writes_the_cache(pair):
    cfg, jcfg, p, layer = pair
    x = _x(cfg, 2, 12, 1)
    tcache, jcache = _caches(cfg, 2, 32)
    got = _run_port(layer, x, "prefill", tcache, 0)
    want, jcache = _run_jax(p, jcfg, x, "prefill", jcache, 0)
    _close(got, want)
    for name in ("c_kv", "k_rope"):
        _close(tcache[name], jcache[name])
        assert tcache[name][:, :12].abs().sum() > 0
        assert not tcache[name][:, 12:].any()


@pytest.mark.parametrize("steps", [1, 2])
def test_decode_at_per_slot_fill_levels_matches_jax(pair, steps):
    """A filled cache (normal draws, so stale entries past each slot's
    fill level would show if unmasked), fill levels (3, 17, 30), one or
    two new tokens per slot through the absorbed form."""
    cfg, jcfg, p, layer = pair
    tcache, jcache = _caches(cfg, 3, 32, seed=3)
    pos = np.array([3, 17, 30], np.int32)
    x = _x(cfg, 3, steps, 4)
    got = _run_port(layer, x, "decode", tcache, pos)
    want, jcache = _run_jax(p, jcfg, x, "decode", jcache, jnp.asarray(pos))
    _close(got, want)
    for name in ("c_kv", "k_rope"):
        _close(tcache[name], jcache[name])


def test_decode_continues_a_prefill_like_train_mode(pair):
    """Prefill 9 tokens, decode the 10th at a scalar position: the same
    output as train mode's last row (the absorbed form is exact)."""
    cfg, _, _, layer = pair
    x = _x(cfg, 2, 10, 5)
    tcache, _ = _caches(cfg, 2, 16)
    full = _run_port(layer, x, "train", None, 0)
    _run_port(layer, x[:, :9], "prefill", tcache, 0)
    step = _run_port(layer, x[:, 9:], "decode", tcache, 9)
    torch.testing.assert_close(step[:, 0], full[:, 9], **TOL)


def test_q_lora_only_where_configured(pair):
    cfg, _, p, layer = pair
    assert ("wq_a" in p) == bool(cfg.q_lora_rank) == hasattr(layer, "wq_b")
    assert ("wq" in p) != bool(cfg.q_lora_rank)
