"""The PyTorch port's MoE layer against the JAX package's.

Both run on the same parameters (the JAX layer's float32 leaves loaded into
the port's ``MoE``) and the same inputs (numpy seeds), float32, with full
float32 matmuls.  Tolerances:
- outputs within 1e-5 of the largest output magnitude: the same float32
  routing, products and sums, taken in other orders;
- the load-balancing loss within 1e-6 (a mean of float32 products);
- which (token, k) assignments are dropped at capacity factor 1.0: the
  same set, exactly (both sort the flat expert ids stably).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.models import ffn as jffn  # noqa: E402
from repro.models.params import init_params  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import ffn  # noqa: E402

ARCHS = ["deepseek-v2-lite-16b", "granite-moe-1b-a400m"]


@pytest.fixture(scope="module", autouse=True)
def _full_f32_matmuls():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_float32_matmul_precision(prev)


def _pair(arch, **upd):
    cfg = dataclasses.replace(configs.reduced(arch), dtype="float32", **upd)
    jcfg = dataclasses.replace(jconfigs.reduced(arch), dtype="float32", **upd)
    p = init_params(jffn.moe_specs(jcfg), jax.random.PRNGKey(1), jnp.float32)
    layer = ffn.MoE(cfg, dtype=torch.float32, device="cpu")
    flat = {}
    for k, v in p.items():
        if isinstance(v, dict):
            flat.update({f"{k}.{k2}": v2 for k2, v2 in v.items()})
        else:
            flat[k] = v
    layer.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in flat.items()})
    return cfg, jcfg, p, layer


def _x(cfg, b, s, seed):
    return np.random.default_rng(seed).normal(
        size=(b, s, cfg.d_model)).astype(np.float32)


def _within(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


def _jax_dropped(p, x, jcfg):
    """The reference's dropped (token * k + j) assignments: the steps of
    ``repro.models.ffn.moe`` up to ``valid``."""
    xf = jnp.asarray(x).reshape(-1, x.shape[-1])
    n, k, e = xf.shape[0], jcfg.top_k, jcfg.num_experts
    cap = jffn._capacity(n, jcfg)
    probs = jax.nn.softmax(xf @ p["router"], -1)
    _, top_i = jax.lax.top_k(probs, k)
    flat_e = top_i.reshape(-1)
    order = jnp.argsort(flat_e)
    sorted_e = flat_e[order]
    seg_start = jnp.searchsorted(sorted_e, jnp.arange(e))
    rank = jnp.arange(n * k) - seg_start[sorted_e]
    return set(np.asarray(order)[np.asarray(rank >= cap)].tolist())


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_dropless_matches_jax(arch):
    """The reduced configs' capacity factor E/k: no assignment drops."""
    cfg, jcfg, p, layer = _pair(arch)
    x = _x(cfg, 2, 24, 0)
    with torch.no_grad():
        got = layer(torch.from_numpy(x)).numpy()
        _, _, _, valid, _ = layer.dispatch(torch.from_numpy(x).view(
            -1, cfg.d_model))
    assert bool(valid.all())
    _within(got, jffn.moe(p, jnp.asarray(x), jcfg), 1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_drops_the_same_assignments_as_jax(arch):
    """Capacity factor 1.0 on 2 x 64 tokens: assignments past an
    expert's capacity drop; the port drops the reference's set and its
    outputs match."""
    cfg, jcfg, p, layer = _pair(arch, moe_capacity_factor=1.0)
    x = _x(cfg, 2, 64, 1)
    with torch.no_grad():
        got = layer(torch.from_numpy(x)).numpy()
        _, order, _, valid, cap = layer.dispatch(
            torch.from_numpy(x).view(-1, cfg.d_model))
    dropped = set(order[~valid].tolist())
    assert cap == jffn._capacity(128, jcfg) == 64
    assert dropped and dropped == _jax_dropped(p, x, jcfg)
    _within(got, jffn.moe(p, jnp.asarray(x), jcfg), 1e-5)


@pytest.mark.parametrize("n", [1, 8, 2048])
@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_equals_reference(arch, n):
    """The full published configs: deepseek's decode tick (8 slots) gets
    the floor of 8, a 2048-token prefill 240."""
    cap = ffn._capacity(n, configs.get(arch))
    assert cap == jffn._capacity(n, jconfigs.get(arch))
    if arch == "deepseek-v2-lite-16b":
        assert cap == {1: 8, 8: 8, 2048: 240}[n]


@pytest.mark.parametrize("arch", ARCHS)
def test_aux_loss_matches_jax(arch):
    cfg, jcfg, p, layer = _pair(arch)
    x = _x(cfg, 3, 20, 2)
    with torch.no_grad():
        got = ffn.moe_aux_loss(layer, torch.from_numpy(x), cfg)
    want = jffn.moe_aux_loss(p, jnp.asarray(x), jcfg)
    assert abs(float(got) - float(want)) <= 1e-6


def test_shared_experts_only_where_configured():
    _, _, p, layer = _pair("deepseek-v2-lite-16b")
    assert "shared" in p and layer.shared.w_gate.shape == (128, 2 * 64)
    _, _, p, layer = _pair("granite-moe-1b-a400m")
    assert "shared" not in p and not hasattr(layer, "shared")
    assert layer.router.dtype == torch.float32
