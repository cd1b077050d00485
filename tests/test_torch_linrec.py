"""The PyTorch port's RWKV6 recurrence against the JAX package's.

On the CPU the port's ``ops`` runs the chunked plain version (chunks of
32); the JAX side runs its Pallas kernel in interpret mode and its
step-by-step oracle.  ``rwkv6_chunk_parallel_ref`` is the algebra in the
CUDA kernels' order (per-chunk terms, then the state scan, then the
inter-chunk term).  The tolerance is the reference's own, 2e-3
(``tests/test_kernels.py``): float32 sums over a chunk taken in another
order, and decays applied in log space.

Decays span the model's whole range, logw = -exp(U(-20, 10)) (the model
clamps its raw decay to [-20, 10]).  The JAX functions take w, which they
clip to 1e-30 before the log, so against them the port's plain versions
get the same clipped log-decays.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.linrec.ops import rwkv6_linear_attention as jlin  # noqa: E402
from repro.kernels.linrec.ops import rwkv6_oracle as joracle  # noqa: E402
from repro_torch.kernels.linrec import linrec as tker  # noqa: E402
from repro_torch.kernels.linrec import ops as tops  # noqa: E402
from repro_torch.kernels.linrec.ref import (  # noqa: E402
    rwkv6_chunk_parallel_ref,
    rwkv6_chunked_ref,
    rwkv6_ref,
)

TOL = dict(atol=2e-3, rtol=2e-3)


@pytest.fixture(scope="module", autouse=True)
def _full_f32_matmuls():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_float32_matmul_precision(prev)


def _inputs(seed, b, h, t, d, w_lo=0.2):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(b, h, t, d)).astype(np.float32)
               for _ in range(3))
    w = rng.uniform(w_lo, 1.0, (b, h, t, d)).astype(np.float32)
    u = rng.normal(size=(h, d)).astype(np.float32)
    return r, k, v, w, u


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


@pytest.mark.parametrize("b,h,t,d,chunk", [
    (1, 2, 32, 16, 32),    # single chunk
    (2, 3, 70, 16, 16),    # ragged
    (1, 4, 128, 64, 32),   # rwkv6 head_size
    (2, 2, 33, 32, 32),    # T = chunk + 1
])
def test_shapes_match_jax(b, h, t, d, chunk):
    r, k, v, w, u = _inputs(b * 100 + t, b, h, t, d)
    y, s = tops.rwkv6_linear_attention(*_t(r, k, v, w, u))
    jy, js = jlin(*(jnp.asarray(x) for x in (r, k, v, w, u)), chunk=chunk)
    oy, os_ = joracle(*(jnp.asarray(x) for x in (r, k, v, w, u)))
    for want_y, want_s in ((jy, js), (oy, os_)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **TOL)
        np.testing.assert_allclose(s.numpy(), np.asarray(want_s), **TOL)


def test_strong_decay_stability():
    """Decays near 0 (logw very negative) must not overflow or give NaN:
    the case that breaks the factored r~/k~ form."""
    r, k, v, _, u = _inputs(1, 1, 2, 64, 16)
    w = np.full(r.shape, 1e-6, np.float32)
    y, s = tops.rwkv6_linear_attention(*_t(r, k, v, w, u))
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    oy, os_ = joracle(*(jnp.asarray(x) for x in (r, k, v, w, u)))
    np.testing.assert_allclose(y.numpy(), np.asarray(oy), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(os_), **TOL)


def test_step_consistency():
    """T sequential decode steps == one chunked call."""
    r, k, v, w, u = _t(*_inputs(3, 1, 2, 17, 16, w_lo=0.3))
    y_full, s_full = tops.rwkv6_linear_attention(r, k, v, w, u)
    s = torch.zeros(1, 2, 16, 16)
    ys = []
    for i in range(17):
        y_i, s = tops.rwkv6_step(r[:, :, i], k[:, :, i], v[:, :, i],
                                 w[:, :, i], u, s)
        ys.append(y_i)
    torch.testing.assert_close(torch.stack(ys, 2), y_full, **TOL)
    torch.testing.assert_close(s, s_full, **TOL)


def test_state_carry_across_calls():
    """Splitting a sequence across two calls == one call."""
    r, k, v, w, u = _t(*_inputs(4, 2, 2, 64, 16, w_lo=0.3))
    y_full, s_full = tops.rwkv6_linear_attention(r, k, v, w, u)
    y1, s1 = tops.rwkv6_linear_attention(
        r[:, :, :32], k[:, :, :32], v[:, :, :32], w[:, :, :32], u)
    y2, s2 = tops.rwkv6_linear_attention(
        r[:, :, 32:], k[:, :, 32:], v[:, :, 32:], w[:, :, 32:], u, s1)
    torch.testing.assert_close(torch.cat([y1, y2], 2), y_full, **TOL)
    torch.testing.assert_close(s2, s_full, **TOL)


def test_state_carry_from_jax_state():
    """A nonzero initial state, as a decode-then-prefill would give."""
    r, k, v, w, u = _inputs(5, 1, 3, 45, 32)
    s0 = np.random.default_rng(6).normal(size=(1, 3, 32, 32)).astype(
        np.float32)
    y, s = tops.rwkv6_linear_attention(*_t(r, k, v, w, u, s0))
    jy, js = jlin(*(jnp.asarray(x) for x in (r, k, v, w, u)),
                  state=jnp.asarray(s0))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), **TOL)


def test_logw_entry_and_bthd_layout():
    """The model's entry (log-decays, (B, T, H, d) layout) equals the
    reference signature's on the same decays."""
    r, k, v, w, u = _t(*_inputs(7, 2, 2, 50, 32))
    y, s = tops.rwkv6_linear_attention(r, k, v, w, u)
    yl, sl = tops.rwkv6_linear_attention_logw(
        *(x.transpose(1, 2) for x in (r, k, v, w.log())), u, layout="bthd")
    assert yl.shape == (2, 50, 2, 32) and yl.is_contiguous()
    torch.testing.assert_close(yl.transpose(1, 2), y, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(sl, s, atol=1e-6, rtol=1e-6)


def test_kernel_wrapper_takes_cuda_tensors_only():
    r, k, v, w, u = _t(*_inputs(8, 1, 1, 8, 16))
    before = tker.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        tker.rwkv6_cuda(r, k, v, w.log(), u, torch.zeros(1, 1, 16, 16))
    with pytest.raises(ValueError, match="layout"):
        tops.rwkv6_linear_attention_logw(r, k, v, w.log(), u, layout="tbhd")
    assert tker.LAUNCHES == before


def test_chunked_plain_equals_step_plain():
    """The port's two plain versions: chunked (what the kernel computes)
    and step by step (the oracle), on a ragged length with a state."""
    r, k, v, w, u = _t(*_inputs(9, 2, 3, 77, 32))
    s0 = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(0))
    y, s = tops.rwkv6_linear_attention(r, k, v, w, u, s0)
    want_y, want_s = rwkv6_ref(r, k, v, w, u, s0)
    torch.testing.assert_close(y, want_y, **TOL)
    torch.testing.assert_close(s, want_s, **TOL)


def _model_range(seed, b, h, t, d, lo=-20.0, hi=10.0):
    """r, k, v, u normal, a nonzero state, logw = -exp(U(lo, hi)): at the
    model's range half the decays are below e^-1 and some reach -e^10."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(b, h, t, d)).astype(np.float32)
               for _ in range(3))
    logw = (-np.exp(rng.uniform(lo, hi, (b, h, t, d)))).astype(np.float32)
    u = rng.normal(size=(h, d)).astype(np.float32)
    s0 = rng.normal(size=(b, h, d, d)).astype(np.float32)
    return r, k, v, logw, u, s0


@pytest.mark.parametrize("b,h,t,d", [
    (1, 2, 33, 32),       # T = chunk + 1
    (2, 3, 70, 16),       # ragged, B = 2
    (2, 2, 1000, 64),     # 32 chunks, the last ragged
])
def test_chunk_parallel_matches_step_ref_and_jax(b, h, t, d):
    """The chunk-parallel plain version at the model's decay range, B = 2
    with a carried state: against the port's step loop on the same
    decays, and against the JAX package's Pallas kernel (interpret mode)
    and oracle on its clipped decays."""
    r, k, v, logw, u, s0 = _model_range(t + d, b, h, t, d)
    ty = _t(r, k, v, logw, u, s0)
    y, s, entering = rwkv6_chunk_parallel_ref(*ty)
    assert entering.shape == (b, h, -(-t // 32), d, d)
    torch.testing.assert_close(entering[:, :, 0], ty[5], atol=0, rtol=0)
    want_y, want_s = rwkv6_ref(*ty[:3], ty[3].exp(), *ty[4:])
    torch.testing.assert_close(y, want_y, **TOL)
    torch.testing.assert_close(s, want_s, **TOL)

    w = np.exp(logw)
    jargs = [jnp.asarray(x) for x in (r, k, v, w, u)]
    jy, js = jlin(*jargs, state=jnp.asarray(s0))
    oy, os_ = joracle(*jargs, state=jnp.asarray(s0))
    clipped = torch.from_numpy(w).clamp(1e-30, 1.0).log()
    y, s, _ = rwkv6_chunk_parallel_ref(*ty[:3], clipped, *ty[4:])
    for want_y, want_s in ((jy, js), (oy, os_)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **TOL)
        np.testing.assert_allclose(s.numpy(), np.asarray(want_s), **TOL)


@pytest.mark.parametrize("t", [33, 70, 1000])
def test_chunked_plain_at_model_decay_range(t):
    """The CPU path (``ops``, the chunked plain version) at the model's
    decay range equals the step loop and the chunk-parallel order.  Taking
    each stretch's decay as a difference of prefix sums from the chunk's
    start (as the JAX package does) errs up to 0.15 here: those sums reach
    ~1e4, where a float32 ulp is ~1e-3."""
    ty = _t(*_model_range(t, 2, 3, t, 64))
    y, s = tops.rwkv6_linear_attention_logw(*ty)
    want_y, want_s = rwkv6_ref(*ty[:3], ty[3].exp(), *ty[4:])
    torch.testing.assert_close(y, want_y, **TOL)
    torch.testing.assert_close(s, want_s, **TOL)
    py, ps, _ = rwkv6_chunk_parallel_ref(*ty)
    torch.testing.assert_close(y, py, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(s, ps, atol=1e-5, rtol=1e-5)


def test_zero_decay_chunk_zeroes_the_carried_state():
    """A whole chunk at logw = -e^10: its total decay exp(sum logw) is
    exactly 0, so the scan must drop everything carried into it; the
    output stays finite and the states after it do not depend on s0."""
    r, k, v, logw, u, s0 = _t(*_model_range(11, 2, 3, 130, 64))
    logw[:, :, 32:64] = -float(np.exp(10.0))
    y, s, entering = rwkv6_chunk_parallel_ref(r, k, v, logw, u, s0)
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    y2, s2, entering2 = rwkv6_chunk_parallel_ref(r, k, v, logw, u, 5 * s0)
    torch.testing.assert_close(entering2[:, :, 2:], entering[:, :, 2:],
                               atol=0, rtol=0)
    torch.testing.assert_close(y2[:, :, 64:], y[:, :, 64:], atol=0, rtol=0)
    torch.testing.assert_close(s2, s, atol=0, rtol=0)
    want_y, want_s = rwkv6_ref(r, k, v, logw.exp(), u, s0)
    torch.testing.assert_close(y, want_y, **TOL)
    torch.testing.assert_close(s, want_s, **TOL)
    cy, cs_ = rwkv6_chunked_ref(r, k, v, logw, u, s0)
    torch.testing.assert_close(y, cy, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(s, cs_, atol=1e-5, rtol=1e-5)



# ------------------------------------------------------- the trainable op
#
# rwkv6_trainable's gradients against jax.vjp of the JAX package's step
# oracle (rwkv6_ref, a lax.scan) at the same decays (w = exp(logw)), with
# a carried state: the reference's 2e-3, scaled to each gradient's
# largest element.

from jax import vjp as jvjp  # noqa: E402

from repro.kernels.linrec.ref import rwkv6_ref as jrwkv6_ref  # noqa: E402


def _grad_close(got, want, tol=2e-3):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=tol,
                               atol=tol * np.abs(want).max())


@pytest.mark.parametrize("b,h,t,d", [
    (1, 2, 20, 16),    # shorter than a chunk
    (2, 3, 45, 16),    # ragged, B = 2
    (1, 2, 70, 32),    # three chunks, the last ragged
])
def test_trainable_grads_match_jax_vjp(b, h, t, d):
    r, k, v, logw, u, s0 = _model_range(t * 3 + d, b, h, t, d, lo=-3.0,
                                        hi=1.0)
    rng = np.random.default_rng(t)
    gy = rng.normal(size=(b, h, t, d)).astype(np.float32)
    gs = rng.normal(size=(b, h, d, d)).astype(np.float32)

    def jf(r, k, v, logw, u, s0):
        return jrwkv6_ref(r, k, v, jnp.exp(logw), u, s0)

    (jy, js), pullback = jvjp(jf, *(jnp.asarray(x) for x in
                                    (r, k, v, logw, u, s0)))
    jgrads = pullback((jnp.asarray(gy), jnp.asarray(gs)))
    targs = [torch.from_numpy(x).requires_grad_()
             for x in (r, k, v, logw, u, s0)]
    y, s = tops.rwkv6_trainable(*targs)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(s.detach().numpy(), np.asarray(js), **TOL)
    grads = torch.autograd.grad((y, s), targs,
                                (torch.from_numpy(gy), torch.from_numpy(gs)))
    for name, got, want in zip(("r", "k", "v", "logw", "u", "state"), grads,
                               jgrads):
        assert got.shape == want.shape, name
        _grad_close(got, want)


def test_trainable_bthd_without_state_equals_bhtd():
    r, k, v, logw, u, _ = _t(*_model_range(4, 2, 3, 40, 16, lo=-3.0,
                                           hi=1.0))
    g = torch.randn(2, 3, 40, 16, generator=torch.Generator().manual_seed(0))
    ins = [x.clone().requires_grad_() for x in (r, k, v, logw, u)]
    y, _ = tops.rwkv6_trainable(*ins)
    want = torch.autograd.grad(y, ins, g)
    lay = [x.transpose(1, 2).contiguous().requires_grad_()
           for x in (r, k, v, logw)] + [u.clone().requires_grad_()]
    y2, _ = tops.rwkv6_trainable(*lay, layout="bthd")
    torch.testing.assert_close(y2.transpose(1, 2), y.detach())
    got = torch.autograd.grad(y2, lay, g.transpose(1, 2))
    for a, b in zip(got[:4], want[:4]):
        torch.testing.assert_close(a.transpose(1, 2), b, atol=1e-6,
                                   rtol=1e-5)
    torch.testing.assert_close(got[4], want[4], atol=1e-6, rtol=1e-5)


def test_model_train_mode_calls_the_trainable_op(monkeypatch):
    """mode="train" goes through rwkv6_trainable; prefill keeps the raw
    op; every parameter gets a finite gradient at T = 64 (two chunks)."""
    from repro_torch import configs
    from repro_torch.models import rwkv
    from repro_torch.models.model import build

    tm = build(configs.reduced("rwkv6-3b"), device="cpu")
    tm.init(torch.Generator().manual_seed(0))
    calls = {"trainable": 0, "raw": 0}
    real_t, real_r = rwkv.rwkv6_trainable, rwkv.rwkv6_linear_attention_logw

    def trainable(*a, **kw):
        calls["trainable"] += 1
        return real_t(*a, **kw)

    def raw(*a, **kw):
        calls["raw"] += 1
        return real_r(*a, **kw)

    monkeypatch.setattr(rwkv, "rwkv6_trainable", trainable)
    monkeypatch.setattr(rwkv, "rwkv6_linear_attention_logw", raw)
    tok = torch.randint(0, 512, (2, 64), generator=torch.Generator())
    tm(tok, remat=False).float().logsumexp(-1).mean().backward()
    assert calls == {"trainable": tm.cfg.num_layers, "raw": 0}
    assert all(torch.isfinite(p.grad).all() for p in tm.parameters())
    tm.apply(tok, mode="prefill", cache=tm.init_cache(2, 64), pos=0)
    assert calls["raw"] == tm.cfg.num_layers
