"""The PyTorch port's RWKV6 recurrence against the JAX package's.

On the CPU the port's ``ops`` runs the chunked plain version (chunks of
32, the kernel's algorithm); the JAX side runs its Pallas kernel in
interpret mode and its step-by-step oracle.  The tolerance is the
reference's own, 2e-3 (``tests/test_kernels.py``): float32 sums over a
chunk taken in another order, and decays applied in log space.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.linrec.ops import rwkv6_linear_attention as jlin  # noqa: E402
from repro.kernels.linrec.ops import rwkv6_oracle as joracle  # noqa: E402
from repro_torch.kernels.linrec import linrec as tker  # noqa: E402
from repro_torch.kernels.linrec import ops as tops  # noqa: E402
from repro_torch.kernels.linrec.ref import rwkv6_ref  # noqa: E402

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
