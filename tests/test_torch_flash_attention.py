"""The PyTorch port's flash attention against the JAX package's.

On the CPU the port's ``ops`` runs the plain PyTorch version; the JAX side
runs its Pallas kernel in interpret mode and its jnp oracle.  Tolerances
are the reference's own (``tests/test_kernels.py``): atol 2e-5 / rtol 1e-4
in float32, 2e-2 in bfloat16 — the same softmax with its sums taken in
another order.  The per-slot decode is held to the JAX model's ``_sdpa``
with vector offsets, which is the function the engine's batched decode
computes; ``_sdpa`` rounds its probabilities to the value dtype before the
PV product, which in float32 changes nothing.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ops import flash_attention as jflash  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as jref  # noqa: E402
from repro.models.attention import _sdpa  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as tker  # noqa: E402
from repro_torch.kernels.flash_attention import ops as tops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_ref,
    attention_split_ref,
)

F32 = dict(atol=2e-5, rtol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def _full_f32_matmuls():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_float32_matmul_precision(prev)


def _randn(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _qkv(seed, b, hq, hkv, sq, skv, d):
    rng = np.random.default_rng(seed)
    return (_randn(rng, b, hq, sq, d), _randn(rng, b, hkv, skv, d),
            _randn(rng, b, hkv, skv, d))


def _port(q, k, v, **kw):
    return tops.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                **kw).numpy()


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d", [
    (1, 4, 4, 128, 128, 64),    # MHA, exact blocks
    (2, 8, 2, 200, 200, 64),    # GQA 4:1, ragged seq
    (1, 8, 1, 64, 64, 128),     # MQA
    (2, 4, 2, 1, 300, 64),      # decode: single query
    (1, 2, 2, 96, 160, 32),     # cross-ish lengths
])
def test_shapes_match_jax(b, hq, hkv, sq, skv, d):
    q, k, v = _qkv(b * 1000 + sq, b, hq, hkv, sq, skv, d)
    got = _port(q, k, v, causal=True)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    np.testing.assert_allclose(got, jflash(jq, jk, jv, causal=True), **F32)
    np.testing.assert_allclose(got, jref(jq, jk, jv, causal=True), **F32)


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,kv_len", [
    (1, 4, 1, 65, 65, 64, True, None),       # one row and key past a tile
    (2, 8, 2, 127, 127, 32, True, None),     # one short of two tiles
    (1, 8, 2, 200, 200, 128, True, None),    # 3 tiles + 8 rows/keys
    (1, 4, 1, 127, 200, 64, True, 190),      # kv_len below Skv, mid-tile
    (1, 8, 2, 65, 127, 128, True, 100),
    (2, 4, 1, 200, 256, 32, True, 230),
    (1, 4, 1, 65, 200, 64, False, 127),      # non-causal, kv_len < Skv
])
def test_simt_tile_seams_match_jax(b, hq, hkv, sq, skv, d, causal, kv_len):
    """f32 prefill, the simt route, at its tiles' seams (64 query rows, 64
    keys): Sq and Skv not multiples of 64, kv_len below Skv, GQA group 4,
    head dims 32, 64 and 128; against the JAX Pallas kernel (interpret
    mode) and its reference."""
    assert tker.route(torch.float32, d, sq) == "simt"
    q, k, v = _qkv(sq * 7 + skv + d, b, hq, hkv, sq, skv, d)
    got = _port(q, k, v, causal=causal, kv_len=kv_len)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    np.testing.assert_allclose(
        got, jflash(jq, jk, jv, causal=causal, kv_len=kv_len), **F32)
    np.testing.assert_allclose(
        got, jref(jq, jk, jv, causal=causal, kv_len=kv_len), **F32)


def test_noncausal_matches_jax():
    q, k, v = _qkv(1, 2, 4, 2, 100, 150, 64)
    got = _port(q, k, v, causal=False)
    want = jflash(*(jnp.asarray(x) for x in (q, k, v)), causal=False)
    np.testing.assert_allclose(got, want, **F32)


def test_kv_len_padded_cache():
    """Decode against a partially filled, padded KV cache."""
    q, k, v = _qkv(2, 2, 8, 2, 1, 384, 64)
    got = _port(q, k, v, causal=True, kv_len=257)
    want = jref(*(jnp.asarray(x) for x in (q, k[:, :, :257], v[:, :, :257])),
                causal=True)
    np.testing.assert_allclose(got, want, **F32)


@pytest.mark.parametrize("dtype,atol", [("float32", 2e-5), ("bfloat16", 2e-2)])
def test_dtypes_match_jax(dtype, atol):
    q, k, v = _qkv(3, 1, 4, 2, 128, 128, 64)
    jq, jk, jv = (jnp.asarray(x, dtype=dtype) for x in (q, k, v))
    tq, tk, tv = (torch.from_numpy(np.array(x, np.float32)).to(
        getattr(torch, dtype)) for x in (jq, jk, jv))
    got = tops.flash_attention(tq, tk, tv, causal=True)
    assert got.dtype == getattr(torch, dtype)
    want = jflash(jq, jk, jv, causal=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=1e-2)


def test_causality_property():
    """Perturbing future tokens must not change past outputs."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(4, 1, 2, 2, 64, 64, 32))
    out1 = tops.flash_attention(q, k, v, causal=True)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, 50:] += 10.0
    v2[:, :, 50:] += 10.0
    out2 = tops.flash_attention(q, k2, v2, causal=True)
    torch.testing.assert_close(out1[:, :, :50], out2[:, :, :50], atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("sq", [1, 3])
def test_per_slot_kv_len_decode_matches_sdpa(sq):
    """One call, every batch row with its own fill level, the model's
    (B, S, H, D) layout: the JAX model's _sdpa with vector q_offset/kv_len."""
    rng = np.random.default_rng(5)
    b, hq, hkv, s_cache, d = 5, 8, 2, 96, 32
    fill = np.array([1, 17, 40, 95, 96 - sq], np.int32)   # positions held
    q = _randn(rng, b, sq, hq, d)
    k = _randn(rng, b, s_cache, hkv, d)
    v = _randn(rng, b, s_cache, hkv, d)
    kv_len = fill + sq
    got = tops.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=True, kv_len=torch.from_numpy(kv_len), scale=d ** -0.5,
        layout="bshd").numpy()
    want = _sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                 q_offset=jnp.asarray(fill), kv_len=jnp.asarray(kv_len),
                 scale=d ** -0.5)
    np.testing.assert_allclose(got, np.asarray(want), **F32)


def test_bshd_layout_equals_bhsd():
    q, k, v = (torch.from_numpy(x) for x in _qkv(6, 2, 4, 2, 33, 70, 64))
    lens = torch.tensor([70, 45])
    bhsd = tops.flash_attention(q, k, v, kv_len=lens)
    bshd = tops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), kv_len=lens,
                                layout="bshd")
    assert bshd.shape == (2, 33, 4, 64) and bshd.is_contiguous()
    torch.testing.assert_close(bshd.transpose(1, 2), bhsd, atol=0, rtol=0)


def test_vector_kv_len_equals_per_row_scalars():
    q, k, v = (torch.from_numpy(x) for x in _qkv(7, 3, 4, 4, 5, 64, 32))
    lens = [64, 9, 30]
    out = attention_ref(q, k, v, causal=True, kv_len=torch.tensor(lens))
    for i, n in enumerate(lens):
        one = attention_ref(q[i:i + 1], k[i:i + 1, :, :n], v[i:i + 1, :, :n],
                            causal=True)
        torch.testing.assert_close(out[i:i + 1], one, atol=1e-6, rtol=1e-6)


def test_kernel_wrapper_takes_cuda_tensors_only():
    q, k, v = (torch.from_numpy(x) for x in _qkv(8, 1, 2, 2, 4, 8, 32))
    lens = torch.tensor([8], dtype=torch.int32)
    before = tker.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        tker.flash_attention_cuda(q, k, v, lens, causal=True, scale=1.0)
    with pytest.raises(ValueError, match="layout"):
        tops.flash_attention(q, k, v, layout="hbsd")
    assert tker.LAUNCHES == before


@pytest.mark.parametrize("dtype,d,sq,want", [
    (torch.bfloat16, 64, 2048, "prefill_tc"),
    (torch.bfloat16, 128, 2, "prefill_tc"),
    (torch.bfloat16, 32, 77, "simt"),           # no tensor-core tile at D=32
    (torch.float32, 64, 2048, "simt"),          # f32 prefill keeps 2e-5
    (torch.float32, 128, 3, "simt"),
    (torch.float32, 64, 1, "decode_split"),     # decode in any dtype
    (torch.float32, 32, 1, "decode_split"),
    (torch.bfloat16, 64, 1, "decode_split"),
    (torch.bfloat16, 32, 1, "decode_split"),
    (torch.bfloat16, 128, 1, "decode_split"),
])
def test_route_by_dtype_head_dim_and_rows(dtype, d, sq, want):
    assert tker.route(dtype, d, sq) == want
    assert want in tker.SOURCES and want in tker.LAUNCHES_BY_KERNEL


@pytest.mark.parametrize("b,hq,hkv,sq,skv,dqk,dv,kv_len", [
    (2, 4, 4, 13, 13, 24, 16, None),      # the reduced MLA configs' dims
    (1, 4, 4, 70, 70, 96, 64, None),      # minicpm3's
    (2, 4, 2, 5, 40, 96, 64, [33, 40]),   # last 5 of kv_len, GQA
    (1, 2, 2, 33, 33, 192, 128, None),    # deepseek-v2-lite's
])
def test_value_head_dim_of_its_own_matches_sdpa(b, hq, hkv, sq, skv, dqk, dv,
                                                kv_len):
    """MLA's prefill: q and k of head dim Dqk, v of Dv; the plain version
    in the model's (B, S, H, D) layout against the JAX model's _sdpa, whose
    output has v's head dim; scale 1/sqrt(Dqk)."""
    rng = np.random.default_rng(dqk + sq)
    q, k = _randn(rng, b, sq, hq, dqk), _randn(rng, b, skv, hkv, dqk)
    v = _randn(rng, b, skv, hkv, dv)
    lens = np.full(b, skv, np.int32) if kv_len is None else np.array(
        kv_len, np.int32)
    got = tops.flash_attention(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=True,
        kv_len=torch.from_numpy(lens), scale=dqk ** -0.5,
        layout="bshd").numpy()
    assert got.shape == (b, sq, hq, dv)
    want = _sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                 q_offset=jnp.asarray(lens - sq), kv_len=jnp.asarray(lens),
                 scale=dqk ** -0.5)
    np.testing.assert_allclose(got, np.asarray(want), **F32)


@pytest.mark.parametrize("dtype,dqk,dv,sq,want", [
    (torch.bfloat16, 192, 128, 2048, "prefill_tc"),
    (torch.bfloat16, 96, 64, 77, "prefill_tc"),
    (torch.bfloat16, 96, 64, 1, "prefill_tc"),   # no split decode at Dqk != Dv
    (torch.float32, 192, 128, 2048, "simt"),
    (torch.float32, 96, 64, 1, "simt"),
    (torch.bfloat16, 24, 16, 9, "simt"),         # no kernel instance: refused
])
def test_route_by_head_dim_pair(dtype, dqk, dv, sq, want):
    name = tker.route(dtype, dqk, sq, dv=dv)
    assert name == want
    assert ((dqk, dv) in tker.KERNEL_DIMS[name]) == (dqk != 24)
    assert all((d, d) in tker.KERNEL_DIMS["decode_split"]
               for d in (32, 64, 128))
    assert not any(a != b for a, b in tker.KERNEL_DIMS["decode_split"])


def test_trainable_op_takes_two_head_dims():
    """At Dqk != Dv (MLA's) the trainable op's output and dq, dk, dv equal
    autograd through the plain version, dv in v's shape (its parity with
    the JAX gradient: tests/test_torch_train_moe_mla.py)."""
    rng = np.random.default_rng(0)
    q, k = (torch.from_numpy(_randn(rng, 1, 4, 40, 24)).requires_grad_()
            for _ in range(2))
    v = torch.from_numpy(_randn(rng, 1, 4, 40, 16)).requires_grad_()
    g = torch.from_numpy(_randn(rng, 1, 4, 40, 16))
    out = tops.flash_attention_trainable(q, k, v)
    got = torch.autograd.grad(out, (q, k, v), g)
    want_out = attention_ref(q, k, v, causal=True)
    want = torch.autograd.grad(want_out, (q, k, v), g)
    torch.testing.assert_close(out, want_out, **GRAD_TOL["float32"])
    for a, w, x in zip(got, want, (q, k, v)):
        assert a.shape == x.shape
        torch.testing.assert_close(a, w, **GRAD_TOL["float32"])


def test_alignment_check_names_the_unaligned_tensor():
    base = torch.zeros(2, 64, 4, 64 + 8, dtype=torch.bfloat16)
    tker._check_16b("k", base[..., :64], 1, "TMA")      # 144-byte rows
    with pytest.raises(ValueError, match="k is not 16-byte aligned"):
        tker._check_16b("k", base[..., 1:65], 1, "TMA")  # base off by 2
    odd = torch.zeros(2, 64, 4, 68, dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="16-byte"):
        tker._check_16b("v", odd, 1, "TMA")             # 136-byte rows


def test_cpu_path_counts_no_kernel_launch():
    q, k, v = (torch.from_numpy(x) for x in _qkv(9, 1, 2, 2, 1, 40, 64))
    before = dict(tker.LAUNCHES_BY_KERNEL)
    tops.flash_attention(q, k, v, causal=True)
    tops.flash_attention(q.to(torch.bfloat16), k.to(torch.bfloat16),
                         v.to(torch.bfloat16), causal=True)
    assert tker.LAUNCHES_BY_KERNEL == before


_KS = tker.DECODE_SPLIT


@pytest.mark.parametrize("hq,hkv,split,fill,d,s_cache", [
    (4, 4, 32, [0, 16, 63, 95, 90], 32, 96),      # group 1; kv_len 1
    (4, 2, 40, [5, 39, 40, 79, 95], 32, 96),      # 40 does not divide 96
    (8, 2, 32, [0, 31, 32, 64, 95], 32, 96),      # group 4; split edges
    (8, 2, 96, [3, 17, 40, 70, 95], 32, 96),      # one split covers it
    (8, 2, 7, [0, 1, 50, 94, 95], 32, 96),        # most splits past kv_len
    # decode_split's own split size over 3 splits, the last one short
    (4, 2, _KS, [0, _KS, 2 * _KS + 87, 1, 300], 32, 2 * _KS + 88),
    (4, 2, _KS, [0, _KS, 2 * _KS + 87, 1, 300], 64, 2 * _KS + 88),
    (4, 2, _KS, [0, _KS, 2 * _KS + 87, 1, 300], 128, 2 * _KS + 88),
])
def test_split_decode_algebra_matches_sdpa(hq, hkv, split, fill, d, s_cache):
    """The split-KV decode's split-and-combine algebra against the JAX
    model's _sdpa with per-slot offsets: kv_len = 1 (fill 0), kv_len =
    Skv (fill Skv - 1), splits wholly past kv_len, split sizes that do
    not divide Skv, GQA groups 1, 2 and 4, head dims 32, 64 and 128."""
    rng = np.random.default_rng(hq * 100 + split + d - 32)
    b = 5
    fill = np.array(fill, np.int32)
    q = _randn(rng, b, 1, hq, d)
    k = _randn(rng, b, s_cache, hkv, d)
    v = _randn(rng, b, s_cache, hkv, d)
    kv_len = fill + 1
    got = attention_split_ref(
        *(torch.from_numpy(x).transpose(1, 2) for x in (q, k, v)),
        torch.from_numpy(kv_len), split, scale=d ** -0.5)
    want = _sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                 q_offset=jnp.asarray(fill), kv_len=jnp.asarray(kv_len),
                 scale=d ** -0.5)
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), np.asarray(want),
                               **F32)


def test_split_decode_algebra_gives_zeros_without_keys():
    q, k, v = (torch.from_numpy(x) for x in _qkv(10, 3, 4, 2, 1, 50, 32))
    out = attention_split_ref(q, k, v, torch.tensor([0, 50, 0]), 16)
    assert torch.isfinite(out).all()
    assert out[0].abs().max() == 0 and out[2].abs().max() == 0
    torch.testing.assert_close(
        out[1:2], attention_ref(q[1:2], k[1:2], v[1:2], causal=True),
        atol=2e-6, rtol=1e-5)


# ------------------------------------------------------- the trainable op
#
# flash_attention_trainable's gradients against jax.vjp of the JAX
# package's flash_attention_trainable (its Pallas forward in interpret
# mode, its backward the VJP of the reference): float32 within atol 1e-5 /
# rtol 1e-4 of the output's own tolerance, bf16 within 2e-2 (the
# gradients are computed in float32 from bf16 inputs and rounded once).

import jax  # noqa: E402
from jax import vjp as jvjp  # noqa: E402

from repro.kernels.flash_attention.ops import (  # noqa: E402
    flash_attention_trainable as jtrainable,
)

GRAD_TOL = {"float32": dict(atol=1e-5, rtol=1e-4),
            "bfloat16": dict(atol=2e-2, rtol=2e-2)}


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d", [
    (1, 4, 4, 65, 65, 64),      # group 1, ragged
    (2, 4, 2, 200, 200, 32),    # group 2, ragged
    (1, 8, 2, 127, 127, 64),    # group 4
    (1, 4, 1, 48, 100, 32),     # group 4, queries the last 48 of 100
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_trainable_grads_match_jax_vjp(b, hq, hkv, sq, skv, d, dtype):
    q, k, v = _qkv(sq + 3 * hq + d, b, hq, hkv, sq, skv, d)
    g = _randn(np.random.default_rng(sq), b, hq, sq, d)
    jargs = [jnp.asarray(x, dtype=dtype) for x in (q, k, v)]
    jout, pullback = jvjp(jtrainable, *jargs)
    jgrads = pullback(jnp.asarray(g, dtype=dtype))
    targs = [torch.from_numpy(np.array(x, np.float32)).to(
        getattr(torch, dtype)).requires_grad_() for x in jargs]
    out = tops.flash_attention_trainable(*targs)
    grads = torch.autograd.grad(out, targs, torch.from_numpy(np.array(
        jnp.asarray(g, dtype=dtype), np.float32)).to(out.dtype))
    tol = GRAD_TOL[dtype]
    np.testing.assert_allclose(out.detach().float().numpy(),
                               np.asarray(jout, np.float32), **tol)
    for name, got, want in zip("qkv", grads, jgrads):
        assert got.dtype == targs[0].dtype and got.shape == want.shape, name
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), **tol,
                                   err_msg=f"d{name}")


def test_trainable_q_k_v_get_the_reference_gradients():
    """Through the op, q, k and v get gradients, equal to autograd through
    the plain version; bshd (the model's layout) equals bhsd."""
    q, k, v = (torch.from_numpy(x).requires_grad_()
               for x in _qkv(5, 2, 8, 2, 90, 90, 64))
    g = torch.randn(2, 8, 90, 64, generator=torch.Generator().manual_seed(1))
    tops.flash_attention_trainable(q, k, v).backward(g)
    got = [x.grad.clone() for x in (q, k, v)]
    for x in (q, k, v):
        x.grad = None
    attention_ref(q, k, v, causal=True).backward(g)
    for a, x in zip(got, (q, k, v)):
        assert a.abs().max() > 0
        torch.testing.assert_close(a, x.grad, **GRAD_TOL["float32"])
    qs, ks, vs = (x.detach().transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    out = tops.flash_attention_trainable(qs, ks, vs, layout="bshd")
    out.backward(g.transpose(1, 2))
    for a, x in zip(got, (qs, ks, vs)):
        torch.testing.assert_close(x.grad.transpose(1, 2), a, atol=1e-6,
                                   rtol=1e-6)


def test_attention_vjp_chunks_equal_one_block():
    q, k, v = (torch.from_numpy(x) for x in _qkv(8, 1, 4, 2, 70, 100, 32))
    g = torch.randn(1, 4, 70, 32, generator=torch.Generator().manual_seed(2))
    whole = tops.attention_vjp(q, k, v, g, scale=0.2)
    for chunk in (1, 16, 33):
        parts = tops.attention_vjp(q, k, v, g, scale=0.2, chunk=chunk)
        for a, b in zip(parts, whole):
            torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)


def test_model_train_mode_calls_the_trainable_op(monkeypatch):
    """mode="train" goes through flash_attention_trainable; the raw op is
    left to prefill and decode."""
    from repro_torch import configs
    from repro_torch.models import attention
    from repro_torch.models.model import build

    tm = build(configs.reduced("stablelm-1.6b"), device="cpu")
    tm.init(torch.Generator().manual_seed(0))
    calls = {"trainable": 0, "raw": 0}
    real_t, real_r = (attention.flash_attention_trainable,
                      attention.flash_attention)

    def trainable(*a, **kw):
        calls["trainable"] += 1
        return real_t(*a, **kw)

    def raw(*a, **kw):
        calls["raw"] += 1
        return real_r(*a, **kw)

    monkeypatch.setattr(attention, "flash_attention_trainable", trainable)
    monkeypatch.setattr(attention, "flash_attention", raw)
    tok = torch.randint(0, 512, (2, 12), generator=torch.Generator())
    tm(tok, remat=False).sum().backward()
    assert calls == {"trainable": tm.cfg.num_layers, "raw": 0}
    assert all(p.grad is not None for p in tm.parameters())
    tm.apply(tok, mode="prefill", cache=tm.init_cache(2, 16), pos=0)
    assert calls == {"trainable": tm.cfg.num_layers,
                     "raw": tm.cfg.num_layers}


# The non-causal branch of attention_vjp (whisper's encoder and
# cross-attention) against jax.vjp of the reference's jnp attention
# (``repro.kernels.flash_attention.ref.attention_ref``) at causal=False, one
# batch row at a time at its own kv_len (the reference takes a scalar);
# float32, the tolerance of the causal cases above.

@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,lens", [
    (2, 4, 2, 30, 75, 32, (75, 52)),    # Sq < Skv, GQA, ragged kv_len
    (2, 4, 4, 90, 40, 32, (40, 17)),    # Sq > Skv (cross-attention)
    (1, 8, 2, 64, 64, 64, (61,)),       # group 4, square
])
def test_noncausal_vjp_matches_jax_vjp(b, hq, hkv, sq, skv, d, lens):
    q, k, v = _qkv(sq + skv + d, b, hq, hkv, sq, skv, d)
    g = _randn(np.random.default_rng(skv), b, hq, sq, d)
    kv_len = torch.tensor(lens)
    targs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = tops.flash_attention_trainable(*targs, causal=False,
                                         kv_len=kv_len, scale=d ** -0.5)
    grads = torch.autograd.grad(out, targs, torch.from_numpy(g))
    direct = tops.attention_vjp(*(x.detach() for x in targs),
                                torch.from_numpy(g), scale=d ** -0.5,
                                causal=False, kv_len=kv_len, chunk=16)
    tol = GRAD_TOL["float32"]
    for row in range(b):
        def attend(q_, k_, v_, n=lens[row]):
            return jref(q_, k_, v_, causal=False, kv_len=n)

        jout, pullback = jvjp(jax.jit(attend), *(jnp.asarray(x[row:row + 1])
                                        for x in (q, k, v)))
        jgrads = pullback(jnp.asarray(g[row:row + 1]))
        np.testing.assert_allclose(out.detach()[row:row + 1].numpy(),
                                   np.asarray(jout), **tol)
        for name, got, chunked, want in zip("qkv", grads, direct, jgrads):
            np.testing.assert_allclose(got[row:row + 1].numpy(),
                                       np.asarray(want), **tol,
                                       err_msg=f"d{name} row {row}")
            np.testing.assert_allclose(chunked[row:row + 1].numpy(),
                                       np.asarray(want), **tol,
                                       err_msg=f"chunked d{name} row {row}")
        # masked keys get no gradient
        assert not grads[1][row, :, lens[row]:].any()


def test_causal_vjp_with_kv_len_matches_the_plain_version():
    """The trainable op at causal=True with a per-row kv_len (the queries
    the last Sq of each row's kv_len positions): its gradients equal
    autograd through the plain version."""
    q, k, v = (torch.from_numpy(x).requires_grad_()
               for x in _qkv(11, 2, 4, 2, 20, 50, 32))
    kv_len = torch.tensor([50, 33])
    g = torch.randn(2, 4, 20, 32, generator=torch.Generator().manual_seed(3))
    got = torch.autograd.grad(tops.flash_attention_trainable(
        q, k, v, kv_len=kv_len), (q, k, v), g)
    want = torch.autograd.grad(attention_ref(q, k, v, causal=True,
                                             kv_len=kv_len), (q, k, v), g)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, **GRAD_TOL["float32"])
