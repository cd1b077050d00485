"""The int8 KV cache (``kv_cache_dtype="int8"``) against the JAX package's.

- Quantize (``attention._quantize_kv``) and dequantize
  (``ref.dequantize_kv``) bit for bit with ``repro.models.attention``'s
  ``_quantize_kv``/``_dequantize_kv`` on seeded inputs, with rounding ties
  at .5, all-zero rows (the 1e-8 scale floor), large and tiny magnitudes.
- The cache specs (names, shapes, dtypes) equal the reference's, and the
  full internlm2-20b's int8 cache holds under 0.6 of the bf16 cache's
  bytes (the reference's ``test_cache_bytes_halved``), on the ``meta``
  device.
- The reduced float32 stablelm-1.6b and internlm2-20b, prefill 12 then
  decode 1 (the reference's own int8 test's shapes): logits within 1e-4
  of the JAX int8 model's; int8 values equal or one apart (a k or v that
  lands on a rounding tie in one package and a float32 ulp off it in the
  other) in at most 0.1% of the entries, scales within one bf16 ulp.  A
  multi-token decode (3 queries) likewise.
- The reference's int8-vs-bf16 bound, ``err < 0.05 max|logits| + 0.1``,
  held on the port.
- MLA and RWKV configs ignore the field, as in the reference: their
  caches and logits equal their bf16 config's.
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
from repro.models.model import build as jbuild  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.kernels.flash_attention import ops as tops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as tref  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models.model import build  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

GQA = ["stablelm-1.6b", "internlm2-20b"]
B, PROMPT, CACHE = 2, 12, 32


@pytest.fixture(scope="module", autouse=True)
def _full_f32_matmuls():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_float32_matmul_precision(prev)


def _int8(cfg):
    return dataclasses.replace(cfg, kv_cache_dtype="int8")


def _tokens(vocab, s=PROMPT + 1, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, s)).astype(
        np.int32)


# ------------------------------------------------- quantize and dequantize
def _quant_inputs():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 6, 3, 32)).astype(np.float32)
    # rows whose absmax is 127 * 2^m: the scale is 2^m exactly, so values
    # (j + 0.5) 2^m sit on rounding ties, both signs
    ties = (np.arange(32) - 15.5).astype(np.float32)
    ties[0] = -127.0
    for i, m in enumerate((0, -3, 4)):
        x[0, i, 0] = ties * np.float32(2.0 ** m)
    x[0, 3] = 0.0                                     # all-zero rows
    x[1, 0, 1] *= np.float32(1e30)                    # large magnitudes
    x[1, 1, 2] *= np.float32(1e-12)                   # below the floor
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_bit_for_bit_with_jax(dtype):
    x = _quant_inputs()
    jx = jnp.asarray(x, dtype=dtype)
    jq, js = jattn._quantize_kv(jx)
    tx = torch.from_numpy(np.array(jx, np.float32)).to(getattr(torch, dtype))
    tq, ts = tattn._quantize_kv(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.bfloat16
    assert tuple(ts.shape) == x.shape[:3] + (1,)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.view(torch.int16).numpy(),
                                  np.asarray(js).view(np.int16))
    # the ties rounded to even, the zero rows at the floor
    assert set(np.abs(tq[0, 0, 0].numpy()[1:]).tolist()) <= set(
        range(0, 128, 2))
    assert (tq[0, 3] == 0).all()
    assert torch.all(ts[0, 3] == torch.tensor(1e-8).to(torch.bfloat16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequantize_bit_for_bit_with_jax(dtype):
    jq, js = jattn._quantize_kv(jnp.asarray(_quant_inputs()))
    want = jattn._dequantize_kv(jq, js, getattr(jnp, dtype))
    got = tref.dequantize_kv(torch.from_numpy(np.asarray(jq)),
                               torch.from_numpy(np.asarray(
                                   js, np.float32)).to(torch.bfloat16),
                               getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


def test_int8_flash_op_reads_the_dequantized_cache():
    """On the CPU ops.flash_attention over an int8 cache is the plain
    version on the cache dequantized to q's dtype, for one query row and
    several; int8 values need both scales, and scales an int8 cache."""
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.normal(size=(2, 3, 4, 32)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(2, 40, 2, 32)).astype(
        np.float32)) for _ in range(2))
    (kq, ks), (vq, vs) = tattn._quantize_kv(k), tattn._quantize_kv(v)
    lens = torch.tensor([17, 40])
    for sq in (1, 3):
        got = tops.flash_attention(q[:, :sq], kq, vq, kv_len=lens,
                                   layout="bshd", k_scale=ks, v_scale=vs)
        want = tops.flash_attention(
            q[:, :sq], tref.dequantize_kv(kq, ks, q.dtype),
            tref.dequantize_kv(vq, vs, q.dtype), kv_len=lens,
            layout="bshd")
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="k_scale and v_scale"):
        tops.flash_attention(q, kq, vq, layout="bshd", k_scale=ks)
    with pytest.raises(ValueError, match="k_scale and v_scale"):
        tops.flash_attention(q, k, v, layout="bshd", k_scale=ks, v_scale=vs)


# ------------------------------------------------ the int8 kernel's bits
# decode_split's int8 instance (``csrc/flash_decode_split.cu``, ``Int8Row``)
# dequantizes with no conversion instruction: a word of four int8 is
# offset by 128 (``w ^ 0x80808080``), each byte is put into the low
# mantissa byte of 2^23 by ``prmt`` (selector ``0x7650 | i``: byte i of the
# word, then bytes 1, 2 and 3 of 0x4B000000), and 2^23 + 128 comes off; the
# product with the scale is exact in float32, and bf16 rounds two products
# at a time (``cvt.rn.bf16x2.f32``: nearest even, the first in the low
# half), unpacked by shifts.  Modelled here in numpy operation by
# operation and held bit for bit against ``ref.dequantize_kv``.
_MAGIC, _MAGIC_OFF = 0x4B000000, np.float32(8388736.0)   # 2^23, 2^23 + 128


def _byte_perm(x, y, sel):
    """CUDA's ``__byte_perm`` (PTX ``prmt``, default mode) on uint32
    arrays; the kernel's selectors never set a nibble's sign bit."""
    pool = [(x >> np.uint32(8 * i)) & np.uint32(0xFF) for i in range(4)]
    pool += [np.full_like(x, (y >> (8 * i)) & 0xFF) for i in range(4)]
    out = np.zeros_like(x)
    for i in range(4):
        nib = (sel >> (4 * i)) & 0xF
        assert nib < 8
        out |= pool[nib] << np.uint32(8 * i)
    return out


def _rn_bf16_bits(f):
    """float32 -> bf16 bits (uint32), round to nearest even, finite f."""
    b = f.view(np.uint32).astype(np.uint64)
    return ((b + 0x7FFF + ((b >> 16) & 1)) >> 16).astype(np.uint32)


def _kernel_dequantize(q, scale_bits, dtype):
    """int8 ``q`` (..., D) and bf16 scale bits (..., 1) as the kernel
    dequantizes them, float32 values of ``dtype``."""
    words = np.ascontiguousarray(q).view(np.uint32)        # (..., D / 4)
    u = words ^ np.uint32(0x80808080)
    x = np.stack([_byte_perm(u, _MAGIC, 0x7650 | i).view(np.float32)
                  - _MAGIC_OFF for i in range(4)], -1).reshape(q.shape)
    prod = x * (scale_bits.astype(np.uint32) << np.uint32(16)).view(
        np.float32)
    if dtype == torch.float32:
        return prod
    pairs = prod.reshape(*q.shape[:-1], -1, 2)
    packed = _rn_bf16_bits(pairs[..., 0]) | (_rn_bf16_bits(pairs[..., 1])
                                             << np.uint32(16))
    return np.stack([(packed << np.uint32(16)).view(np.float32),
                     (packed & np.uint32(0xFFFF0000)).view(np.float32)],
                    -1).reshape(q.shape)


def _edge_row_scales():
    """The scales of an all-zero row (the 1e-8 floor) and of a row holding
    both +127 and -127, as the model quantizes them."""
    x = torch.from_numpy(np.random.default_rng(3).uniform(
        -1, 1, (1, 2, 1, 32)).astype(np.float32))
    x[0, 0] = 0.0
    x[0, 1, 0, :2] = torch.tensor([2.0, -2.0])
    q, s = tattn._quantize_kv(x)
    assert (q[0, 0] == 0).all() and q[0, 1, 0, 0] == 127
    assert q[0, 1, 0, 1] == -127
    return q, s


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_kernel_dequantization_bit_path(dtype):
    """All 256 int8 values times a spread of bf16 scales (the all-zero
    row's floor, the +-127 row's, 2^-30 .. 2^20, and random mantissas),
    and the quantized edge rows themselves: the kernel's bit path equals
    ref.dequantize_kv bit for bit, in float32 and in bf16."""
    q_edge, s_edge = _edge_row_scales()
    rng = np.random.default_rng(4)
    spread = np.concatenate([
        np.float32(2.0) ** np.arange(-30, 21, dtype=np.float32),
        rng.uniform(1e-6, 1e3, 64).astype(np.float32)])
    scales = torch.cat([s_edge.reshape(-1), torch.from_numpy(spread).to(
        torch.bfloat16)])
    values = torch.arange(-128, 128, dtype=torch.int16).to(torch.int8)
    q = values.expand(len(scales), 256).contiguous()
    for qq, ss in ((q, scales[:, None]), (q_edge, s_edge)):
        got = _kernel_dequantize(qq.numpy(), ss.view(torch.int16).numpy()
                                 .view(np.uint16), dtype)
        want = tref.dequantize_kv(qq, ss, dtype).float().numpy()
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))


# -------------------------------------------------------------- cache specs
@pytest.mark.parametrize("arch", ["internlm2-20b", "deepseek-v2-lite-16b",
                                  "minicpm3-4b", "rwkv6-3b"])
def test_cache_specs_equal_reference(arch):
    """Per layer, the port's cache tensors have the reference's names,
    shapes and dtypes; MLA and RWKV caches are their bf16 config's."""
    cfg = _int8(configs.reduced(arch))
    jspecs = jbuild(_int8(jconfigs.reduced(arch))).cache_specs(B, CACHE)
    want = {}
    for name, spec in jspecs["layers"].items():
        dtype = np.dtype(spec.dtype or jnp.bfloat16).name
        want[name] = (tuple(spec.shape[1:]), dtype)
    tm = build(cfg, device="meta")
    got = {name: (tuple(t.shape[1:]), str(t.dtype).removeprefix("torch."))
           for name, t in tm.init_cache(B, CACHE).items()}
    assert got == want
    plain = build(configs.reduced(arch), device="meta").init_cache(B, CACHE)
    if cfg.attention != "gqa" or cfg.family == "ssm":
        assert {n: (t.shape, t.dtype) for n, t in plain.items()} == {
            n: (t.shape, t.dtype) for n, t in
            tm.init_cache(B, CACHE).items()}


def test_full_internlm2_cache_bytes_under_six_tenths():
    def nbytes(cfg):
        cache = build(cfg, device="meta").init_cache(8, 1024)
        return sum(t.numel() * t.element_size() for t in cache.values())

    cfg = configs.get("internlm2-20b")
    assert nbytes(_int8(cfg)) < 0.6 * nbytes(cfg)
    # D = 128: 128 one-byte values and a 2-byte scale against 256 bytes
    assert nbytes(_int8(cfg)) / nbytes(cfg) == pytest.approx(130 / 256)


# ------------------------------------------------------- models against JAX
@functools.lru_cache(maxsize=None)
def _jax_int8(arch):
    """The JAX int8 model's weights, its caches and logits after prefill
    12 and decode 1, and after prefill 10 and a 3-token decode."""
    jm = jbuild(dataclasses.replace(_int8(jconfigs.reduced(arch)),
                                    dtype="float32"))
    params = jax.jit(jm.init)(jax.random.PRNGKey(0))
    tok = jnp.asarray(_tokens(jm.cfg.vocab_size))

    @jax.jit
    def run(p, prompt, nxt, pos):
        _, cache = jm.apply(p, tokens=prompt, mode="prefill",
                            cache=jm.init_cache(B, CACHE), pos=0)
        return jm.apply(p, tokens=nxt, mode="decode", cache=cache,
                        pos=jnp.int32(pos))

    one = run(params, tok[:, :PROMPT], tok[:, PROMPT:], PROMPT)
    multi = run(params, tok[:, :10], tok[:, 10:13], 10)
    return (jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, one),
            jax.tree.map(np.asarray, multi))


def _port_int8(arch, params, dtype="float32"):
    tm = build(dataclasses.replace(_int8(configs.reduced(arch)),
                                   dtype=dtype), device="cpu")
    tm.load_state_dict(convert.model_params_from_reference(tm.cfg, params))
    return tm


def _run(tm, tok, prompt, s_new):
    tok = torch.from_numpy(tok).long()
    cache = tm.init_cache(B, CACHE)
    tm.apply(tok[:, :prompt], mode="prefill", cache=cache, pos=0)
    logits, cache = tm.apply(tok[:, prompt:prompt + s_new], mode="decode",
                             cache=cache, pos=prompt)
    return logits, cache


def _caches_close(cache, jcache):
    for name in ("k", "v"):
        got = cache[name].numpy().astype(np.int32)
        want = jcache["layers"][name].astype(np.int32)
        diff = np.abs(got - want)
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, name
        sc = cache[f"{name}_scale"].float().numpy()
        want_sc = jcache["layers"][f"{name}_scale"].astype(np.float32)
        np.testing.assert_allclose(sc, want_sc, rtol=2.0 ** -8, atol=0)


@pytest.mark.parametrize("arch", GQA)
def test_prefill_then_decode_matches_jax_int8(arch):
    params, (jlogits, jcache), _ = _jax_int8(arch)
    tm = _port_int8(arch, params)
    logits, cache = _run(tm, _tokens(tm.cfg.vocab_size), PROMPT, 1)
    np.testing.assert_allclose(logits.numpy(), jlogits, atol=1e-4,
                               rtol=1e-4)
    _caches_close(cache, jcache)


@pytest.mark.parametrize("arch", GQA)
def test_multi_token_decode_matches_jax_int8(arch):
    """Three queries over the int8 cache: the decode's dequantize-first
    path (no main path runs it; ROADMAP Documented differences)."""
    params, _, (jlogits, jcache) = _jax_int8(arch)
    tm = _port_int8(arch, params)
    logits, cache = _run(tm, _tokens(tm.cfg.vocab_size), 10, 3)
    assert logits.shape == (B, 3, tm.cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), jlogits, atol=1e-4,
                               rtol=1e-4)
    _caches_close(cache, jcache)


@pytest.mark.parametrize("arch", GQA)
def test_int8_decode_close_to_bf16_cache(arch):
    """The reference's own bound (tests/test_perf_knobs.py), on the port:
    the bf16 reduced model with an int8 cache against its bf16 cache."""
    cfg = configs.reduced(arch)
    outs = []
    for c in (cfg, _int8(cfg)):
        tm = build(c, device="cpu").init(torch.Generator().manual_seed(0))
        outs.append(_run(tm, _tokens(cfg.vocab_size, seed=1), PROMPT, 1)[0])
    scale = float(outs[0].abs().max())
    err = float((outs[0] - outs[1]).abs().max())
    assert 0 < err < 0.05 * scale + 0.1, (err, scale)


@pytest.mark.parametrize("arch", ["minicpm3-4b", "deepseek-v2-lite-16b",
                                  "rwkv6-3b"])
def test_mla_and_rwkv_ignore_int8(arch):
    """An int8 MLA or RWKV config builds and serves exactly as its bf16
    config: the same cache and the same logits, bit for bit."""
    cfg = dataclasses.replace(configs.reduced(arch), dtype="float32")
    runs = []
    for c in (cfg, _int8(cfg)):
        tm = build(c, device="cpu").init(torch.Generator().manual_seed(0))
        runs.append(_run(tm, _tokens(cfg.vocab_size), PROMPT, 1))
    torch.testing.assert_close(runs[1][0], runs[0][0], rtol=0, atol=0)
    assert runs[0][1].keys() == runs[1][1].keys()
    for name, t in runs[0][1].items():
        assert torch.equal(runs[1][1][name], t), name


def test_engine_serves_an_int8_cache_slot_by_slot():
    """The engine's slot views and in-place writes cover the four cache
    tensors: each request served among others gets the tokens it gets
    alone in a one-slot engine."""
    cfg = dataclasses.replace(_int8(configs.reduced("internlm2-20b")),
                              dtype="float32")
    tm = build(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(2)
    specs = [(rng.integers(0, cfg.vocab_size, n).astype(np.int32), m)
             for n, m in ((5, 4), (17, 6), (9, 3), (12, 5))]

    def serve(slots, chosen):
        engine = ServeEngine(tm, num_slots=slots, cache_len=CACHE)
        reqs = [Request(i, p, m) for i, (p, m) in enumerate(chosen)]
        pending = list(reqs)
        while pending or engine.active_slots:
            while pending and engine.try_admit(pending[0]):
                pending.pop(0)
            engine.tick()
        assert set(engine.cache) == {"k", "v", "k_scale", "v_scale"}
        return [r.generated for r in reqs]

    together = serve(2, specs)
    alone = [serve(1, [spec])[0] for spec in specs]
    assert together == alone
