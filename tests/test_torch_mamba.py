"""The PyTorch port's Mamba layer and selective scan against the JAX
package's.

The port's scan walks the sequence step by step (on the card one CUDA
kernel, on the CPU the plain loop of ``kernels/mamba_scan/ref.py``); the
reference runs an associative scan within chunks of ``pick_chunk(S)``
steps.  Both are float32, so they agree to float32 rounding, not bit for
bit: the sequential and the associative sums round differently, each
error shrinking with the decays.  Tolerances:
- the scan's y and final state within 1e-5 of their largest magnitude;
- the layer's output and its new state (conv tail, h), in prefill and in
  a one-step decode, within 1e-5 relative, on the reference's own
  parameters (``a_log`` drawn so the decays span e^-0.4 to e^-e^2 a step).
Inputs are numpy draws handed to both.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs  # noqa: E402
from repro.models import mamba as jmamba  # noqa: E402
from repro.models.params import init_params  # noqa: E402
from repro.models.scan_utils import pick_chunk  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels.mamba_scan import mamba_scan as mk  # noqa: E402
from repro_torch.kernels.mamba_scan import ops  # noqa: E402
from repro_torch.kernels.mamba_scan.ref import mamba_scan_ref  # noqa: E402
from repro_torch.models import mamba  # noqa: E402

ARCH = "jamba-v0.1-52b"
SCAN_TOL = LAYER_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _full_f32_matmuls():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_float32_matmul_precision(prev)


def _scan_inputs(b, s, d, n, seed):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    delta = np.log1p(np.exp(rng.normal(size=(b, s, d)))).astype(f32)
    a = -np.exp(rng.uniform(-1.0, 2.0, (d, n))).astype(f32)
    return (delta, a, rng.normal(size=(b, s, n)).astype(f32),
            rng.normal(size=(b, s, n)).astype(f32),
            rng.normal(size=(b, s, d)).astype(f32),
            rng.normal(size=(b, d, n)).astype(f32))


def _within(got, want, rel):
    want = np.asarray(want)
    err = np.abs(got.numpy() - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("s", [13, 37, 64, 100])
def test_plain_scan_matches_reference_scan(s):
    """13 and 37: pick_chunk takes the whole sequence; 64 and 100: two
    chunks of 32 and 50, the carry folded into the second."""
    delta, a, bm, cm, x, h0 = _scan_inputs(2, s, 24, 8, s)
    chunk = pick_chunk(s, target_iters=16, max_chunk=2048)
    assert (chunk == s) == (s in (13, 37))
    jy, jh = jmamba._ssm_scan(*(jnp.asarray(t) for t in (
        delta, a, bm, cm, x, h0)), chunk)
    ty, th = mamba_scan_ref(*(torch.from_numpy(t) for t in (
        delta, x, a, bm, cm, h0)))
    _within(ty, jy, SCAN_TOL)
    _within(th, jh, SCAN_TOL)


def test_ops_on_cpu_tensors_run_the_plain_version():
    args = [torch.from_numpy(t) for t in _scan_inputs(1, 9, 16, 4, 1)]
    delta, a, bm, cm, x, h0 = args
    before = mk.LAUNCHES
    got = ops.mamba_scan(delta, x, a, bm, cm, h0)
    want = mamba_scan_ref(delta, x, a, bm, cm, h0)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert mk.LAUNCHES == before
    y, h = ops.mamba_scan(delta[:, :0], x[:, :0], a, bm[:, :0], cm[:, :0],
                          h0)
    assert y.shape == (1, 0, 16)
    torch.testing.assert_close(h, h0, rtol=0, atol=0)


def test_cuda_is_refused_without_a_card():
    """The kernel's wrapper takes CUDA tensors only, and the Mamba layer's
    default device is the card."""
    args = [torch.from_numpy(t) for t in _scan_inputs(1, 5, 8, 4, 2)]
    delta, a, bm, cm, x, h0 = args
    with pytest.raises(ValueError, match="CUDA"):
        mk.mamba_scan_cuda(delta, x, a, bm, cm, h0)
    with pytest.raises(ValueError, match="meta"):
        ops.mamba_scan(*(t.to("meta") for t in (delta, x, a, bm, cm, h0)))
    if torch.cuda.is_available():
        return
    from repro_torch.models.model import build
    with pytest.raises(RuntimeError, match='device="cpu"'):
        build(configs.reduced(ARCH))


@pytest.fixture(scope="module")
def layer_pair():
    """One reduced float32 Mamba layer in both packages, on the reference's
    parameters; a_log and conv_b drawn away from their init (zeros) so
    the decays differ by channel and state."""
    jcfg = dataclasses.replace(jconfigs.reduced(ARCH), dtype="float32")
    cfg = dataclasses.replace(configs.reduced(ARCH), dtype="float32")
    p = init_params(jmamba.mamba_specs(jcfg), jax.random.PRNGKey(4),
                    jnp.float32)
    rng = np.random.default_rng(5)
    p = dict(p, a_log=jnp.asarray(rng.uniform(-1, 2, p["a_log"].shape),
                                  jnp.float32),
             conv_b=jnp.asarray(rng.normal(size=p["conv_b"].shape) * 0.1,
                                jnp.float32))
    layer = mamba.Mamba(cfg, dtype=torch.float32, device="cpu")
    layer.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in p.items()})
    return jcfg, p, cfg, layer


def test_layer_prefill_and_decode_match_reference(layer_pair):
    """Prefill 40 tokens from a zero state, then one decode step from the
    state it left: outputs, conv tails and h within 1e-5 relative."""
    jcfg, p, cfg, layer = layer_pair
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 41, cfg.d_model)).astype(np.float32)
    jstate = init_params(jmamba.mamba_state_specs(jcfg, 2),
                         jax.random.PRNGKey(0), jnp.float32)
    layer_fn = {mode: jax.jit(functools.partial(
        jmamba.mamba_layer, cfg=jcfg, mode=mode)) for mode in (
        "prefill", "decode")}
    jout, jstate = layer_fn["prefill"](p, jnp.asarray(x[:, :40]),
                                       state=jstate)
    state = {k: torch.zeros(s.shape, dtype=s.dtype or torch.float32)
             for k, s in mamba.mamba_state_specs(cfg, 2).items()}
    with torch.no_grad():
        out = layer(torch.from_numpy(x[:, :40]), mode="prefill", state=state)
    _within(out, jout, LAYER_TOL)
    for name in ("conv", "h"):
        _within(state[name], jstate[name], LAYER_TOL)
    jout, jstate = layer_fn["decode"](p, jnp.asarray(x[:, 40:]),
                                      state=jstate)
    with torch.no_grad():
        out = layer(torch.from_numpy(x[:, 40:]), mode="decode", state=state)
    _within(out, jout, LAYER_TOL)
    for name in ("conv", "h"):
        _within(state[name], jstate[name], LAYER_TOL)
    # the conv tail is the last d_conv - 1 inputs of the projection
    assert state["conv"].shape == (2, cfg.ssm_d_conv - 1, cfg.ssm_d_inner)
