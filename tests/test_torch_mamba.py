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


# ---------------------------------------------------------- the backward
# ``mamba_scan_trainable`` on CPU tensors (forward mamba_scan_ref, backward
# mamba_scan_bwd_ref) against ``jax.vjp`` of the reference's ``_ssm_scan``;
# ``mamba_scan_bwd_ref`` against torch autograd through ``mamba_scan_ref``;
# the chunked algebra of the CUDA kernels (``*_chunked_ref`` below, the
# kernels' three passes in plain PyTorch) against the step loops.  Each
# gradient within 1e-5 of its largest magnitude.
from repro_torch.kernels.mamba_scan import ref as mref  # noqa: E402

GRAD_TOL = 1e-5


def _chunks(t: torch.Tensor, chunk: int) -> torch.Tensor:
    """(B, S, ...) -> (B, C, chunk, ...), zero-padded past S (a padded
    step has delta = 0: decay 1, no input, no output gradient)."""
    b, s = t.shape[:2]
    pad = -s % chunk
    if pad:
        t = torch.cat([t, t.new_zeros((b, pad, *t.shape[2:]))], 1)
    return t.reshape(b, -1, chunk, *t.shape[2:])


def mamba_scan_chunked_ref(delta, x, a, bm, cm, h0,
                           chunk: int = mref.CHUNK):
    """The forward kernel's three passes: (y, final h, the chunk-start
    states (B, C, D, N)), float32, C = ceil(S / chunk).  Pass 1 runs
    every chunk from h = 0 (its local end state) and sums its deltas;
    pass 2 walks the chunks in order, start_k = h, h = exp(a sum_k delta)
    h + local_k; pass 3 runs every chunk again from its start for y, the
    last one also for the final h."""
    delta, x, a, bm, cm = (t.float() for t in (delta, x, a, bm, cm))
    b, s, d = delta.shape
    dc, xc, bc, cc = (_chunks(t, chunk) for t in (delta, x, bm, cm))
    nc = dc.shape[1]

    def run(h, out):
        ys = []
        for r in range(chunk):
            dt = dc[:, :, r, :, None]                      # (B, C, D, 1)
            h = (torch.exp(dt * a) * h
                 + dt * bc[:, :, r, None, :] * xc[:, :, r, :, None])
            if out:
                ys.append((cc[:, :, r, None, :] * h).sum(-1))
        return h, ys

    local, _ = run(torch.zeros((b, nc, d, a.shape[1]),
                               device=delta.device), False)
    decay = torch.exp(dc.sum(2)[..., None] * a)            # (B, C, D, N)
    h, starts = h0.float(), []
    for k in range(nc):
        starts.append(h)
        h = decay[:, k] * h + local[:, k]
    states = torch.stack(starts, 1)
    ends, ys = run(states, True)
    y = torch.stack(ys, 2).reshape(b, nc * chunk, d)[:, :s]
    return y, ends[:, -1], states


def mamba_scan_bwd_chunked_ref(delta, x, a, bm, cm, dy, states,
                               dh_final=None, chunk: int = mref.CHUNK):
    """The backward kernel's three passes, from the forward's chunk-start
    ``states``: the same gradients as :func:`mamba_scan_bwd_ref`.  Pass A
    runs every chunk's adjoint back from 0, u_k = A_{t0} g_{t0}; pass B
    walks the chunks back, G_{C-1} = dh_final, G_{k-1} = exp(a sum_k
    delta) G_k + u_k, dh0 = exp(a sum_0 delta) G_0 + u_0; pass C runs
    every chunk forward from its start (its states) and back from G_k,
    with the gradients of each step; dB and dC sum over the channels, da
    over the batch and the chunks."""
    delta, x, a, bm, cm, dy = (t.float() for t in (delta, x, a, bm, cm, dy))
    b, s, d = delta.shape
    n = a.shape[1]
    dc, xc, bc, cc, gc = (_chunks(t, chunk)
                          for t in (delta, x, bm, cm, dy))
    nc = dc.shape[1]
    zero = torch.zeros((b, nc, d, n), device=delta.device)

    u = zero
    for r in range(chunk - 1, -1, -1):
        big_a = torch.exp(dc[:, :, r, :, None] * a)
        u = big_a * (gc[:, :, r, :, None] * cc[:, :, r, None, :] + u)
    decay = torch.exp(dc.sum(2)[..., None] * a)
    g_in = [None] * nc
    g = (torch.zeros((b, d, n), device=delta.device) if dh_final is None
         else dh_final.float())
    for k in range(nc - 1, -1, -1):
        g_in[k] = g
        g = decay[:, k] * g + u[:, k]
    dh0 = g

    h, hist = states, [states]
    for r in range(chunk):
        dt = dc[:, :, r, :, None]
        h = (torch.exp(dt * a) * h
             + dt * bc[:, :, r, None, :] * xc[:, :, r, :, None])
        hist.append(h)
    carry = torch.stack(g_in, 1)
    outs = {k: [None] * chunk for k in ("ddelta", "dx", "dbm", "dcm")}
    da = torch.zeros_like(zero)
    for r in range(chunk - 1, -1, -1):
        dt, xt = dc[:, :, r, :, None], xc[:, :, r, :, None]
        bt, ct = bc[:, :, r, None, :], cc[:, :, r, None, :]
        big_a = torch.exp(dt * a)
        g = gc[:, :, r, :, None] * ct + carry
        outs["dcm"][r] = (gc[:, :, r, :, None] * hist[r + 1]).sum(2)
        outs["dbm"][r] = (g * dt * xt).sum(2)
        outs["dx"][r] = (g * dt * bt).sum(-1)
        outs["ddelta"][r] = (g * (a * big_a * hist[r] + bt * xt)).sum(-1)
        da = da + g * dt * big_a * hist[r]
        carry = big_a * g
    ddelta, dx, dbm, dcm = (
        torch.stack(outs[k], 2).reshape(b, nc * chunk, -1)[:, :s]
        for k in ("ddelta", "dx", "dbm", "dcm"))
    return ddelta, dx, da.sum((0, 1)), dbm, dcm, dh0


# The backward kernel's gradient pass (``bwd_grads`` in the source): a
# forward run per chunk keeping each SUB-step sub-chunk's start state and
# dC, then each sub-chunk rerun with its decays A_t and A_t h_{t-1} kept
# and walked back with no exponential of its own; dB and dC come out per
# block of CHANNELS_PER_BLOCK channels and are summed over the blocks by
# the wrapper.
SUB = 8


def _block_sum(t: torch.Tensor, cpb: int) -> torch.Tensor:
    """(..., D, N) -> (..., N): summed over each block of ``cpb`` channels
    (the last one ragged), then over the blocks."""
    d = t.shape[-2]
    pad = -d % cpb
    if pad:
        t = torch.cat([t, t.new_zeros((*t.shape[:-2], pad, t.shape[-1]))],
                      -2)
    return t.reshape(*t.shape[:-2], -1, cpb, t.shape[-1]).sum(-2).sum(-2)


def mamba_scan_bwd_subchunk_ref(delta, x, a, bm, cm, dy, states,
                                dh_final=None, chunk: int = mref.CHUNK,
                                sub: int = SUB,
                                cpb: int = mk.CHANNELS_PER_BLOCK):
    """The backward kernel's algebra: passes A and B as
    :func:`mamba_scan_bwd_chunked_ref`'s; pass C runs every chunk forward
    from its start (h = A h + B (delta x)), keeping h at each sub-chunk's
    start and dC_t = sum_c dy_t h_t, then each sub-chunk, last first,
    again with A_t and Q_t = A_t h_{t-1} kept, walked back: g = dy C +
    carry, ddelta = sum_n g (a Q + B x), dx = delta sum_n g B, da += (g
    delta) Q, carry = A g, dB_t = sum_c g (delta x); dB and dC summed per
    block of ``cpb`` channels, then over the blocks."""
    delta, x, a, bm, cm, dy = (t.float() for t in (delta, x, a, bm, cm, dy))
    b, s, d = delta.shape
    n = a.shape[1]
    dc, xc, bc, cc, gc = (_chunks(t, chunk)
                          for t in (delta, x, bm, cm, dy))
    nc = dc.shape[1]
    u = torch.zeros((b, nc, d, n))
    for r in range(chunk - 1, -1, -1):
        big_a = torch.exp(dc[:, :, r, :, None] * a)
        u = big_a * (gc[:, :, r, :, None] * cc[:, :, r, None, :] + u)
    decay = torch.exp(dc.sum(2)[..., None] * a)
    g_in = [None] * nc
    g = torch.zeros((b, d, n)) if dh_final is None else dh_final.float()
    for k in range(nc - 1, -1, -1):
        g_in[k] = g
        g = decay[:, k] * g + u[:, k]
    dh0 = g

    def step(h, r):
        dt = dc[:, :, r, :, None]
        big_a = torch.exp(dt * a)
        q = big_a * h
        return big_a, q, q + bc[:, :, r, None, :] * (dt * xc[:, :, r, :,
                                                                  None])
    h, starts = states, []
    dcm, dbm = [None] * chunk, [None] * chunk
    for r in range(chunk):
        if r % sub == 0:
            starts.append(h)
        h = step(h, r)[2]
        dcm[r] = _block_sum(gc[:, :, r, :, None] * h, cpb)
    carry = torch.stack(g_in, 1)
    dd, dxs = [None] * chunk, [None] * chunk
    da = torch.zeros((b, nc, d, n))
    for q0 in range(chunk - sub, -1, -sub):
        h, kept = starts[q0 // sub], []
        for r in range(q0, q0 + sub):
            big_a, q, h = step(h, r)
            kept.append((big_a, q))
        for r in range(q0 + sub - 1, q0 - 1, -1):
            big_a, q = kept[r - q0]
            dt, xt = dc[:, :, r, :, None], xc[:, :, r, :, None]
            bt = bc[:, :, r, None, :]
            g = gc[:, :, r, :, None] * cc[:, :, r, None, :] + carry
            dd[r] = (g * (a * q + bt * xt)).sum(-1)
            dxs[r] = dt[..., 0] * (g * bt).sum(-1)
            da = da + (g * dt) * q
            carry = big_a * g
            dbm[r] = _block_sum(g * (dt * xt), cpb)
    ddelta, dx, dbm, dcm = (
        torch.stack(t, 2).reshape(b, nc * chunk, -1)[:, :s]
        for t in (dd, dxs, dbm, dcm))
    return ddelta, dx, da.sum((0, 1)), dbm, dcm, dh0


@pytest.mark.parametrize("s,d,n", [(13, 200, 16), (64, 128, 8),
                                   (150, 200, 16), (150, 72, 8)])
def test_subchunk_algebra_matches_the_step_loop(s, d, n):
    """The backward kernel's sub-chunks, kept decays and per-block dB/dC
    partials (a ragged last chunk, a ragged last channel block, D under
    one block): every gradient within 1e-5 of its largest of the reverse
    step loop's."""
    delta, a, bm, cm, x, h0 = (torch.from_numpy(t) for t in _scan_inputs(
        2, s, d, n, 30 + s + n))
    args = (delta, x, a, bm, cm, h0)
    _, _, states = mamba_scan_chunked_ref(*args)
    gen = torch.Generator().manual_seed(s + d)
    dy = torch.randn((2, s, d), generator=gen)
    for dh in (torch.randn((2, d, n), generator=gen), None):
        want = mref.mamba_scan_bwd_ref(*args, dy, dh)
        got = mamba_scan_bwd_subchunk_ref(*args[:5], dy, states, dh)
        for g, w in zip(got, want):
            _within(g, w.numpy(), GRAD_TOL)


def test_backward_constants_match_the_source():
    """The source's chunk, sub-chunk and channel block are the ones the
    wrapper and the models above take."""
    import re
    text = mk.SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text)[1])
    assert const("kChunk") == mref.CHUNK
    assert const("kSub") == SUB
    assert const("kCh") * const("kPasses") == mk.CHANNELS_PER_BLOCK
    assert "constexpr int kCpb = kCh * kPasses;" in text


@pytest.mark.parametrize("n", [8, 16])
@pytest.mark.parametrize("s", [13, 37, 64])
def test_trainable_grads_match_jax_vjp(s, n):
    delta, a, bm, cm, x, h0 = _scan_inputs(2, s, 12, n, 100 + s + n)
    rng = np.random.default_rng(s * n)
    gy = rng.normal(size=delta.shape).astype(np.float32)
    gh = rng.normal(size=h0.shape).astype(np.float32)
    chunk = pick_chunk(s, target_iters=16, max_chunk=2048)
    (jy, jh), pullback = jax.vjp(
        jax.jit(functools.partial(jmamba._ssm_scan, chunk=chunk)),
        *(jnp.asarray(t) for t in (delta, a, bm, cm, x, h0)))
    jd, ja, jb, jc, jx, jh0 = pullback((jnp.asarray(gy), jnp.asarray(gh)))
    leaves = [torch.from_numpy(t).requires_grad_()
              for t in (delta, x, a, bm, cm, h0)]
    before = mk.BWD_LAUNCHES
    y, h = ops.mamba_scan_trainable(*leaves)
    grads = torch.autograd.grad((y, h), leaves, (torch.from_numpy(gy),
                                                 torch.from_numpy(gh)))
    assert mk.BWD_LAUNCHES == before
    _within(y.detach(), jy, SCAN_TOL)
    for name, got, want in zip(("delta", "x", "a", "bm", "cm", "h0"), grads,
                               (jd, jx, ja, jb, jc, jh0)):
        assert got.shape == leaves[0].shape or got.dtype == torch.float32
        _within(got, want, GRAD_TOL)


@pytest.mark.parametrize("with_dh", [True, False])
def test_bwd_ref_matches_autograd_of_the_step_loop(with_dh):
    """The reverse-time loop against autograd through the forward loop;
    without ``dh_final`` the final state takes no gradient."""
    delta, a, bm, cm, x, h0 = (torch.from_numpy(t) for t in _scan_inputs(
        2, 41, 10, 8, 7))
    leaves = [t.clone().requires_grad_() for t in (delta, x, a, bm, cm, h0)]
    y, h = mamba_scan_ref(*leaves)
    gen = torch.Generator().manual_seed(8)
    dy = torch.randn(y.shape, generator=gen)
    dh = torch.randn(h.shape, generator=gen) if with_dh else None
    outs, gouts = ((y, h), (dy, dh)) if with_dh else ((y,), (dy,))
    want = torch.autograd.grad(outs, leaves, gouts)
    got = mref.mamba_scan_bwd_ref(delta, x, a, bm, cm, h0, dy, dh)
    for g, w in zip(got, want):
        _within(g, w.numpy(), GRAD_TOL)


@pytest.mark.parametrize("s", [1, 63, 64, 150])
def test_chunked_algebra_matches_the_step_loops(s):
    """The kernels' chunks (64 steps, a ragged last one) run from zero and
    combined by each chunk's decay: y, the final state and every gradient
    as the step loops give them; the chunk-start states are the loop's
    states at each chunk's first step."""
    delta, a, bm, cm, x, h0 = (torch.from_numpy(t) for t in _scan_inputs(
        2, s, 10, 16, 9 + s))
    args = (delta, x, a, bm, cm, h0)
    y, h = mamba_scan_ref(*args)
    cy, ch, states = mamba_scan_chunked_ref(*args)
    assert states.shape == (2, -(-s // mref.CHUNK), 10, 16)
    _within(cy, y.numpy(), SCAN_TOL)
    _within(ch, h.numpy(), SCAN_TOL)
    _within(states[:, 0], h0.numpy(), 0.0)
    if s > mref.CHUNK:
        _, h64 = mamba_scan_ref(*(t[:, :mref.CHUNK] for t in args[:5]), h0)
        _within(states[:, 1], h64.numpy(), SCAN_TOL)
    gen = torch.Generator().manual_seed(s)
    dy, dh = torch.randn(y.shape, generator=gen), torch.randn(
        h.shape, generator=gen)
    want = mref.mamba_scan_bwd_ref(*args, dy, dh)
    got = mamba_scan_bwd_chunked_ref(*args[:5], dy, states, dh)
    for g, w in zip(got, want):
        _within(g, w.numpy(), GRAD_TOL)


def test_layer_train_mode_goes_through_the_trainable_op(layer_pair,
                                                         monkeypatch):
    """Train mode under autograd calls ``mamba_scan_trainable`` once and
    gives every parameter a gradient; prefill keeps ``mamba_scan``."""
    _, _, cfg, layer = layer_pair
    calls = {"trainable": 0, "plain": 0}
    real_t, real_p = mamba.mamba_scan_trainable, mamba.mamba_scan

    def trainable(*a):
        calls["trainable"] += 1
        return real_t(*a)

    def plain(*a):
        calls["plain"] += 1
        return real_p(*a)

    monkeypatch.setattr(mamba, "mamba_scan_trainable", trainable)
    monkeypatch.setattr(mamba, "mamba_scan", plain)
    x = torch.from_numpy(np.random.default_rng(10).normal(
        size=(2, 9, cfg.d_model)).astype(np.float32))
    layer(x, mode="train", state=None).square().sum().backward()
    assert calls == {"trainable": 1, "plain": 0}
    assert all(p.grad is not None and p.grad.abs().max() > 0
               for p in layer.parameters())
    layer.zero_grad()
    with torch.no_grad():
        layer(x, mode="prefill", state=None)
    assert calls == {"trainable": 1, "plain": 1}
