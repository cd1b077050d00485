"""Plain PyTorch versions of the RWKV6 linear recurrence — the spec the
CUDA kernels are held to.

Per head, with state S in R^{dk x dv}, data-dependent decay w_t in (0,1]^dk
and bonus u in R^dk:

    y_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T

:func:`rwkv6_ref` is the step-by-step loop (the reference's ``lax.scan``
oracle).  :func:`rwkv6_chunked_ref` is the chunked form, chunk after chunk,
from log-decays; the CPU path of ``ops`` runs it.
:func:`rwkv6_chunk_parallel_ref` is the same algebra in the order the CUDA
kernels run it: every chunk's own output, state increment and total decay
at once, then the scan of the states over the chunks, then each chunk's
output from the state entering it.

Every decay is the exponential of a sum of logw over a stretch of steps,
so no exponent is positive and none overflows, however strong the decay
(the factored r*exp(cum) / k*exp(-cum) form would overflow float32).  Each
such sum is taken directly over its stretch, never as the difference of
two prefix sums from the chunk's start: at the model's strongest decays
(logw down to -e^10) those prefix sums reach ~1e4-1e5, where a float32 ulp
is ~1e-3-1e-2, and their difference for a short stretch would carry that
error into the exponent.
"""

from __future__ import annotations

import torch


def rwkv6_ref(r, k, v, w, u, state=None):
    """r, k, w (B, H, T, dk), v (B, H, T, dv), u (H, dk), state
    (B, H, dk, dv) or None -> (y (B, H, T, dv), final state), float32."""
    b, h, t, dk = r.shape
    dv = v.shape[-1]
    r, k, v, w, u = (x.float() for x in (r, k, v, w, u))
    s = (torch.zeros(b, h, dk, dv, device=r.device) if state is None
         else state.float().clone())
    ys = []
    for i in range(t):
        kv = k[:, :, i, :, None] * v[:, :, i, None, :]
        att = s + u[None, :, :, None] * kv
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, :, i], att))
        s = w[:, :, i, :, None] * s + kv
    y = torch.stack(ys, 2) if ys else v.new_zeros(b, h, 0, dv).float()
    return y, s


def _exclusive_cumsum(x):
    """Sum over the steps before each step, along dim -2."""
    return torch.cat([torch.zeros_like(x[..., :1, :]), x[..., :-1, :]],
                     -2).cumsum(-2)


def chunk_decays(logw):
    """Decays of chunks of log-decays ``logw`` (..., L, dk), each the exp of
    a sum of logw over a stretch, summed directly:

    - ``pre`` (..., L, dk): exp(sum_{j<t} logw_j), from the chunk's start;
    - ``suf`` (..., L, dk): exp(sum_{j>s} logw_j), to the chunk's end;
    - ``total`` (..., dk): exp(sum_j logw_j);
    - ``between`` (..., L, L, dk): exp(sum_{s<j<t} logw_j) at [t, s] for
      s < t, else 0 (the strictly causal intra-chunk decays).
    """
    n = logw.shape[-2]
    j = torch.arange(n, device=logw.device)
    t_, s_ = j[:, None, None], j[None, :, None]
    inside = ((j[None, None, :] > s_) & (j[None, None, :] < t_)).to(logw.dtype)
    stretch = torch.einsum("tsj,...jd->...tsd", inside, logw)
    strict = (j[:, None] > j[None, :])[..., None]
    return (_exclusive_cumsum(logw).exp(),
            _exclusive_cumsum(logw.flip(-2)).flip(-2).exp(),
            logw.sum(-2).exp(),
            stretch.masked_fill(~strict, float("-inf")).exp())


def _pad_chunks(t, chunk, *xs):
    """Pad the time axis (dim 2) to a multiple of ``chunk`` with zeros:
    r = k = v = 0 and logw = 0 leave y and the state as they are."""
    tp = -(-t // chunk) * chunk
    if tp == t:
        return xs
    return tuple(torch.nn.functional.pad(x, (0, 0, 0, tp - t)) for x in xs)


def rwkv6_chunked_ref(r, k, v, logw, u, state=None, *, chunk: int = 32):
    """The chunked form, (B, H, T, .) layout, ``logw <= 0``; T need not be
    a multiple of ``chunk`` (the last chunk is padded, see
    :func:`_pad_chunks`).  Returns (y (B, H, T, dv), final state
    (B, H, dk, dv)), float32."""
    b, h, t, dk = r.shape
    dv = v.shape[-1]
    r, k, v, logw, u = (x.float() for x in (r, k, v, logw, u))
    s = (torch.zeros(b, h, dk, dv, device=r.device) if state is None
         else state.float())
    r, k, v, logw = _pad_chunks(t, chunk, r, k, v, logw)
    ys = []
    for c0 in range(0, r.shape[2], chunk):
        rc, kc, vc, lc = (x[:, :, c0:c0 + chunk] for x in (r, k, v, logw))
        pre, suf, total, between = chunk_decays(lc)
        y = torch.einsum("bhti,bhij->bhtj", rc * pre, s)
        att = torch.einsum("bhti,bhsi,bhtsi->bhts", rc, kc, between)
        diag = (rc * u[None, :, None, :] * kc).sum(-1)
        ys.append(y + att @ vc + diag[..., None] * vc)
        s = total[..., None] * s + (kc * suf).transpose(2, 3) @ vc
    y = torch.cat(ys, 2)[:, :, :t] if ys else v.new_zeros(b, h, 0, dv)
    return y, s


def rwkv6_chunk_parallel_ref(r, k, v, logw, u, state=None, *,
                             chunk: int = 32):
    """The chunk-parallel order of the CUDA kernels, (B, H, T, .) layout,
    ``logw <= 0``, T ragged as in :func:`rwkv6_chunked_ref`:

    1. per chunk c, all at once: its own output (the strictly causal decay
       term and the bonus), its state increment
       dS_c = sum_s (k_s * exp(sum_{j>s} logw_j)) (x) v_s and its total
       decay exp(sum_j logw_j);
    2. the scan S_c = total_c * S_{c-1} + dS_c from the initial state,
       keeping the state entering each chunk;
    3. each chunk's output += (r_t * exp(sum_{j<t} logw_j)) . S_entering.

    Returns (y (B, H, T, dv), final state (B, H, dk, dv), the states
    entering the chunks (B, H, C, dk, dv)), float32.  Used by the tests and
    the smoke run, never by the port."""
    b, h, t, dk = r.shape
    dv = v.shape[-1]
    r, k, v, logw, u = (x.float() for x in (r, k, v, logw, u))
    s = (torch.zeros(b, h, dk, dv, device=r.device) if state is None
         else state.float())
    r, k, v, logw = _pad_chunks(t, chunk, r, k, v, logw)
    n = r.shape[2] // chunk
    rc, kc, vc, lc = (x.reshape(b, h, n, chunk, x.shape[-1])
                      for x in (r, k, v, logw))
    pre, suf, total, between = chunk_decays(lc)
    att = torch.einsum("bhcti,bhcsi,bhctsi->bhcts", rc, kc, between)
    diag = (rc * u[None, :, None, None, :] * kc).sum(-1)
    y = att @ vc + diag[..., None] * vc
    d_state = (kc * suf).transpose(3, 4) @ vc
    entering = []
    for c in range(n):
        entering.append(s)
        s = total[:, :, c, :, None] * s + d_state[:, :, c]
    entering = (torch.stack(entering, 2) if entering
                else r.new_zeros(b, h, 0, dk, dv))
    y = y + torch.einsum("bhcti,bhcij->bhctj", rc * pre, entering)
    return y.reshape(b, h, n * chunk, dv)[:, :, :t], s, entering
