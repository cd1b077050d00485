"""Plain PyTorch versions of the RWKV6 linear recurrence — the spec the
CUDA kernel is held to.

Per head, with state S in R^{dk x dv}, data-dependent decay w_t in (0,1]^dk
and bonus u in R^dk:

    y_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T

:func:`rwkv6_ref` is the step-by-step loop (the reference's ``lax.scan``
oracle).  :func:`rwkv6_chunked_ref` is the chunked form the kernel
computes, from log-decays, with every decay an exponential of a
non-positive log sum; the CPU path of ``ops`` runs it.
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


def rwkv6_chunked_ref(r, k, v, logw, u, state=None, *, chunk: int = 32):
    """The chunked form, (B, H, T, .) layout, ``logw <= 0``; T need not be
    a multiple of ``chunk``: the last chunk is padded with r = k = v = 0
    and logw = 0, which leaves y and the state as they are.  Returns
    (y (B, H, T, dv), final state (B, H, dk, dv)), float32."""
    b, h, t, dk = r.shape
    dv = v.shape[-1]
    r, k, v, logw, u = (x.float() for x in (r, k, v, logw, u))
    s = (torch.zeros(b, h, dk, dv, device=r.device) if state is None
         else state.float())
    tp = -(-t // chunk) * chunk
    if tp != t:
        pad = (0, 0, 0, tp - t)
        r, k, v, logw = (torch.nn.functional.pad(x, pad)
                         for x in (r, k, v, logw))
    strict = torch.ones(chunk, chunk, dtype=torch.bool,
                        device=r.device).tril(-1)
    ys = []
    for c0 in range(0, tp, chunk):
        rc, kc, vc, lc = (x[:, :, c0:c0 + chunk] for x in (r, k, v, logw))
        cum = lc.cumsum(2)                                   # inclusive
        cp = cum - lc                                        # exclusive
        y = torch.einsum("bhti,bhij->bhtj", rc * cp.exp(), s)
        decay = (cp[:, :, :, None] - cum[:, :, None, :]).masked_fill(
            ~strict[None, None, :, :, None], float("-inf")).exp()
        att = torch.einsum("bhti,bhsi,bhtsi->bhts", rc, kc, decay)
        diag = (rc * u[None, :, None, :] * kc).sum(-1)
        y = y + att @ vc + diag[..., None] * vc
        ys.append(y)
        total = cum[:, :, -1]                                # (B, H, dk)
        k_dec = kc * (total[:, :, None] - cum).exp()
        s = total.exp()[..., None] * s + k_dec.transpose(2, 3) @ vc
    y = torch.cat(ys, 2)[:, :, :t] if ys else v.new_zeros(b, h, 0, dv)
    return y, s
