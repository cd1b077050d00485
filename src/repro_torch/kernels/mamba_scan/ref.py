"""Plain PyTorch versions of Mamba's selective scan and of its backward:
the specs the CUDA kernels are held to, and the CPU path.

For every batch row b, channel c and state n, from ``h0`` and for t in
order (the reference's ``repro.models.mamba._ssm_scan``):

    h[b, c, n] = exp(delta[b, t, c] * a[c, n]) * h[b, c, n]
                 + delta[b, t, c] * bm[b, t, n] * x[b, t, c]
    y[b, t, c] = sum_n cm[b, t, n] * h[b, c, n]

:func:`mamba_scan_ref` is a step loop over the sequence, in float32.  The
reference runs the same recurrence as an associative scan within chunks
of ``pick_chunk(S)`` steps, so the two agree to float32 rounding, not bit
for bit.  :func:`mamba_scan_bwd_ref` is the backward as an explicit
reverse-time loop (the reference gets it by autodiff of the associative
scan).
"""

from __future__ import annotations

import torch

#: Steps per chunk of the CUDA kernels (``csrc/mamba_scan.cu``, kChunk).
CHUNK = 64


def mamba_scan_ref(delta: torch.Tensor, x: torch.Tensor, a: torch.Tensor,
                   bm: torch.Tensor, cm: torch.Tensor,
                   h0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """delta, x (B, S, D); a (D, N); bm, cm (B, S, N); h0 (B, D, N) ->
    (y (B, S, D), the final h (B, D, N)), float32."""
    delta, x, a, bm, cm = (t.float() for t in (delta, x, a, bm, cm))
    h = h0.float().clone()
    ys = []
    for t in range(delta.shape[1]):
        da = torch.exp(delta[:, t, :, None] * a[None])
        bx = delta[:, t, :, None] * bm[:, t, None, :] * x[:, t, :, None]
        h = da * h + bx
        ys.append((cm[:, t, None, :] * h).sum(-1))
    y = (torch.stack(ys, 1) if ys
         else delta.new_zeros(delta.shape))
    return y, h


def mamba_scan_bwd_ref(delta, x, a, bm, cm, h0, dy,
                       dh_final: torch.Tensor | None = None):
    """Gradients of :func:`mamba_scan_ref` for the output gradients ``dy``
    (B, S, D) and ``dh_final`` (B, D, N) or None (the final state unused):
    (ddelta, dx (B, S, D), da (D, N), dbm, dcm (B, S, N), dh0 (B, D, N)),
    float32.

    With A_t = exp(delta_t a) and g_t the adjoint of h_t, from the last
    step back: g_{S-1} = dy_{S-1} C_{S-1} + dh_final, g_{t-1} = dy_{t-1}
    C_{t-1} + A_t g_t; then dC_t[n] = sum_c dy_t[c] h_t[c, n], dB_t[n] =
    sum_c g_t delta_t x_t, dx_t[c] = sum_n g_t delta_t B_t,
    ddelta_t[c] = sum_n g_t (a A_t h_{t-1} + B_t x_t), da = sum_{b, t}
    g_t delta_t A_t h_{t-1} and dh0 = A_0 g_0.  The forward states are
    kept whole ((B, S, D, N) float32): a spec, not a path."""
    delta, x, a, bm, cm, dy = (t.float() for t in (delta, x, a, bm, cm, dy))
    b, s, d = delta.shape
    n = a.shape[1]
    hs = [h0.float()]
    for t in range(s):
        da_t = torch.exp(delta[:, t, :, None] * a[None])
        hs.append(da_t * hs[-1]
                  + delta[:, t, :, None] * bm[:, t, None, :]
                  * x[:, t, :, None])
    carry = (torch.zeros((b, d, n), device=delta.device) if dh_final is None
             else dh_final.float())
    ddelta, dx = torch.zeros_like(delta), torch.zeros_like(x)
    dbm, dcm = torch.zeros_like(bm), torch.zeros_like(cm)
    da = torch.zeros_like(a)
    for t in range(s - 1, -1, -1):
        dt = delta[:, t, :, None]                          # (B, D, 1)
        big_a = torch.exp(dt * a[None])                    # (B, D, N)
        g = dy[:, t, :, None] * cm[:, t, None, :] + carry
        h_prev = hs[t]
        dcm[:, t] = (dy[:, t, :, None] * hs[t + 1]).sum(1)
        dbm[:, t] = (g * dt * x[:, t, :, None]).sum(1)
        dx[:, t] = (g * dt * bm[:, t, None, :]).sum(-1)
        ddelta[:, t] = (g * (a[None] * big_a * h_prev
                             + bm[:, t, None, :] * x[:, t, :, None])).sum(-1)
        da += (g * dt * big_a * h_prev).sum(0)
        carry = big_a * g
    return ddelta, dx, da, dbm, dcm, carry
