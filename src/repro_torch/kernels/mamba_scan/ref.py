"""Plain PyTorch version of Mamba's selective scan: the spec the CUDA
kernel is held to, and the CPU path.

For every batch row b, channel c and state n, from ``h0`` and for t in
order (the reference's ``repro.models.mamba._ssm_scan``):

    h[b, c, n] = exp(delta[b, t, c] * a[c, n]) * h[b, c, n]
                 + delta[b, t, c] * bm[b, t, n] * x[b, t, c]
    y[b, t, c] = sum_n cm[b, t, n] * h[b, c, n]

A step loop over the sequence, in float32.  The reference runs the same
recurrence as an associative scan within chunks of ``pick_chunk(S)``
steps, so the two agree to float32 rounding, not bit for bit.
"""

from __future__ import annotations

import torch


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
