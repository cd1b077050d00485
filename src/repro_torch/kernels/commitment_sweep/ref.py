"""Plain PyTorch version of the commitment sweep — the spec the CUDA
kernel is held to.

Weighted two-sided commitment mismatch areas over a candidate grid:

    over [p, g] = sum_t w[p,t] * max(f[p,t] - c[p,g], 0)
    under[p, g] = sum_t w[p,t] * max(c[p,g] - f[p,t], 0)

and the classic cost combination a*over + b*under.  Candidate grids are
per-row (``cs (P, G)``); a shared 1-D grid is a broadcast of one row.  It
materializes the (P, G, T) difference, so callers at large shapes run it
over row chunks.
"""

from __future__ import annotations

import torch


def commitment_sweep_over_under_ref(
    f: torch.Tensor,
    w: torch.Tensor,
    cs: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """f, w: (P, T); cs: (P, G) -> (over, under), each (P, G) in float32."""
    f = f.to(torch.float32)
    w = w.to(torch.float32)
    cs = cs.to(torch.float32)
    diff = f[:, None, :] - cs[:, :, None]  # (P, G, T)
    wexp = w[:, None, :]
    over = (torch.clamp(diff, min=0.0) * wexp).sum(-1)
    under = (torch.clamp(-diff, min=0.0) * wexp).sum(-1)
    return over, under


def commitment_sweep_ref(
    f: torch.Tensor,
    w: torch.Tensor,
    cs: torch.Tensor,
    a: float = 2.1,
    b: float = 1.0,
) -> torch.Tensor:
    """f, w: (P, T); cs: (P, G) or (G,) -> (P, G) in float32."""
    if cs.dim() == 1:
        cs = cs[None, :].expand(f.shape[0], cs.shape[0])
    over, under = commitment_sweep_over_under_ref(f, w, cs)
    return a * over + b * under
