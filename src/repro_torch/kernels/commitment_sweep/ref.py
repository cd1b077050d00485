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


#: Candidates per tile of the bucketed algebra (the CUDA kernel's kTile):
#: each tile buckets the whole row against its own sorted candidates.
CANDIDATE_TILE = 128
#: Every fixed-point term stays below 2**TERM_BITS, so that a term is one
#: 32-bit word and any T < 2**31 hours sum well inside int64.
TERM_BITS = 31
_MIN_SHIFT, _MAX_SHIFT = -1022, 1000


def _shift(bound: torch.Tensor) -> torch.Tensor:
    """Per-row power of two s with bound * 2**s < 2**TERM_BITS."""
    exponent = torch.frexp(bound).exponent.to(torch.int64)
    return (TERM_BITS - exponent).clamp(_MIN_SHIFT, _MAX_SHIFT)


def _pow2(s: torch.Tensor) -> torch.Tensor:
    """float64 2**s from its bits (s within the normal range): exact on
    every device, where a library power may round."""
    return ((s + 1023) << 52).view(torch.float64)


def _fixed(x: torch.Tensor) -> torch.Tensor:
    """float64 -> int64, rounded half to even (the kernel's __double2ll_rn)."""
    return torch.round(x).to(torch.int64)


def _reverse_cumsum(x: torch.Tensor) -> torch.Tensor:
    return x.flip(-1).cumsum(-1).flip(-1)


def commitment_sweep_bucketed_ref(
    f: torch.Tensor,
    w: torch.Tensor,
    cs: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernel's algebra in plain PyTorch, bit for bit: f, w (P, T),
    cs (P, G) -> (over, under), each (P, G) float32.

    Per tile of CANDIDATE_TILE candidates, sorted ascending (stably), each
    hour with w != 0 falls in bucket k = #(candidates < f) and adds three
    terms there, each of one sign: W[k] += w, S1[k] += w (f - c[k-1]),
    S2[k] += w (c[k] - f).  The terms are rounded to fixed point at a
    per-row power of two (weights at 2**sw, the rest at 2**s) chosen from
    the row's largest |w| and the range of its f and candidates, so that
    every term stays below 2**31, and summed in int64, where T < 2**31
    hours cannot overflow.  Integer sums are exact, so the result does not
    depend on the order in which hours arrive.  Then, with the tile's sorted candidates c:

        over[j]  = sum_{k>j} S1[k] + sum_{i=j}^{G-2} (c[i+1]-c[i]) W(>i+1)
        under[j] = sum_{k<=j} S2[k] + sum_{i=1}^{j} (c[i]-c[i-1]) W(<i)

    each product rounded to the same fixed point; the integer over and
    under are scaled back in float64 and rounded to float32 once.  A row
    holding a non-finite f, w or candidate gives NaN in every column."""
    f = f.to(torch.float32)
    w = w.to(torch.float32)
    cs = cs.to(torch.float32)
    p, g = cs.shape
    over = torch.empty((p, g), dtype=torch.float32, device=f.device)
    under = torch.empty_like(over)
    if p == 0 or g == 0:
        return over, under
    nz = w != 0
    # one neutral column each, so that a row of no hours reduces too
    inf = torch.full((p, 1), float("inf"), device=f.device)
    wmax = torch.cat([torch.where(nz, w.abs(), 0.0), torch.zeros_like(inf)],
                     -1).amax(-1, True)
    fmin = torch.cat([torch.where(nz, f, inf), inf], -1).amin(-1, True)
    fmax = torch.cat([torch.where(nz, f, -inf), -inf], -1).amax(-1, True)
    lo = torch.minimum(fmin, cs.amin(-1, keepdim=True)).double()
    hi = torch.maximum(fmax, cs.amax(-1, keepdim=True)).double()
    s = _shift(wmax.double() * (hi - lo))
    sw = _shift(wmax.double())
    scale, inv = _pow2(s), _pow2(-s)
    scale_w, inv_w = _pow2(sw), _pow2(-sw)
    bad = ~(torch.isfinite(f).all(-1, keepdim=True)
            & torch.isfinite(w).all(-1, keepdim=True)
            & torch.isfinite(cs).all(-1, keepdim=True))
    nan = torch.full((), float("nan"), device=f.device)

    fd, wd = f.double(), w.double()
    zero = torch.zeros((), dtype=torch.int64, device=f.device)
    w_term = torch.where(nz, _fixed(wd * scale_w), zero)
    for g0 in range(0, g, CANDIDATE_TILE):
        c, order = torch.sort(cs[:, g0:g0 + CANDIDATE_TILE], dim=-1,
                              stable=True)
        gt = c.shape[1]
        cd = c.double()
        k = torch.searchsorted(c, f.contiguous(), side="left")    # (P, T)
        below = cd.gather(1, (k - 1).clamp(min=0))
        above = cd.gather(1, k.clamp(max=gt - 1))
        s1_term = torch.where(nz & (k > 0),
                              _fixed(((fd - below) * wd) * scale), zero)
        s2_term = torch.where(nz & (k < gt),
                              _fixed(((above - fd) * wd) * scale), zero)
        buckets = torch.zeros((3, p, gt + 1), dtype=torch.int64,
                              device=f.device)
        buckets[0].scatter_add_(1, k, w_term)
        buckets[1].scatter_add_(1, k, s1_term)
        buckets[2].scatter_add_(1, k, s2_term)
        w_above = _reverse_cumsum(buckets[0])          # W(>=k), (P, gt+1)
        w_below = w_above[:, :1] - w_above             # W(<k)
        gap = cd[:, 1:] - cd[:, :-1]                   # (P, gt-1)
        p_over = _fixed((gap * (w_above[:, 2:].double() * inv_w)) * scale)
        p_under = _fixed((gap * (w_below[:, 1:gt].double() * inv_w)) * scale)
        over_i = (_reverse_cumsum(buckets[1][:, 1:])
                  + torch.cat([_reverse_cumsum(p_over), zero.expand(p, 1)],
                              -1))
        under_i = (buckets[2][:, :gt].cumsum(-1)
                   + torch.cat([zero.expand(p, 1), p_under.cumsum(-1)], -1))
        o = (over_i.double() * inv).float()
        u = (under_i.double() * inv).float()
        o = torch.where(bad, nan, o)
        u = torch.where(bad, nan, u)
        over[:, g0:g0 + gt] = torch.empty_like(o).scatter_(1, order, o)
        under[:, g0:g0 + gt] = torch.empty_like(u).scatter_(1, order, u)
    return over, under
