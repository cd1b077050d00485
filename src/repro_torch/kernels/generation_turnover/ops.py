"""Entry point of the turnover pass: dispatch by device.

A CUDA tensor goes to the hand-written kernel
(``generation_turnover.py``), a CPU tensor to the plain version
(``ref.py``), and nothing else is taken.  There is no fallback between the
two: on a CUDA tensor the kernel launches or the call raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.generation_turnover import (
    generation_turnover as _kernel,
)
from repro_torch.kernels.generation_turnover.ref import turnover_ref


def units(num_pools: int, src: list[int], dst: list[int], device):
    """(unit_rows (U, 2), unit_edge (U,)) int32 on ``device``, U = P - G:
    one unit per edge, (its source row, its successor row) with the edge's
    index, then one per pool on no edge, (its row, -1) with -1.  Raises
    unless every pool has at most one role: the units cover each pool once
    only because no pool is touched by two edges."""
    touched = src + dst
    if len(set(touched)) != len(touched):
        raise ValueError(
            "a pool is the source or successor of more than one edge, or "
            "both: the turnover pass needs one role per pool")
    if touched and not 0 <= min(touched) <= max(touched) < num_pools:
        raise ValueError(f"edge pool index outside [0, {num_pools})")
    lone = sorted(set(range(num_pools)) - set(touched))
    rows = [[s, d] for s, d in zip(src, dst)] + [[p, -1] for p in lone]
    edge = list(range(len(src))) + [-1] * len(lone)
    as_i32 = dict(dtype=torch.int32, device=device)
    return (torch.tensor(rows, **as_i32).reshape(-1, 2),
            torch.tensor(edge, **as_i32))


def turnover(
    base: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    inv_gain: torch.Tensor,
    midpoint_hours: torch.Tensor,
    rate_per_hour: torch.Tensor,
    sw_log: float,
) -> torch.Tensor:
    """base (P, T); src, dst (G,) pool indices; inv_gain, midpoint_hours,
    rate_per_hour (G,); ``sw_log`` the hourly software drift (a Python
    float, used as float32) -> the (P, T) float32 turned-over demand on
    ``base``'s device (see ``ref.py`` for the arithmetic)."""
    args = (base, src, dst, inv_gain, midpoint_hours, rate_per_hour)
    devices = {x.device for x in args}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on different devices: {devices}")
    if base.dim() != 2:
        raise ValueError(f"base must be (P, T), got {tuple(base.shape)}")
    if src.shape != dst.shape:
        raise ValueError("src and dst must have one entry per edge")
    dev = base.device
    f32 = [x.to(torch.float32).contiguous()
           for x in (base, inv_gain, midpoint_hours, rate_per_hour)]
    unit_rows, unit_edge = units(base.shape[0], src.tolist(), dst.tolist(),
                                 dev)
    if dev.type == "cuda":
        return _kernel.generation_turnover_cuda(
            f32[0], unit_rows, unit_edge, *f32[1:], sw_log)
    if dev.type == "cpu":
        if base.shape[-1] > 2**24:
            raise ValueError("hours must stay below 2^24")
        return turnover_ref(f32[0], src.long(), dst.long(), *f32[1:], sw_log)
    raise ValueError(f"no turnover pass for device {dev}")
