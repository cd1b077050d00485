"""Structured accounting of the CUDA commitment-sweep launch.

The JAX package's record describes the Pallas tile its block planner picks
against an on-chip memory budget.  The CUDA kernel has no such plan: it
launches one block of ``THREADS`` threads per (row, tile of
``CANDIDATE_TILE`` candidates) with a fixed amount of static shared
memory, whatever the shape.  So :class:`KernelStats` here records that
launch: the grid, the block, its shared memory, the bytes the sweep must
move (each input read once, each output written once: the bound the
kernel's time is held to) and an operation estimate on the reference's
convention, 4 P T G (an over/under compare and accumulate per cell).

Every number comes from the wrapper's own constants
(``kernels.commitment_sweep.commitment_sweep``), so the record cannot
drift from the launch.  It is a host-side function of (p, g, t): it
imports no CUDA and runs nothing.
"""

from __future__ import annotations

import dataclasses

from repro_torch.kernels.commitment_sweep import commitment_sweep as _ck


@dataclasses.dataclass(frozen=True)
class KernelStats:
    """One commitment-sweep launch."""

    kernel: str                    # kernel name, "commitment_sweep"
    p: int                         # rows (pools, or pools x horizon weeks)
    g: int                         # candidate-grid levels
    t: int                         # trace hours
    grid: tuple[int, int]          # (rows, candidate tiles) blocks
    threads_per_block: int
    shared_bytes_per_block: int    # static shared memory of one block
    bytes_moved: int               # f, w read once; cs, over, under once
    flops: int                     # estimate, reference convention 4 P T G

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1]

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["grid"] = list(d["grid"])
        d["blocks"] = self.blocks
        return d


def sweep_kernel_stats(p: int, g: int, t: int) -> KernelStats:
    """Stats of the launch ``commitment_sweep_cuda`` makes for f, w (p, t)
    and cs (p, g)."""
    tile = _ck.CANDIDATE_TILE
    return KernelStats(
        kernel="commitment_sweep",
        p=p, g=g, t=t,
        grid=(p, -(-g // tile)),
        threads_per_block=_ck.THREADS,
        shared_bytes_per_block=_ck.SHARED_BYTES,
        bytes_moved=4 * (2 * p * t + 3 * p * g),
        flops=4 * p * t * g,
    )
