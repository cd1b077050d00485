"""Array helpers whose float32 results must match the reference's.

``torch.linspace`` and ``jnp.linspace`` round differently (torch fills the
upper half of the range backwards from ``stop``), and the planner's grids
and changepoints are linspaces: candidate levels snap to them, so a
one-ulp difference moves a threshold.  :func:`linspace` reproduces the
reference's formula, ``start * (1 - i/div) + stop * (i/div)`` in float32
with ``stop`` appended exactly; it equals ``jnp.linspace`` bit for bit on
the [0, 1] grids of the solvers and fractiles, and to an ulp elsewhere.
It is built from device-side fills and arithmetic only, so calling it
inside the replay's weekly loop copies nothing from the host.
"""

from __future__ import annotations

import numpy as np
import torch


def linspace(
    start: float, stop: float, num: int, *, device=None
) -> torch.Tensor:
    """(num,) float32 evenly spaced from ``start`` to ``stop`` inclusive."""
    if num < 2:
        return torch.full((num,), start, dtype=torch.float32, device=device)
    div = num - 1
    # i/div as the reference's compiler emits it: times the float32
    # reciprocal of div
    recip = float(np.float32(1.0) / np.float32(div))
    step = torch.arange(div, dtype=torch.float32, device=device) * recip
    head = start * (1 - step) + stop * step
    tail = torch.full((1,), stop, dtype=torch.float32, device=device)
    return torch.cat([head, tail])
