"""Array helpers whose float32 results must match the reference's.

``torch.linspace`` and ``jnp.linspace`` round differently (torch fills the
upper half of the range backwards from ``stop``), and the planner's grids
and changepoints are linspaces: candidate levels snap to them, so a
one-ulp difference moves a threshold.  :func:`linspace` reproduces, bit for
bit, what ``jnp.linspace`` returns when it runs eagerly on the CPU, as the
rolling replay's ``prefix_fit_state`` calls it.  It is built from
device-side fills and arithmetic only, so calling it inside the replay's
weekly loop copies nothing from the host.
"""

from __future__ import annotations

import numpy as np
import torch


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` with one rounding: the float64 product of two
    float32s is exact, so only the sum rounds before the cast back."""
    return (a.double() * b.double() + c.double()).float()


def _scalar(x, device) -> torch.Tensor:
    """A 0-d float32 tensor of ``x``; a Python float becomes a device-side
    fill, not a copy from the host."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.full((), float(np.float32(x)), dtype=torch.float32,
                      device=device)


def linspace(
    start, stop, num: int, *, device=None
) -> torch.Tensor:
    """(num,) float32 evenly spaced from ``start`` to ``stop`` inclusive.
    ``start`` and ``stop`` are Python floats or 0-d tensors on ``device``
    (the tensor form reads nothing back to the host).

    The reference computes ``start * (1 - i/div) + stop * (i/div)``; its
    CPU compiler turns ``i/div`` into ``i * r`` with ``r`` the float32
    reciprocal of ``div``, reassociates ``stop * (i * r)`` into
    ``(stop * r) * i`` and contracts the sum into a fused multiply-add:
    ``fma(stop * r, i, start * (1 - i * r))``, except at ``i == 1``, where
    the product by 1 folds away and the other product is fused,
    ``fma(start, 1 - r, stop * r)``.  ``stop`` is appended exactly.  On
    the [0, 1] grids every form reduces to ``i * r``; a traced
    ``jnp.linspace`` is folded by XLA without the contraction and may
    differ by an ulp from the eager one."""
    a, b = _scalar(start, device), _scalar(stop, device)
    if num < 2:
        return a.expand(num).clone()
    div = num - 1
    recip = float(np.float32(1.0) / np.float32(div))
    i = torch.arange(div, dtype=torch.float32, device=device)
    one_minus = 1 - i * recip
    b_r = (b * recip).expand_as(i)
    head = torch.where(
        i == 1,
        _fma(a.expand_as(i), one_minus, b_r),
        _fma(b_r, i, a * one_minus),
    )
    return torch.cat([head, b.reshape(1)])
