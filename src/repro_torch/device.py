"""Device resolution for the planner's entry points.

``device=None`` means the card.  Without a usable CUDA device that is an
error, never a silent switch to the CPU: a CPU run has to be asked for with
``device="cpu"`` (the tests do), so a plan that was meant for the card
cannot quietly run the kernels' plain versions instead.
"""

from __future__ import annotations

import torch

_NO_CUDA = (
    "no CUDA device is available; pass device=\"cpu\" to run the planner "
    "on the CPU with the plain PyTorch versions of its kernels"
)


def resolve_device(device: "torch.device | str | None" = None) -> torch.device:
    """The device a planner call runs on: ``None`` -> ``cuda``.

    Raises ``RuntimeError`` when CUDA is asked for (explicitly or by
    default) and no CUDA device exists, ``ValueError`` for any device type
    other than ``cuda`` and ``cpu``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(
            f"unsupported device {dev}; the planner runs on 'cuda' or 'cpu'"
        )
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(_NO_CUDA)
    return dev
