"""Mamba (selective SSM) block, Jamba's attention-free layer: its shape
table only.

The layer itself (the causal conv and the selective scan) is not ported
yet (ROADMAP Queue 1, item 16); :func:`mamba_specs` sizes its parameters
for :func:`repro_torch.models.model.num_params`, and the layer will build
on it.
"""

from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.params import Spec


def mamba_specs(cfg: ModelConfig) -> dict[str, Spec]:
    d, di = cfg.d_model, cfg.ssm_d_inner
    n, dc, dtr = cfg.ssm_d_state, cfg.ssm_d_conv, cfg.ssm_dt_rank
    f32 = torch.float32
    return {
        "in_proj": Spec((d, 2 * di), ("embed", "ff"), fan_in=d),
        "conv_w": Spec((dc, di), (None, "ff")),
        "conv_b": Spec((di,), ("ff",), init="zeros"),
        "x_proj": Spec((di, dtr + 2 * n), ("ff", None), fan_in=di),
        "dt_w": Spec((dtr, di), (None, "ff"), fan_in=dtr),
        "dt_b": Spec((di,), ("ff",), init="zeros", dtype=f32),
        "a_log": Spec((di, n), ("ff", "state"), init="zeros", dtype=f32),
        "d_skip": Spec((di,), ("ff",), init="ones", dtype=f32),
        "out_proj": Spec((di, d), ("ff", "embed"), fan_in=di),
    }
