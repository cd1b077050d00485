"""Architecture registry of the port: ``get(name)`` and ``reduced(name)``.

Each module holds the exact published config, copied from the JAX
package's registry, so all ten architectures resolve here.  The port
builds, serves and trains every one of them: the dense family (GQA:
stablelm-1.6b, internlm2-20b, phi3-medium-14b; MLA: minicpm3-4b), the MoE
family (granite-moe-1b-a400m, deepseek-v2-lite-16b), RWKV (rwkv6-3b), the
vlm (qwen2-vl-7b), audio (whisper-small) and hybrid (jamba-v0.1-52b)
families.  :func:`repro_torch.models.model.num_params` counts every one
of them from its shape tables.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs import (
    deepseek_v2_lite,
    granite_moe_1b,
    internlm2_20b,
    jamba_52b,
    minicpm3_4b,
    phi3_medium_14b,
    qwen2_vl_7b,
    rwkv6_3b,
    stablelm_1_6b,
    whisper_small,
)
from repro_torch.models.config import ModelConfig

ARCHS: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (
        stablelm_1_6b,
        minicpm3_4b,
        internlm2_20b,
        phi3_medium_14b,
        granite_moe_1b,
        deepseek_v2_lite,
        rwkv6_3b,
        whisper_small,
        jamba_52b,
        qwen2_vl_7b,
    )
}


def get(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def reduced(name: str) -> ModelConfig:
    """Small same-family config for CPU smoke tests: few layers, narrow
    width, tiny vocab/experts — structure preserved."""
    cfg = get(name)
    upd: dict = dict(
        num_layers=max(2, cfg.attn_layer_period or 2),
        d_model=128,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2),
        d_ff=256,
        vocab_size=512,
        max_seq=128,
    )
    if cfg.attention == "mla":
        upd.update(
            q_lora_rank=32 if cfg.q_lora_rank else 0,
            kv_lora_rank=32,
            qk_nope_dim=16,
            qk_rope_dim=8,
            v_head_dim=16,
            head_dim=24,
            num_kv_heads=4,
        )
    else:
        upd["head_dim"] = 32
    if cfg.num_experts:
        # capacity_factor = E/k makes the reduced config dropless, so cache
        # -consistency tests are exact (capacity dropping is shape-dependent).
        upd.update(num_experts=4, top_k=2, moe_d_ff=64,
                   moe_capacity_factor=2.0)
    if cfg.family == "ssm":
        upd.update(d_model=128, num_heads=4, num_kv_heads=4,
                   rwkv_head_size=32, rwkv_lora_decay=16, rwkv_lora_mix=8)
    if cfg.family == "hybrid":
        upd.update(num_layers=8, ssm_d_state=8, ssm_dt_rank=16)
    if cfg.family == "audio":
        upd.update(encoder_layers=2, encoder_seq=32)
    if cfg.mrope_sections is not None:
        # sections must sum to head_dim/2
        upd["mrope_sections"] = (4, 6, 6)
    return dataclasses.replace(cfg, **upd)
