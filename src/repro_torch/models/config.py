"""Unified model configuration covering all assigned architecture families.

The port's own copy of ``repro.models.config``: the same fields, defaults
and ``__post_init__``, so a configuration means the same model in both
packages.  Every family builds, serves and trains.
``kv_cache_dtype="int8"`` quantizes a GQA cache (MLA and RWKV caches
ignore it, as in the reference).
``unroll_layers`` steers the JAX package's compiler and means nothing
here; ``remat_policy`` picks what the train forward's per-layer checkpoint
keeps (``models.common.checkpoint_body``).
"""

from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "ssm", "audio", "hybrid", "vlm"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # --- attention ---
    attention: Literal["gqa", "mla", "none"] = "gqa"
    rope_theta: float = 10_000.0
    rotary_pct: float = 1.0          # stablelm: partial rotary
    mrope_sections: tuple[int, ...] | None = None  # qwen2-vl M-RoPE

    # --- MLA (minicpm3 / deepseek-v2) ---
    q_lora_rank: int = 0             # 0 -> direct q projection
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # --- MoE ---
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0      # deepseek: first layer dense
    moe_layer_period: int = 1        # jamba: MoE on every 2nd layer
    moe_capacity_factor: float = 1.25

    # --- hybrid (jamba): attention every `attn_layer_period` layers ---
    attn_layer_period: int = 0       # 0 -> attention everywhere
    attn_layer_offset: int = 0

    # --- SSM (mamba) ---
    ssm_d_state: int = 16
    ssm_d_conv: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: int = 0             # 0 -> ceil(d_model / 16)

    # --- RWKV ---
    rwkv_head_size: int = 64
    rwkv_lora_decay: int = 64
    rwkv_lora_mix: int = 32

    # --- encoder-decoder (whisper) ---
    encoder_layers: int = 0
    encoder_seq: int = 1500          # precomputed frame embeddings (stub)

    # --- input stub: model consumes precomputed embeddings, not token ids ---
    embeds_input: bool = False       # qwen2-vl patch/text embedding stub

    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    max_seq: int = 8192              # cache default; shapes override
    # --- perf knobs (EXPERIMENTS.md §Perf hillclimbs) ---
    kv_cache_dtype: str = "bf16"     # "bf16" | "int8" (quantized KV cache)
    remat_policy: str = "full"       # "full" | "dots" (save matmul outputs)
    # Python-unroll the layer stack instead of lax.scan.  Used by the
    # dry-run's L1/L2 cost-delta variants: XLA cost analysis counts a while
    # body once regardless of trip count, so exact per-layer costs need the
    # layers materialized in HLO.
    unroll_layers: bool = False

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.ssm_dt_rank == 0:
            object.__setattr__(
                self, "ssm_dt_rank", -(-self.d_model // 16)
            )

    # ---- derived ----
    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_size

    def is_attn_layer(self, i: int) -> bool:
        if self.family == "ssm":
            return False
        if self.attn_layer_period == 0:
            return True
        return i % self.attn_layer_period == self.attn_layer_offset

    def is_moe_layer(self, i: int) -> bool:
        if self.num_experts == 0 or i < self.first_dense_layers:
            return False
        return (i % self.moe_layer_period) == (self.moe_layer_period - 1) \
            if self.moe_layer_period > 1 else True

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic context handling (per-assignment long_500k gate)."""
        return self.family in ("ssm", "hybrid")


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One (input-shape) cell of the assignment matrix."""

    name: str
    kind: Literal["train", "prefill", "decode"]
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524_288, 1),
}


def cells_for(cfg: ModelConfig) -> list[str]:
    """Shape cells this arch runs (long_500k only for sub-quadratic archs;
    no encoder-only archs in the pool, so decode runs everywhere)."""
    cells = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.supports_long_context:
        cells.append("long_500k")
    return cells
