"""jamba-v0.1-52b [hybrid] — arXiv:2403.19887 (hf tier).

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536, MoE 16e top-2.
Mamba+attention 1:7 interleave (attention at layer offset 4 of each period-8
block), MoE every other layer.  Mamba: d_state=16, d_conv=4, expand=2.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    num_experts=16,
    top_k=2,
    moe_d_ff=14336,
    moe_layer_period=2,
    attn_layer_period=8,
    attn_layer_offset=4,
    ssm_d_state=16,
    ssm_d_conv=4,
    ssm_expand=2,
)
