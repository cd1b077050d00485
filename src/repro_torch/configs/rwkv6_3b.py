"""rwkv6-3b [ssm] — "Finch", arXiv:2404.05892 (hf tier).

32L d_model=2560 (attention-free) d_ff=8960 vocab=65536;
data-dependent decay linear attention, head_size 64 -> 40 heads.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    num_layers=32,
    d_model=2560,
    num_heads=40,           # d_model / rwkv_head_size
    num_kv_heads=40,
    d_ff=8960,
    vocab_size=65536,
    attention="none",
    rwkv_head_size=64,
)
