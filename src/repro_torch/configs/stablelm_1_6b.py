"""stablelm-1.6b [dense] — hf:stabilityai/stablelm-2-1_6b (unverified tier).

24L d_model=2048 32H (GQA kv=32 == MHA) d_ff=5632 vocab=100352.
StableLM-2 uses partial rotary embeddings (25% of head_dim).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b",
    family="dense",
    num_layers=24,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=5632,
    vocab_size=100352,
    rotary_pct=0.25,
    rope_theta=10_000.0,
)
