"""qwen2-vl-7b [vlm] — arXiv:2409.12191 (hf tier).

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064 — M-RoPE
(t/h/w sections 16/24/24 of head_dim/2), dynamic-resolution vision frontend
STUBBED: input_specs() provides precomputed patch/text embeddings (B, S, d).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    mrope_sections=(16, 24, 24),
    rope_theta=1_000_000.0,
    embeds_input=True,
)
