"""whisper-small [audio] — arXiv:2212.04356 (unverified tier).

12L d_model=768 12H (kv=12) d_ff=3072 vocab=51865; encoder-decoder with a
conv/mel frontend STUB: input_specs() provides precomputed frame embeddings
(B, 1500, d), per the assignment.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    num_layers=12,           # decoder layers
    encoder_layers=12,
    encoder_seq=1500,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    rotary_pct=0.0,          # learned absolute positions
    max_seq=32_768 + 8,      # decode_32k cell needs 32k learned positions
)
