"""deepseek-v2-lite-16b [moe] — arXiv:2405.04434 (hf tier).

27L d_model=2048 16H d_ff=1408(expert) vocab=102400, MLA kv_lora=512,
2 shared + 64 routed experts top-6, first layer dense (d_ff 10944 per HF).

NB the assignment line lists both "MoE 64e top-6" and "160 routed"; 160
routed belongs to full DeepSeek-V2.  We implement 64 routed per the primary
spec and the published V2-Lite config (see DESIGN.md).
MLA dims per HF: qk_nope=128, qk_rope=64, v_head=128, no q-LoRA.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=10944,            # dense first layer width
    vocab_size=102400,
    attention="mla",
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    head_dim=192,          # qk_nope + qk_rope
    num_experts=64,
    num_shared_experts=2,
    top_k=6,
    moe_d_ff=1408,
    first_dense_layers=1,
)
