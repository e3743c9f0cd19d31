"""deepseek-v3-671b [moe]: MLA, 1 shared + 256 routed top-8, MTP [arXiv:2412.19437].

61L d_model=7168 128H d_ff=2048(expert) vocab=129280; MoE 256e top-8,
first 3 layers dense (d_ff 18432); MLA q_lora 1536 / kv_lora 512 /
qk_nope 128 / qk_rope 64 / v_head 128.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=18432,          # dense-layer FFN width (first_k_dense layers)
    vocab_size=129280,
    n_experts=256,
    n_experts_padded=256,
    n_shared_experts=1,
    experts_per_token=8,
    moe_d_ff=2048,
    first_k_dense=3,
    mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    mtp=True,
    sliding_window=8192,
)
