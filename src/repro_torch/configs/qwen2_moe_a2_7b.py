"""qwen2-moe-a2.7b [moe]: 4 shared + 60 routed top-4 [hf:Qwen/Qwen1.5-MoE-A2.7B].

24L d_model=2048 16H (GQA kv=16) expert d_ff=1408 vocab=151936.
Experts padded 60 -> 64 for even 16-way expert-parallel sharding.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5632,           # shared-expert path width (4 x 1408)
    vocab_size=151936,
    n_experts=60,
    n_experts_padded=64,
    n_shared_experts=4,
    experts_per_token=4,
    moe_d_ff=1408,
    sliding_window=8192,
)
