"""recurrentgemma-9b [hybrid]: RG-LRU + local attention, 1:2 [arXiv:2402.19427].

38L d_model=4096 16H (GQA kv=1, MQA) d_ff=12288 vocab=256000.
Pattern: (rglru, rglru, local-attn) repeating; local window 2048.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab_size=256000,
    act="geglu",
    local_window=2048,
    hybrid_period=3,
    scan_layers=False,  # heterogeneous layer pattern -> unrolled stack
)
