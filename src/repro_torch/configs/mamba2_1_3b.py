"""mamba2-1.3b [ssm]: SSD (state-space duality) [arXiv:2405.21060].

48L d_model=2048 (attention-free) vocab=50280, ssm_state=128,
expand=2 (d_inner=4096), head_dim=64 -> 64 SSD heads, chunk=128.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=1,       # unused (attention-free)
    n_kv_heads=1,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=128,
    tie_embeddings=True,
)
