"""internvl2-1b [vlm]: InternViT + InternLM2/Qwen2-0.5B decoder [arXiv:2404.16821].

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655.  The ViT/projector
frontend is a stub — ``input_specs`` provides patch embeddings prepended to
the text sequence; this config is the language decoder backbone.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab_size=151655,
    act="swiglu",
    frontend="vision",
    n_frontend_tokens=256,
    tie_embeddings=True,
    sliding_window=8192,
)
