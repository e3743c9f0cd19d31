"""gpt-paper [dense]: the paper's own GPT evaluation model (§4, prefill stage).

A GPT-2-XL-scale decoder used by the reproduction benchmarks (Fig. 1/5/6);
small enough to run end-to-end on CPU at reduced sequence lengths while
exhibiting the same activation-memory growth the paper plots.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gpt-paper",
    family="dense",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=50257,
    act="gelu",
    norm="layernorm",
    tie_embeddings=True,
)
