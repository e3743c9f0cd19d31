"""hubert-xlarge [audio]: encoder-only, same arch as wav2vec2 [arXiv:2106.07447].

48L d_model=1280 16H (GQA kv=16) d_ff=5120 vocab=504.  The conv/mel feature
extractor is a stub — ``input_specs`` provides precomputed frame embeddings;
this config is the transformer backbone + masked-unit prediction head.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    causal=False,
    act="gelu",
    norm="layernorm",
    frontend="audio",
    rope_theta=0.0,  # HuBERT uses (stubbed) conv positional embedding, not RoPE
)
