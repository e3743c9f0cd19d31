"""Config registry: ``get_config(arch_id)`` for every assigned architecture."""
from .base import INPUT_SHAPES, InputShape, ModelConfig
from . import (
    deepseek_v3_671b,
    gpt_paper,
    granite_3_8b,
    hubert_xlarge,
    internvl2_1b,
    mamba2_1_3b,
    minitron_4b,
    minitron_8b,
    phi3_mini_3_8b,
    qwen2_moe_a2_7b,
    recurrentgemma_9b,
)

REGISTRY = {
    m.CONFIG.name: m.CONFIG
    for m in (
        hubert_xlarge,
        minitron_8b,
        recurrentgemma_9b,
        phi3_mini_3_8b,
        mamba2_1_3b,
        deepseek_v3_671b,
        internvl2_1b,
        qwen2_moe_a2_7b,
        minitron_4b,
        granite_3_8b,
        gpt_paper,
    )
}

ASSIGNED = [n for n in REGISTRY if n != "gpt-paper"]


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch '{name}'; known: {sorted(REGISTRY)}")
    return REGISTRY[name]


__all__ = [
    "ModelConfig",
    "InputShape",
    "INPUT_SHAPES",
    "REGISTRY",
    "ASSIGNED",
    "get_config",
]
