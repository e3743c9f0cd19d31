"""Model/config system: one dataclass covers all assigned architectures.

Field-for-field mirror of the JAX package's ``ModelConfig``: the same
registry, the same ``reduced()`` CPU smoke-test variant, and a
``torch_dtype`` property where the JAX package has ``jdtype``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encoder | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None

    # --- MoE ---------------------------------------------------------------
    n_experts: int = 0
    n_experts_padded: int = 0     # padded for even expert-parallel sharding
    n_shared_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    first_k_dense: int = 0        # deepseek: first k layers stay dense
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.001

    # --- MLA (deepseek) ----------------------------------------------------
    mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    mtp: bool = False             # multi-token-prediction auxiliary head

    # --- SSM (mamba2 / SSD) --------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    ssm_conv_width: int = 4

    # --- hybrid (recurrentgemma / RG-LRU) ------------------------------------
    local_window: int = 2048
    hybrid_period: int = 3        # (rglru, rglru, local-attn) repeating
    rglru_conv_width: int = 4

    # --- attention / misc ----------------------------------------------------
    rope_theta: float = 10000.0
    causal: bool = True           # False => encoder-only (bidirectional)
    sliding_window: Optional[int] = None  # long-context variant for dense archs
    act: str = "swiglu"           # swiglu | geglu | gelu
    norm: str = "rmsnorm"         # rmsnorm | layernorm
    tie_embeddings: bool = False
    frontend: Optional[str] = None  # audio | vision (stub embeddings)
    n_frontend_tokens: int = 256    # vision: patch tokens prepended
    dtype: str = "bfloat16"
    scan_layers: bool = True      # stacked (L, ...) block params vs a list

    # AutoChunk integration (first-class config field)
    autochunk_budget: Optional[float] = None  # ratio of baseline peak

    # -------------------------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up to a multiple of 256; pad logits are masked to
        -1e30 in unembed."""
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def d_inner(self) -> int:  # SSM expanded dim
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def is_attention_layer(self, i: int) -> bool:
        """hybrid archs: which layers are (local) attention."""
        if self.family != "hybrid":
            return True
        return i % self.hybrid_period == self.hybrid_period - 1

    def supports_decode(self) -> bool:
        return self.family not in ("encoder", "audio")

    def supports_long_context(self) -> bool:
        """long_500k requires sub-quadratic attention (or none at all)."""
        if not self.supports_decode():
            return False
        return self.family in ("ssm", "hybrid") or self.sliding_window is not None

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """CPU smoke-test variant of the same family."""
        kw = dict(
            n_layers=2,
            d_model=min(self.d_model, 128),
            n_heads=min(self.n_heads, 4),
            n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            d_ff=min(self.d_ff, 256) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            head_dim=32 if self.head_dim else None,
            local_window=64,
            n_frontend_tokens=8,
            scan_layers=self.scan_layers,
        )
        if self.n_experts:
            kw.update(
                n_experts=4,
                n_experts_padded=4,
                n_shared_experts=min(self.n_shared_experts, 1),
                experts_per_token=2,
                moe_d_ff=64,
                first_k_dense=min(self.first_k_dense, 1),
                # no capacity drops at smoke-test scale, so decode == forward
                capacity_factor=8.0,
            )
        if self.mla:
            kw.update(
                q_lora_rank=64,
                kv_lora_rank=32,
                qk_nope_dim=16,
                qk_rope_dim=16,
                v_head_dim=16,
            )
        if self.ssm_state:
            kw.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=16)
        if self.sliding_window is not None:
            kw.update(sliding_window=32)
        return self.with_(**kw)


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}
