"""Multi-head Latent Attention (DeepSeek-V2/V3, arXiv:2412.19437): the forward.

A port of the JAX package's ``models/mla.py`` for the full-sequence
(prefill) forward in the standard, decompressed form: each token keeps a
compressed latent ``ckv`` (``kv_lora_rank`` wide) and one RoPE key
``k_rope`` shared by every head; per-head keys and values are decompressed
from ``ckv`` by ``w_uk`` and ``w_uv``.  The scores are the sum of two
products, ``q_nope·k_nopeᵀ + q_rope·k_ropeᵀ``, so no attention kernel
computes them: the AutoChunk compiler chunks them as a generic loop.  The
absorbed-form decode against the latent cache is not ported yet (ROADMAP
queue A item 10 (c)).
"""
from __future__ import annotations

import math

import torch

from .layers import NEG_INF, _normal, apply_rope, attention_scores_mask, rmsnorm


def mla_params(cfg, gen, *, device):
    d = cfg.d_model
    H = cfg.n_heads
    qr, kr = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    s = 1.0 / math.sqrt(d)
    dt = cfg.torch_dtype
    return {
        "w_dq": _normal(gen, (d, qr), s, dt, device),
        "q_norm": torch.zeros((qr,), dtype=dt, device=device),
        "w_uq": _normal(gen, (qr, H * (dn + dr)), 1.0 / math.sqrt(qr), dt, device),
        "w_dkv": _normal(gen, (d, kr), s, dt, device),
        "kv_norm": torch.zeros((kr,), dtype=dt, device=device),
        "w_uk": _normal(gen, (H, kr, dn), 1.0 / math.sqrt(kr), dt, device),
        "w_uv": _normal(gen, (H, kr, dv), 1.0 / math.sqrt(kr), dt, device),
        "w_kr": _normal(gen, (d, dr), s, dt, device),
        "w_o": _normal(gen, (H * dv, d), 1.0 / math.sqrt(H * dv), dt, device),
    }


def mla_latent(cfg, p, x, positions):
    """Compressed per-token latent: (ckv (B,S,kr), k_rope (B,S,dr))."""
    ckv = rmsnorm(x @ p["w_dkv"], p["kv_norm"])
    k_rope = (x @ p["w_kr"])[:, :, None, :]          # (B,S,1,dr)
    k_rope = apply_rope(k_rope, positions, cfg.rope_theta)[:, :, 0]
    return ckv, k_rope


def mla_queries(cfg, p, x, positions):
    """(q_nope (B,S,H,dn), q_rope (B,S,H,dr))."""
    B, S, _ = x.shape
    H, dn, dr = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    cq = rmsnorm(x @ p["w_dq"], p["q_norm"])
    q = (cq @ p["w_uq"]).reshape(B, S, H, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    return q_nope, q_rope


def mla_attention_prefill(cfg, p, x, positions, *, window=None):
    """Standard-form MLA over a full sequence (causal).  Returns (out
    (B,S,d), (ckv, k_rope)).

    Written as broadcast matmuls, as ``layers.gqa_attention`` is: the keys
    and values come out of ``ckv`` already in (B,H,S,·) layout, the shared
    ``k_rope`` is an unsqueezed view broadcast over the heads (never a
    repeated copy), and every operand of the scores enters as a strided
    view, so no permuted copy is made for the estimator to count.
    """
    B, S, _ = x.shape
    H, dn, dr, dv = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    q_nope, q_rope = mla_queries(cfg, p, x, positions)
    ckv, k_rope = mla_latent(cfg, p, x, positions)
    lat = ckv.unsqueeze(1)                                             # (B,1,S,kr)
    k_nope = lat @ p["w_uk"]                                           # (B,H,S,dn)
    v = lat @ p["w_uv"]                                                # (B,H,S,dv)
    scale = 1.0 / math.sqrt(dn + dr)
    qn = q_nope.float().permute(0, 2, 1, 3)                            # (B,H,Sq,dn)
    qr = q_rope.float().permute(0, 2, 1, 3)                            # (B,H,Sq,dr)
    kn = k_nope.float().transpose(2, 3)                                # (B,H,dn,Skv)
    kr = k_rope.float().transpose(1, 2).unsqueeze(1)                   # (B,1,dr,Skv)
    logits = (qn @ kn + qr @ kr) * scale                               # (B,H,Sq,Skv)
    mask = attention_scores_mask(positions, positions, causal=True, window=window)
    logits = torch.where(mask, logits, NEG_INF)
    a = torch.softmax(logits, dim=-1)
    out = a @ v.float()                                                # (B,H,Sq,dv)
    out = out.permute(0, 2, 1, 3).to(x.dtype).reshape(B, S, H * dv)
    return out @ p["w_o"], (ckv, k_rope)
