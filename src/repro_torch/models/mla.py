"""Multi-head Latent Attention (DeepSeek-V2/V3, arXiv:2412.19437).

A port of the JAX package's ``models/mla.py``.  Each token keeps a
compressed latent ``ckv`` (``kv_lora_rank`` wide) and one RoPE key
``k_rope`` shared by every head.  The full-sequence (prefill) forward runs
the standard, decompressed form: per-head keys and values are decompressed
from ``ckv`` by ``w_uk`` and ``w_uv``.  The one-token decode runs the
absorbed form against the latent cache: ``w_uk`` is folded into the query
and ``w_uv`` applied after the weighted sum, so the cache holds
``kv_lora_rank + qk_rope_dim`` values a token instead of per-head K/V.  In
both forms the scores are the sum of two products (``q·k_nopeᵀ +
q_rope·k_ropeᵀ``), so no attention kernel computes them: the AutoChunk
compiler chunks them as a generic loop.
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


def mla_attention_decode(cfg, p, x, ckv, k_rope, pos, kv_valid):
    """Absorbed-form decode of one token a row against the latent ring.

    x: (B,1,d); ``ckv`` (B,W,kr) and ``k_rope`` (B,W,dr) the ring, this
    token's latent already written; ``pos`` (B,): row ``b``'s token sits at
    ``pos[b]``; ``kv_valid`` (B,W) bool.  Returns (B,1,d).  The caller
    computes the token's latent (:func:`mla_latent`) once and writes it.

    The JAX function's rounding points: ``q_eff`` in the model dtype, both
    score products and ``P·ckv`` in float32, ``w_uv`` widened, the output
    cast to ``x.dtype`` before ``w_o``.  With one query a row, each head is
    a row of every product: the scores are (B, H, kr) @ (B, kr, W) against
    the ring's own transposed view, and ``w_uk`` / ``w_uv`` multiply (H, B,
    ·) batches.  Neither the ring nor a weight is expanded over the heads
    or the batch: a broadcast ``@`` copies its expanded operand (the ring
    over 128 heads, 4.3 GB a layer at full width).
    """
    B = x.shape[0]
    H, dn, dr, dv = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    q_nope, q_rope = mla_queries(cfg, p, x, pos[:, None])              # (B,1,H,·)
    # absorb W_uk into the query: (H,B,dn) @ (H,dn,kr) -> (B,H,kr)
    q_eff = (q_nope[:, 0].transpose(0, 1) @ p["w_uk"].transpose(1, 2)).transpose(0, 1)
    scale = 1.0 / math.sqrt(dn + dr)
    lat = ckv.float()                                                  # (B,W,kr)
    logits = (q_eff.float() @ lat.transpose(1, 2)
              + q_rope[:, 0].float() @ k_rope.float().transpose(1, 2)) * scale  # (B,H,W)
    logits = torch.where(kv_valid[:, None, :], logits, NEG_INF)
    a = torch.softmax(logits, dim=-1)
    o_lat = (a @ lat).transpose(0, 1)                                  # (H,B,kr)
    out = (o_lat @ p["w_uv"].float()).to(x.dtype)                      # (H,B,dv)
    return out.transpose(0, 1).reshape(B, 1, H * dv) @ p["w_o"]
