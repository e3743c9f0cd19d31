"""Shared neural-net layers: plain functions over tensors and param dicts.

Each function mirrors its namesake in the JAX package's ``models/layers.py``
(same layouts, same f32 upcasts, same ``-1e30`` masking), so that the tests
can hold one against the other on the same inputs.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -1e30


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------

def rmsnorm(x, w, eps: float = 1e-6):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + w.float())).to(x.dtype)


def layernorm(x, w, b, eps: float = 1e-5):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(x.dtype)


def apply_norm(cfg, x, p):
    if cfg.norm == "layernorm":
        return layernorm(x, p["w"], p["b"])
    return rmsnorm(x, p["w"])


def _normal(gen, shape, scale: float, dtype, device):
    """``N(0, 1) * scale`` drawn in f32 from ``gen``, cast to ``dtype``.

    On the ``meta`` device nothing is drawn: the planner traces block
    shapes without materializing weights.  The scale is applied in place,
    so a bf16 weight holds at most its f32 draw and itself at once
    (deepseek-v3's routed ``w_up`` is 15 GB in bf16).
    """
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return x.mul_(scale).to(dtype)


def norm_params(cfg, d, *, device):
    dt = cfg.torch_dtype
    if cfg.norm == "layernorm":
        return {"w": torch.ones((d,), dtype=dt, device=device),
                "b": torch.zeros((d,), dtype=dt, device=device)}
    return {"w": torch.zeros((d,), dtype=dt, device=device)}


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------

def rope_freqs(hd: int, theta: float, device=None):
    exps = torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: (..., S) int."""
    if theta <= 0.0:
        return x
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)             # (hd/2,)
    ang = positions.float()[..., None] * freqs                  # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


# --------------------------------------------------------------------------
# Attention (GQA; full / causal / sliding-window)
# --------------------------------------------------------------------------

def attention_scores_mask(q_pos, kv_pos, *, causal: bool, window: Optional[int]):
    """Boolean mask (q_len, kv_len): True = attend.  With per-row positions,
    ``q_pos`` (B, q_len) and ``kv_pos`` (B, kv_len), the mask is
    (B, q_len, kv_len)."""
    if q_pos.dim() == 2:
        dq = q_pos[:, :, None]
        dk = kv_pos[:, None, :]
        shape = (q_pos.shape[0], q_pos.shape[1], kv_pos.shape[1])
    else:
        dq = q_pos[:, None]
        dk = kv_pos[None, :]
        shape = (q_pos.shape[0], kv_pos.shape[0])
    mask = torch.ones(shape, dtype=torch.bool, device=q_pos.device)
    if causal:
        mask = mask & (dk <= dq)
    if window is not None:
        mask = mask & (dq - dk < window)
    return mask


def gqa_attention(q, k, v, *, q_pos, kv_pos, causal: bool = True,
                  window: Optional[int] = None, kv_valid=None):
    """q: (B,Sq,H,hd); k,v: (B,Skv,Kv,hd).  Returns (B,Sq,H,hd).

    ``q_pos`` (Sq,) and ``kv_pos`` (Skv,) are shared by every row, as the
    JAX function takes them; the serving decode step gives each row its own,
    (B, Sq) and (B, Skv), with ``kv_valid`` (B, Skv): each row's mask is the
    one the JAX function gives that row alone.

    Written as broadcast matmuls over ``(B, Kv, G)`` rather than einsums:
    K and V enter as strided views, so no permuted copy of the context is
    made (``torch.einsum`` would make one, and the estimator would count it).
    """
    B, Sq, H, hd = q.shape
    Kv = k.shape[2]
    G = H // Kv
    scale = 1.0 / math.sqrt(hd)
    qg = q.float().reshape(B, Sq, Kv, G, hd).permute(0, 2, 3, 1, 4)  # (B,Kv,G,Sq,hd)
    kt = k.float().permute(0, 2, 3, 1).unsqueeze(2)                   # (B,Kv,1,hd,Skv)
    logits = (qg @ kt) * scale                                        # (B,Kv,G,Sq,Skv)
    mask = attention_scores_mask(q_pos, kv_pos, causal=causal, window=window)
    if mask.dim() == 3:                                               # per-row positions
        if kv_valid is not None:
            mask = mask & kv_valid[:, None, :]
        mask = mask[:, None, None]                                    # (B,1,1,Sq,Skv)
    elif kv_valid is not None:
        mask = mask & kv_valid[None, :]
    logits = torch.where(mask, logits, NEG_INF)
    a = torch.softmax(logits, dim=-1)
    out = a @ v.float().permute(0, 2, 1, 3).unsqueeze(2)              # (B,Kv,G,Sq,hd)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).to(q.dtype)


def attn_params(cfg, gen, *, device, d=None, n_heads=None, n_kv=None, hd=None):
    d = d or cfg.d_model
    n_heads = n_heads or cfg.n_heads
    n_kv = n_kv or cfg.n_kv_heads
    hd = hd or cfg.hd
    s = 1.0 / math.sqrt(d)
    dt = cfg.torch_dtype
    return {
        "wq": _normal(gen, (d, n_heads * hd), s, dt, device),
        "wk": _normal(gen, (d, n_kv * hd), s, dt, device),
        "wv": _normal(gen, (d, n_kv * hd), s, dt, device),
        "wo": _normal(gen, (n_heads * hd, d), s, dt, device),
    }


def attn_project_qkv(cfg, p, x, positions, *, n_heads=None, n_kv=None, hd=None):
    n_heads = n_heads or cfg.n_heads
    n_kv = n_kv or cfg.n_kv_heads
    hd = hd or cfg.hd
    B, S, _ = x.shape
    q = (x @ p["wq"]).reshape(B, S, n_heads, hd)
    k = (x @ p["wk"]).reshape(B, S, n_kv, hd)
    v = (x @ p["wv"]).reshape(B, S, n_kv, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------

def mlp_params(cfg, gen, *, device, d=None, f=None, act=None):
    d = d or cfg.d_model
    f = f or cfg.d_ff
    act = act or cfg.act
    gated = act in ("swiglu", "geglu")
    dt = cfg.torch_dtype
    return {
        "w_in": _normal(gen, (d, 2 * f if gated else f), 1.0 / math.sqrt(d), dt, device),
        "w_out": _normal(gen, (f, d), 1.0 / math.sqrt(f), dt, device),
    }


def mlp(cfg, p, x, act=None):
    """The first half of a gated ``w_in`` is up, the second half is gate."""
    act = act or cfg.act
    h = x @ p["w_in"]
    if act == "swiglu":
        u, g = torch.chunk(h, 2, dim=-1)
        h = u * F.silu(g)
    elif act == "geglu":
        u, g = torch.chunk(h, 2, dim=-1)
        h = u * F.gelu(g, approximate="tanh")
    else:
        h = F.gelu(h, approximate="tanh")
    return h @ p["w_out"]


# --------------------------------------------------------------------------
# Embedding / head
# --------------------------------------------------------------------------

def embed_params(cfg, gen, *, device):
    s = 1.0 / math.sqrt(cfg.d_model)
    vp = cfg.vocab_padded
    dt = cfg.torch_dtype
    p = {"embedding": _normal(gen, (vp, cfg.d_model), s, dt, device)}
    if not cfg.tie_embeddings:
        p["lm_head"] = _normal(gen, (cfg.d_model, vp), s, dt, device)
    return p


def embed(cfg, p, tokens):
    return F.embedding(tokens, p["embedding"])


def unembed(cfg, p, h):
    logits = h @ (p["embedding"].T if cfg.tie_embeddings else p["lm_head"])
    if cfg.vocab_padded != cfg.vocab_size:
        pad = torch.arange(cfg.vocab_padded, device=h.device) >= cfg.vocab_size
        logits = torch.where(pad, NEG_INF, logits.float()).to(logits.dtype)
    return logits
