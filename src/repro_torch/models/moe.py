"""Mixture-of-Experts: static-capacity gather/scatter dispatch.

A port of the JAX package's ``models/moe.py``.  Each batch row builds a
compact (E, C) token-index table with a sort-free rank computation, gathers
its tokens into an (E, C, d) buffer, runs all experts as one batched
product, and adds the gated outputs back into the rows they came from.
Every shape is static, so the AutoChunk compiler traces the block with
fake tensors; the routing, gather, expert products and combine are plain
PyTorch, as they are plain ``jnp`` in the JAX package.  The shared expert is
the port's ``layers.mlp`` (a fused SwiGLU, which kernel dispatch sends to
``chunked_ffn`` inside a chunk loop).

Tokens beyond an expert's capacity are dropped (GShard/Switch semantics;
``capacity_factor`` sets the slack): an assignment is kept exactly when its
rank among the assignments to its expert is below the capacity.  The JAX
package's ``dispatch_tables`` writes every dropped assignment to slot
``(e, cap-1)`` as well, so an overflowing expert there loses the token it
kept at rank ``cap-1`` (ROADMAP C-ref-4); here dropped assignments go to a
spare column that is cut off, and every ``rank < cap`` assignment stays.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .layers import NEG_INF, _normal, mlp, mlp_params


def capacity(cfg, n_tokens: int) -> int:
    c = int(math.ceil(n_tokens * cfg.experts_per_token / cfg.n_experts_padded
                      * cfg.capacity_factor))
    return max(8, c)


def moe_params(cfg, gen, *, device):
    E = cfg.n_experts_padded
    d, f = cfg.d_model, cfg.moe_d_ff
    s = 1.0 / math.sqrt(d)
    dt = cfg.torch_dtype
    p = {
        "router": _normal(gen, (d, E), s, torch.float32, device),
        # gated experts: fused (E, d, 2f) up/gate and (E, f, d) down
        "w_up": _normal(gen, (E, d, 2 * f), s, dt, device),
        "w_down": _normal(gen, (E, f, d), 1.0 / math.sqrt(f), dt, device),
    }
    if cfg.n_shared_experts:
        p["shared"] = mlp_params(cfg, gen, device=device, d=d,
                                 f=cfg.n_shared_experts * f, act="swiglu")
    return p


def top_k(scores, k: int):
    """``jax.lax.top_k`` over the last dim: the k largest values, ties in
    index order (a stable descending sort; ``torch.topk`` promises no
    order among equal values)."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(cfg, x_flat, router_w):
    """Returns (expert_idx (N,k), gates (N,k), aux_loss scalar)."""
    E, k = cfg.n_experts_padded, cfg.experts_per_token
    logits = x_flat.float() @ router_w
    if cfg.n_experts_padded != cfg.n_experts:  # mask padding experts
        pad = torch.arange(E, device=logits.device) >= cfg.n_experts
        logits = logits.masked_fill(pad, NEG_INF)
    if cfg.mla:  # DeepSeek-V3-style sigmoid routing, normalized over top-k
        scores = torch.sigmoid(logits)
        gates, idx = top_k(scores, k)
        gates = gates / (gates.sum(dim=-1, keepdim=True) + 1e-9)
        probs = scores / (scores.sum(dim=-1, keepdim=True) + 1e-9)
    else:
        probs = torch.softmax(logits, dim=-1)
        gates, idx = top_k(probs, k)
    # load-balance aux loss (Switch-style): E * sum_e f_e * P_e
    me = probs.mean(dim=0)
    experts = torch.arange(E, device=idx.device)
    ce = (idx[..., None] == experts).float().sum(dim=1).mean(dim=0)
    aux = cfg.n_experts * torch.sum(me * ce) * cfg.router_aux_coef
    return idx, gates.to(x_flat.dtype), aux


def dispatch_tables(cfg, idx, gates, n_tokens: int, cap: int):
    """(B, E, cap) token-index and gate tables from (B, N, k) assignments,
    each batch row a group of its own (the JAX package's function, vmapped).

    An assignment's rank is the number of earlier assignments to the same
    expert, in flat order ``token * k + j`` (a cumulative count, no sort).
    Empty slots hold the sentinel row ``n_tokens`` and gate 0.
    """
    E, k = cfg.n_experts_padded, cfg.experts_per_token
    B, dev = idx.shape[0], idx.device
    flat_e = idx.reshape(B, n_tokens * k)
    onehot = (flat_e[..., None] == torch.arange(E, device=dev)).to(torch.int64)
    ranks = torch.cumsum(onehot, dim=1) - onehot                # exclusive
    rank = torch.gather(ranks, 2, flat_e[..., None])[..., 0]
    # a dropped assignment lands in the spare column ``cap``, cut off below
    at = (torch.arange(B, device=dev)[:, None].expand(B, n_tokens * k), flat_e,
          torch.where(rank < cap, rank, cap))
    tok = torch.arange(n_tokens, device=dev)[:, None].expand(n_tokens, k).reshape(-1)
    table = torch.full((B, E, cap + 1), n_tokens, dtype=torch.int64, device=dev)
    table = table.index_put(at, tok)
    gate_t = torch.zeros((B, E, cap + 1), dtype=gates.dtype, device=dev)
    gate_t = gate_t.index_put(at, gates.reshape(B, n_tokens * k))
    return table[..., :cap], gate_t[..., :cap]


def moe_ffn(cfg, p, x):
    """x: (B, S, d) -> ((B, S, d), router aux loss).

    Each batch row is a group with its own (E, C) table, so the dispatch
    buffer is (B, E, C, d); routing is per token, capacity per group.
    """
    B, S, d = x.shape
    idx, gates, aux = route(cfg, x.reshape(B * S, d), p["router"])
    cap = capacity(cfg, S)
    table, gate_t = dispatch_tables(cfg, idx.reshape(B, S, -1), gates.reshape(B, S, -1),
                                    S, cap)                             # (B, E, C)
    # row S of each group is the zero row the sentinel points at
    x_pad = torch.cat([x, x.new_zeros((B, 1, d))], dim=1).reshape(B * (S + 1), d)
    rows = table + torch.arange(B, device=x.device)[:, None, None] * (S + 1)
    dispatched = x_pad[rows]                                            # (B, E, C, d)
    h = torch.einsum("becd,edf->becf", dispatched, p["w_up"])
    u, g = torch.chunk(h, 2, dim=-1)
    h = u * F.silu(g)
    out_e = torch.einsum("becf,efd->becd", h, p["w_down"])
    out_e = out_e * gate_t[..., None]
    out = x.new_zeros((B * (S + 1), d)).index_add(0, rows.reshape(-1), out_e.reshape(-1, d))
    out = out.reshape(B, S + 1, d)[:, :S]
    if cfg.n_shared_experts:
        out = out + mlp(cfg, p["shared"], x, act="swiglu")
    return out, aux
