"""Plain PyTorch oracles for the kernels (the allclose ground truth).

Ports of the JAX package's ``kernels/ref.py`` oracles, same math: f32
softmax, ``-1e30`` masking; the SwiGLU oracle computes in the inputs' type.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal: bool = True, window=None):
    """q: (B,Sq,H,hd); k,v: (B,Skv,H,hd) (same head count — GQA is expanded
    by the wrapper).  Query ``i`` sits at position ``Skv - Sq + i``."""
    B, Sq, H, hd = q.shape
    Skv = k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    logits = torch.einsum("bqhd,bshd->bhqs", q.float(), k.float()) * scale
    qpos = torch.arange(Sq, device=q.device)[:, None] + (Skv - Sq)
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (qpos - kpos < window)
    logits = torch.where(mask[None, None], logits, NEG_INF)
    a = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqs,bshd->bqhd", a, v.float())
    return out.to(q.dtype)


def paged_attention_ref(q, kv_pages, page_table, cu_q_lens, cu_kv_lens):
    """Oracle for ragged paged attention over flat query tokens.

    ``q``: (T, H, hd) — all sequences' query tokens concatenated;
    ``kv_pages``: (P, page_size, 2*Kv, hd) head-interleaved [K0,V0,..];
    ``page_table``: (S, max_pages) int; ``cu_q_lens``/``cu_kv_lens``:
    (S+1,) cumulative descriptors.  Gathers each sequence's pages into a
    dense KV and runs f32 softmax attention, causal within the sequence
    (query i at absolute position kv_len - q_len + i).  Returns (T, H, hd).
    """
    T, H, hd = q.shape
    page_size = kv_pages.shape[1]
    Kv = kv_pages.shape[2] // 2
    scale = 1.0 / math.sqrt(hd)
    cu_q = [int(x) for x in cu_q_lens]
    cu_kv = [int(x) for x in cu_kv_lens]
    table = torch.as_tensor(page_table, device=kv_pages.device).long()
    outs = []
    for s in range(len(cu_q) - 1):
        q_len = cu_q[s + 1] - cu_q[s]
        kv_len = cu_kv[s + 1] - cu_kv[s]
        if q_len == 0:
            continue
        qs = q[cu_q[s]:cu_q[s + 1]].float()                  # (L, H, hd)
        n_pages = -(-kv_len // page_size)
        pages = kv_pages[table[s, :n_pages]]
        kv = pages.reshape(n_pages * page_size, 2 * Kv, hd)[:kv_len]
        kv = kv.reshape(kv_len, Kv, 2, hd).float()
        k, v = kv[:, :, 0], kv[:, :, 1]                      # (kv_len, Kv, hd)
        k = torch.repeat_interleave(k, H // Kv, dim=1)
        v = torch.repeat_interleave(v, H // Kv, dim=1)
        logits = torch.einsum("qhd,shd->hqs", qs, k) * scale
        qpos = (kv_len - q_len) + torch.arange(q_len, device=q.device)[:, None]
        kpos = torch.arange(kv_len, device=q.device)[None, :]
        logits = torch.where(kpos <= qpos, logits, NEG_INF)
        a = torch.softmax(logits, dim=-1)
        outs.append(torch.einsum("hqs,shd->qhd", a, v))
    return torch.cat(outs, dim=0).to(q.dtype)


def swiglu_ffn_ref(x, w_gate, w_up, w_down):
    """x: (S,d); w_gate/w_up: (d,f); w_down: (f,d)."""
    h = F.silu(x @ w_gate) * (x @ w_up)
    return h @ w_down


def ssd_ref(x, dt, A, B, C, chunk: int):
    """The chunked SSD, i.e. the SSD kernel's plain version (a port of the
    JAX package's ``ssd_chunked``, itself held against the sequential
    recurrence in the tests).  Returns (y, final state)."""
    from .ssd_scan import ssd_scan_plain

    return ssd_scan_plain(x, dt, A, B, C, chunk)


def ssd_sequential_ref(x, dt, A, B, C):
    """O(S) sequential recurrence: the most literal SSD definition.
    Returns (y in x's dtype, final state (b,h,p,n) f32)."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    xf, dtf, Bf, Cf = x.float(), dt.float(), B.float(), C.float()
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        da = torch.exp(A.float()[None, :] * dtf[:, t])                       # (b,h)
        upd = torch.einsum("bh,bhp,bn->bhpn", dtf[:, t], xf[:, t], Bf[:, t])
        state = da[:, :, None, None] * state + upd
        ys.append(torch.einsum("bn,bhpn->bhp", Cf[:, t], state))
    return torch.stack(ys, dim=1).to(x.dtype), state


def rglru_ref(a, b):
    """h_t = a_t * h_{t-1} + b_t in f32; a, b: (B,S,D).  A sequential f32
    loop over S (torch has no stable associative scan; the JAX oracle's
    log-depth scan sums in another order), i.e. the RG-LRU kernel's plain
    version."""
    from .rglru_scan import rglru_scan_plain

    return rglru_scan_plain(a, b)
