"""Mamba-2 SSD block (state-space duality, arXiv:2405.21060), full sequence.

A port of the JAX package's ``models/ssm.py``.  The SSD algorithm is
natively chunked: quadratic (attention-like) compute inside a chunk and a
linear state recurrence between chunks.  The JAX block calls its plain
``ssd_chunked``; here ``ssm_block`` routes the scan through the SSD kernel
op (``kernels/ssd_scan.py``), whose plain version is a port of that
``ssd_chunked`` and whose CUDA kernel computes the same contraction on the
card.

The decode arm (``conv1d_step``, ``ssd_decode_step``, ``ssm_state_specs``)
is not ported yet: ``decode=True`` raises (ROADMAP queue A item 10).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels import ssd_scan as SS
from .layers import _normal, rmsnorm

DECODE_TODO = "the SSM and RG-LRU decode arms (ROADMAP queue A item 10)"


def ssm_params(cfg, gen, *, device):
    d, di = cfg.d_model, cfg.d_inner
    H, N, W = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_conv_width
    conv_ch = di + 2 * N
    s = 1.0 / math.sqrt(d)
    dt = cfg.torch_dtype
    f32 = torch.float32
    return {
        "w_in": _normal(gen, (d, 2 * di + 2 * N + H), s, dt, device),
        "conv_w": _normal(gen, (W, conv_ch), 1.0 / math.sqrt(W), dt, device),
        "conv_b": torch.zeros((conv_ch,), dtype=dt, device=device),
        "A_log": torch.zeros((H,), dtype=f32, device=device),
        "D": torch.ones((H,), dtype=f32, device=device),
        "dt_bias": torch.zeros((H,), dtype=f32, device=device),
        "out_norm": torch.zeros((di,), dtype=dt, device=device),
        "w_out": _normal(gen, (di, d), 1.0 / math.sqrt(di), dt, device),
    }


def causal_conv1d(x, w, b):
    """x: (B,S,C); w: (W,C) depthwise causal conv, accumulated in x's dtype
    one tap at a time."""
    W = w.shape[0]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = torch.zeros_like(x)
    for i in range(W):
        out = out + xp[:, i:i + x.shape[1], :] * w[i]
    return out + b


def ssm_block(cfg, p, x, *, state=None, conv_state=None, decode: bool = False):
    """Mamba-2 block, full sequence: x (B,S,d) -> (y, (ssd_state, conv_state))."""
    if decode:
        raise NotImplementedError(DECODE_TODO)
    B_, S, d = x.shape
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    proj = x @ p["w_in"]
    z, xs, Bm, Cm, dt = torch.split(proj, [di, di, N, N, H], dim=-1)
    conv_in = torch.cat([xs, Bm, Cm], dim=-1)
    conv_out = causal_conv1d(conv_in, p["conv_w"], p["conv_b"])
    conv_state = conv_in[:, -(cfg.ssm_conv_width - 1):, :]
    conv_out = F.silu(conv_out)
    # column views of the conv output: the kernel reads them in place
    xs, Bm, Cm = torch.split(conv_out, [di, N, N], dim=-1)
    xh = xs.reshape(B_, S, H, P)
    dtp = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    yh, state = SS.ssd_scan(xh, dtp, A, Bm, Cm, chunk=min(cfg.ssm_chunk, S))
    yh = yh + p["D"][None, None, :, None] * xh.float()
    y = yh.reshape(B_, S, di).to(x.dtype)
    y = rmsnorm(y * F.silu(z), p["out_norm"])
    return y @ p["w_out"], (state, conv_state)
