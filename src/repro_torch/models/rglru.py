"""RecurrentGemma / Griffin recurrent block: RG-LRU + causal conv
(arXiv:2402.19427), full sequence.

A port of the JAX package's ``models/rglru.py``.  The JAX block runs the
recurrence as a log-depth ``associative_scan``; here ``rglru_scan`` routes
it through the RG-LRU kernel op (``kernels/rglru_scan.py``), the
sequential form that the Pallas kernel computes.  The gates stay in
PyTorch: two products, the sigmoid in the weights' dtype, then f32.

The decode arm (``rglru_step``, ``rglru_state_specs``) is not ported yet:
``decode=True`` raises (ROADMAP queue A item 10).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels import rglru_scan as RS
from .layers import _normal
from .ssm import DECODE_TODO, causal_conv1d

_C = 8.0  # Griffin's fixed temperature on the recurrence gate


def rglru_params(cfg, gen, *, device):
    d = cfg.d_model
    dr = d  # lru_width == d_model for recurrentgemma-9b
    s = 1.0 / math.sqrt(d)
    dt = cfg.torch_dtype
    W = cfg.rglru_conv_width
    return {
        "w_x": _normal(gen, (d, dr), s, dt, device),
        "w_gate": _normal(gen, (d, dr), s, dt, device),
        "conv_w": _normal(gen, (W, dr), 1.0 / math.sqrt(W), dt, device),
        "conv_b": torch.zeros((dr,), dtype=dt, device=device),
        "w_a": _normal(gen, (dr, dr), 1.0 / math.sqrt(dr), dt, device),
        "b_a": torch.zeros((dr,), dtype=dt, device=device),
        "w_i": _normal(gen, (dr, dr), 1.0 / math.sqrt(dr), dt, device),
        "b_i": torch.zeros((dr,), dtype=dt, device=device),
        "lam": torch.full((dr,), 2.0, dtype=torch.float32, device=device),
        "w_out": _normal(gen, (dr, d), 1.0 / math.sqrt(dr), dt, device),
    }


def _gates(p, xc):
    r = torch.sigmoid(xc @ p["w_a"] + p["b_a"]).float()
    i = torch.sigmoid(xc @ p["w_i"] + p["b_i"]).float()
    log_a = -_C * F.softplus(p["lam"]) * r          # (B,S,dr), negative
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * (i * xc.float())
    return a, b


def rglru_scan(p, xc):
    """h_t = a_t * h_{t-1} + b_t through the kernel op.  xc: (B,S,dr)."""
    a, b = _gates(p, xc)
    return RS.rglru_scan(a, b).to(xc.dtype)


def recurrent_block(cfg, p, x, *, state=None, conv_state=None, decode=False):
    """Griffin recurrent block.  x: (B,S,d) -> (y, (state, conv_state))."""
    if decode:
        raise NotImplementedError(DECODE_TODO)
    gate = F.gelu(x @ p["w_gate"], approximate="tanh")
    xb = x @ p["w_x"]
    xc = causal_conv1d(xb, p["conv_w"], p["conv_b"])
    h = rglru_scan(p, xc)
    state = h[:, -1].float()
    conv_state = xb[:, -(cfg.rglru_conv_width - 1):, :]
    return (gate * h) @ p["w_out"], (state, conv_state)
