"""AdamW over a tree of tensors, with the JAX package's numerics step for step.

The global gradient norm is taken in float32 and clipped at ``grad_clip``
(``scale = min(1, clip / (norm + 1e-9))``, cast to each gradient's dtype);
the update runs in float32 with the bias corrections of the incremented
step and ``weight_decay * p`` inside the ``lr`` product, on every leaf; the
results are cast back to each leaf's dtype.  Moments are stored in the
parameter dtype unless ``moment_dtype='float32'``.  ``torch.optim.AdamW``
clips and casts otherwise, so it is not used.

A tree is a dict / list / tuple of tensors (``dict(model.named_parameters())``
is one).  A gradient that is ``None`` raises: a parameter that got no
gradient is a fault to report, never a leaf to skip.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch
from torch.utils import _pytree as pytree


class AdamWState(NamedTuple):
    step: int        # completed updates
    mu: Any
    nu: Any


def adamw_init(params, moment_dtype: Optional[str] = None) -> AdamWState:
    def zeros_like(p):
        dt = getattr(torch, moment_dtype) if moment_dtype else p.dtype
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    return AdamWState(step=0, mu=pytree.tree_map(zeros_like, params),
                      nu=pytree.tree_map(zeros_like, params))


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device="cpu")


@torch.no_grad()
def adamw_update(params, grads, state: AdamWState, lr, *, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8, weight_decay: float = 0.1,
                 grad_clip: Optional[float] = 1.0):
    """One AdamW step.  Returns ``(new_params, new_state)``: new tensors in
    the trees' structure; the inputs are not written."""
    flat_p, spec = pytree.tree_flatten(params)
    with_paths = pytree.tree_flatten_with_path(grads)[0]
    if len(with_paths) != len(flat_p):
        raise ValueError(f"{len(with_paths)} gradients for {len(flat_p)} parameters")
    for path, g in with_paths:
        if g is None:
            raise ValueError(f"no gradient for parameter {pytree.keystr(path)}: it does"
                             " not reach the loss, or a kernel cut the graph")
    flat_g = [g for _, g in with_paths]
    flat_m = pytree.tree_leaves(state.mu)
    flat_v = pytree.tree_leaves(state.nu)
    if grad_clip is not None:
        gnorm = torch.stack([g.float().square().sum() for g in flat_g]).sum().sqrt()
        scale = torch.clamp(grad_clip / (gnorm + 1e-9), max=1.0)
        flat_g = [g * scale.to(g.dtype) for g in flat_g]

    step = state.step + 1
    c1 = 1.0 - _f32(b1) ** _f32(step)
    c2 = 1.0 - _f32(b2) ** _f32(step)
    lr = _f32(lr)

    # c1, c2 and lr are 0-d CPU tensors: scalars to an op on any device
    def upd(p, g, m, v):
        gf = g.float()
        m2 = b1 * m.float() + (1 - b1) * gf
        v2 = b2 * v.float() + (1 - b2) * gf.square()
        mhat = m2 / c1
        vhat = v2 / c2
        delta = mhat / (vhat.sqrt() + eps) + weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m2.to(m.dtype), v2.to(v.dtype)

    out = [upd(p, g, m, v) for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v)]
    new_p = pytree.tree_unflatten([o[0] for o in out], spec)
    new_m = pytree.tree_unflatten([o[1] for o in out], spec)
    new_v = pytree.tree_unflatten([o[2] for o in out], spec)
    return new_p, AdamWState(step=step, mu=new_m, nu=new_v)
