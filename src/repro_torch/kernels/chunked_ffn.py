"""Chunked SwiGLU FFN: the compiler's dispatch target for SwiGLU bodies.

:func:`chunked_ffn` computes ``(silu(x @ w_gate) * (x @ w_up)) @ w_down`` for
``x`` (S, d), ``w_gate``/``w_up`` (d, f) and ``w_down`` (f, d) as the Pallas
kernel ``_ffn_kernel`` does: gate and up in f32, ``h = silu(g) * u`` in f32
(never rounded to x's type), ``h @ w_down`` accumulated in f32, the output
in x's type.  :func:`chunked_ffn_fused` takes a SwiGLU layer's fused
``w_in`` (d, 2f) with the column offsets of up and gate and passes column
views of it: the kernel reads them in place through their leading
dimension, so the two halves are never copied.

On a CUDA tensor the wrapper launches the hand-written kernel in
``csrc/chunked_ffn.cu`` (or raises); on a CPU tensor it runs the plain
PyTorch version beside it, which walks f in blocks so that it never holds
a whole (S, f) tensor either.  ``chunked_ffn.launches`` counts kernel
launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import build, refuse_grad

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# f must be a multiple of the kernel's f tile and d of its 64-column step
F_TILE = {torch.float32: 64, torch.bfloat16: 128}
D_STEP = 64
PLAIN_BLOCK_F = 512     # f columns a step of the plain version holds


def workspace_bytes(rows: int, d: int, dtype: torch.dtype) -> int:
    """Device bytes the CUDA call allocates besides its output: the f32
    (rows, d) accumulator of a bf16 call (f32 calls accumulate in place)."""
    return 0 if dtype == torch.float32 else rows * d * 4


def chunked_ffn_plain(x, w_gate, w_up, w_down):
    """Plain PyTorch version of the kernel (same arithmetic)."""
    xf = x.float()
    acc = torch.zeros((x.shape[0], w_down.shape[1]), dtype=torch.float32, device=x.device)
    for f0 in range(0, w_gate.shape[1], PLAIN_BLOCK_F):
        cols = slice(f0, f0 + PLAIN_BLOCK_F)
        g = xf @ w_gate[:, cols].float()
        u = xf @ w_up[:, cols].float()
        acc += (g * torch.sigmoid(g) * u) @ w_down[cols].float()
    return acc.to(x.dtype)


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry point of ``csrc/chunked_ffn.cu``, built on first use."""
    fn = build.load("chunked_ffn").chunked_ffn_fwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(x, w_gate, w_up, w_down):
    """What the kernel takes; checked on every device, so the CPU tests reach it."""
    if x.dim() != 2 or w_gate.dim() != 2 or w_up.shape != w_gate.shape or w_down.dim() != 2:
        raise ValueError(f"want x (S, d), w_gate/w_up (d, f), w_down (f, d); got"
                         f" {tuple(x.shape)}, {tuple(w_gate.shape)}, {tuple(w_up.shape)},"
                         f" {tuple(w_down.shape)}")
    d, f = w_gate.shape
    if x.shape[1] != d or tuple(w_down.shape) != (f, d):
        raise ValueError(f"x {tuple(x.shape)}, w_gate {tuple(w_gate.shape)} and w_down"
                         f" {tuple(w_down.shape)} disagree on d or f")
    for name, t in (("w_gate", w_gate), ("w_up", w_up), ("w_down", w_down)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != x.dtype:
            raise TypeError(f"{name} is {t.dtype}, x is {x.dtype}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"x must be one of {list(_DTYPE_CODES)}, got {x.dtype}")


def cuda_refusal(d: int, f: int, dtype: torch.dtype, strides=None,
                 addresses=None) -> Optional[str]:
    """Why the CUDA kernel refuses these operands, or None if it takes them.

    ``strides``: the (row, column) strides of x, w_gate, w_up and w_down in
    elements; ``addresses``: their byte addresses, or offsets from a 16-byte
    aligned base.  Either omitted means contiguous and aligned.  The wrapper
    raises with this message on a CUDA tensor; kernel dispatch refuses a
    SwiGLU site targeted at the card with it.
    """
    if d % D_STEP or f % F_TILE[dtype]:
        return (f"the CUDA kernel takes d a multiple of {D_STEP} and f a multiple of"
                f" {F_TILE[dtype]} for {dtype}; got d {d}, f {f}")
    names = ("x", "w_gate", "w_up", "w_down")
    for name, st in zip(names, strides or ()):
        if name == "w_down" and tuple(st) != (d, 1):
            return f"w_down must be contiguous, got strides {tuple(st)}"
        if st[1] != 1 or st[0] % 8:
            return (f"{name} must have unit column stride and a row stride that is a"
                    f" multiple of 8, got strides {tuple(st)}")
    for name, a in zip(names, addresses or ()):
        if a % 16:
            return f"{name} must be 16-byte aligned"
    return None


def _cuda_ready(x, w_gate, w_up, w_down):
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    ts = (x, w_gate, w_up, w_down)
    why = cuda_refusal(*w_gate.shape, x.dtype, strides=[t.stride() for t in ts],
                       addresses=[t.data_ptr() for t in ts])
    if why is not None:
        raise ValueError(why)


def chunked_ffn(x, w_gate, w_up, w_down, *, block_s: int = 128, block_f: int = 512,
                buffer_depth: int = 2):
    """``(silu(x @ w_gate) * (x @ w_up)) @ w_down`` -> (S, d) in x's dtype.

    ``w_gate``/``w_up`` may be column views of a larger weight (row stride
    other than f): the kernel reads them in place.  ``block_s``, ``block_f``
    and ``buffer_depth`` are accepted for signature parity with the JAX
    wrapper and ignored: they sized the Mosaic blocks on the TPU; the CUDA
    kernel has fixed 64-row tiles.
    """
    del block_s, block_f, buffer_depth
    _check(x, w_gate, w_up, w_down)
    if x.device.type == "cpu":
        return chunked_ffn_plain(x, w_gate, w_up, w_down)
    refuse_grad("chunked_ffn", x, w_gate, w_up, w_down)
    _cuda_ready(x, w_gate, w_up, w_down)
    S, d = x.shape
    out = torch.empty((S, d), dtype=x.dtype, device=x.device)
    if S == 0:
        return out
    ws = None
    if workspace_bytes(S, d, x.dtype):
        ws = torch.empty((S, d), dtype=torch.float32, device=x.device)
    err = _kernel()(x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), w_down.data_ptr(),
                    out.data_ptr(), 0 if ws is None else ws.data_ptr(), S, d,
                    w_gate.shape[1], x.stride(0), w_gate.stride(0), w_up.stride(0),
                    _DTYPE_CODES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"chunked_ffn kernel launch failed: CUDA error {err}")
    chunked_ffn.launches += 1
    return out


def chunked_ffn_fused(x, w_in, w_down, *, up: int = 0, gate: int = None, **tiles):
    """:func:`chunked_ffn` with a fused ``w_in`` (d, 2f): up is columns
    ``[up, up + f)`` and gate ``[gate, gate + f)`` (default: the first half
    is up and the second gate, as ``layers.mlp`` splits it).  The halves are
    column views, never copies."""
    f = w_down.shape[0]
    gate = f if gate is None else gate
    return chunked_ffn(x, w_in[:, gate:gate + f], w_in[:, up:up + f], w_down, **tiles)


chunked_ffn.launches = 0
