"""RG-LRU linear recurrence: the recurrent block's kernel (RecurrentGemma).

:func:`rglru_scan` computes ``h_t = a_t * h_{t-1} + b_t`` over the channels
of ``a``/``b`` (B, S, D), from ``h_{-1} = 0``, as the JAX package's Pallas
kernel ``_rglru_kernel`` does: f32 inside, the output always f32.  The
kernel rounds the product before the sum (no fused multiply-add), which is
the arithmetic of the plain version step by step, so the two agree bit for
bit.

The op is registered as ``torch.ops.repro_torch.rglru_scan`` (a
``torch.library.custom_op``: the plain version for CPU tensors, the kernel
for CUDA tensors, and a fake implementation), so a fake-mode trace keeps it
as one node.  On a CUDA tensor the op launches the hand-written kernel in
``csrc/rglru_scan.cu`` (or raises); on a CPU tensor it runs
:func:`rglru_scan_plain`.  ``rglru_scan.launches`` counts the op's launches
on the card (one kernel a call).  The kernel streams a and b through a
shared-memory ring per 32-channel tile and keeps each channel's recurrence
sequential (``csrc/rglru_scan.cu``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import OP_FLOPS, build, refuse_grad

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def rglru_scan_plain(a, b):
    """Plain PyTorch version: the recurrence as a sequential f32 loop over S
    (one multiply and one add per step, the kernel's arithmetic)."""
    af, bf = a.float(), b.float()
    h = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    hv = torch.zeros((a.shape[0], a.shape[2]), dtype=torch.float32, device=a.device)
    for t in range(a.shape[1]):
        hv = af[:, t] * hv + bf[:, t]
        h[:, t] = hv
    return h


OP_FLOPS["rglru_scan"] = lambda a, b: 2.0 * a.numel()   # one multiply and one add a step


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry point of ``csrc/rglru_scan.cu``, built on first use."""
    fn = build.load("rglru_scan").rglru_scan_fwd
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 4
                   + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(a, b):
    """What the op takes; checked on every device, so the CPU tests reach it."""
    if a.dim() != 3 or b.shape != a.shape:
        raise ValueError(f"want a and b (B, S, D) of one shape, got {tuple(a.shape)},"
                         f" {tuple(b.shape)}")
    if b.device != a.device:
        raise ValueError(f"b is on {b.device}, a on {a.device}")
    if a.dtype not in _DTYPE_CODES or b.dtype != a.dtype:
        raise TypeError(f"a and b must share one of {list(_DTYPE_CODES)}, got {a.dtype},"
                        f" {b.dtype}")


@torch.library.custom_op("repro_torch::rglru_scan", mutates_args=(), device_types="cpu")
def _rglru_scan_op(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    _check(a, b)
    return rglru_scan_plain(a, b)


@_rglru_scan_op.register_kernel("cuda")
def _rglru_scan_cuda(a, b):
    _check(a, b)
    for name, t in (("a", a), ("b", b)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have unit stride in its last dim, got"
                             f" strides {t.stride()}")
    Bn, S, D = a.shape
    h = torch.empty((Bn, S, D), dtype=torch.float32, device=a.device)
    if h.numel() == 0:
        return h
    err = _kernel()(a.data_ptr(), b.data_ptr(), h.data_ptr(), Bn, S, D,
                    a.stride(0), a.stride(1), b.stride(0), b.stride(1),
                    _DTYPE_CODES[a.dtype], torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan kernel launch failed: CUDA error {err}")
    rglru_scan.launches += 1
    return h


@_rglru_scan_op.register_fake
def _rglru_scan_fake(a, b):
    _check(a, b)
    return a.new_empty(a.shape, dtype=torch.float32)


def rglru_scan(a, b, *, chunk: int = 256):
    """a, b: (B, S, D) -> h (B, S, D) f32 with ``h_t = a_t h_{t-1} + b_t``.

    ``chunk`` is accepted for parity with the JAX wrapper and ignored: it
    sized the Mosaic blocks on the TPU and does not change the result.
    """
    del chunk
    if a.device.type == "cuda":
        refuse_grad("rglru_scan", a, b)
    return _rglru_scan_op(a, b)


rglru_scan.launches = 0
