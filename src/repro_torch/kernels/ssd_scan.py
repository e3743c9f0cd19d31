"""Mamba-2 SSD chunked scan: the SSM block's kernel.

:func:`ssd_scan` computes the state-space-duality forward of the JAX
package's Pallas kernel ``_ssd_kernel`` for ``x`` (b, s, h, p), ``dt``
(b, s, h) after softplus, ``A`` (h,) negative and ``B``/``C`` (b, s, n):
per (b, h), the chunks of ``chunk`` rows in order; inside a chunk the
masked semiseparable block ``(C Bᵀ ∘ L ∘ dt) x`` with
``L[i, j] = exp(a_cum[i] - a_cum[j])`` for j <= i, plus
``(C ∘ exp(a_cum)) stateᵀ`` from the carried f32 (p, n) state; then
``state = exp(a_end) state + (x w)ᵀ B``.  f32 inside, y in x's dtype.  It
returns ``(y, final_state)`` with the state (b, h, p, n) in f32, which
``ssm_block`` hands on (the Pallas kernel keeps it in scratch and drops it).
A sequence whose length is not a multiple of ``chunk`` is padded with
``dt = 0`` rows, which leave the state as it was.

The op is registered as ``torch.ops.repro_torch.ssd_scan`` (a
``torch.library.custom_op``: the plain version for CPU tensors, the kernel
for CUDA tensors, and a fake implementation), so the AutoChunk compiler's
fake-mode trace keeps it as one node and the compiled block launches the
kernel.  On a CUDA tensor the op launches the hand-written kernel in
``csrc/ssd_scan.cu`` (or raises); on a CPU tensor it runs
:func:`ssd_scan_plain`, a port of the JAX package's ``ssd_chunked``.
``ssd_scan.launches`` counts the op's launches on the card (one a call).
bf16 inputs run the tensor-core kernel ``ssd_scan_mma_kernel``, f32 inputs
the CUDA-core ``ssd_scan_kernel`` (routing in ``ssd_scan_fwd``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import OP_FLOPS, build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the CUDA kernel holds one chunk in fixed tiles of these maxima (smaller
# shapes are zero-padded inside the tile)
MAX_CHUNK, MAX_HEAD_DIM, MAX_STATE = 128, 64, 128


def ssd_scan_plain(x, dt, A, B, C, chunk: int):
    """Plain PyTorch version (the JAX package's ``ssd_chunked``, same math):
    returns (y (b,s,h,p) in x's dtype, final state (b,h,p,n) f32)."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    if s % chunk:  # zero-pad: dt=0 steps are identities for the state
        pad = chunk - s % chunk
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        B = torch.nn.functional.pad(B, (0, 0, 0, pad))
        C = torch.nn.functional.pad(C, (0, 0, 0, pad))
        y, st = ssd_scan_plain(x, dt, A, B, C, chunk)
        return y[:, :s], st
    nc = s // chunk
    xc = x.reshape(b, nc, chunk, h, p).float()
    dtc = dt.reshape(b, nc, chunk, h).float()
    Bc = B.reshape(b, nc, chunk, n).float()
    Cc = C.reshape(b, nc, chunk, n).float()

    a = A.float()[None, None, None, :] * dtc                  # (b,nc,q,h), negative
    a_cum = torch.cumsum(a, dim=2)

    # --- intra-chunk (diagonal blocks) -----------------------------------
    seg = a_cum[:, :, :, None, :] - a_cum[:, :, None, :, :]   # (b,nc,i,j,h)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    L = torch.exp(torch.where(causal[None, None, :, :, None], seg, float("-inf")))
    cb = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    scores = cb[..., None] * L * dtc[:, :, None, :, :]        # (b,nc,i,j,h)
    y_diag = torch.einsum("bcijh,bcjhp->bcihp", scores, xc)

    # --- chunk states ------------------------------------------------------
    decay_states = torch.exp(a_cum[:, :, -1:, :] - a_cum)      # (b,nc,q,h)
    states = torch.einsum("bcjn,bcjh,bcjhp->bchpn", Bc, dtc * decay_states, xc)

    # --- inter-chunk recurrence -------------------------------------------
    chunk_decay = torch.exp(a_cum[:, :, -1, :])                # (b,nc,h)
    hprev = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    hprevs = []
    for c in range(nc):
        hprevs.append(hprev)
        hprev = chunk_decay[:, c, :, None, None] * hprev + states[:, c]
    hprevs = torch.stack(hprevs, dim=1)                        # (b,nc,h,p,n)

    y_off = torch.einsum("bcin,bchpn,bcih->bcihp", Cc, hprevs, torch.exp(a_cum))
    y = (y_diag + y_off).reshape(b, s, h, p)
    return y.to(x.dtype), hprev


def flops(x_shape, n: int, chunk: int) -> float:
    """Operations of one call, the compiler's cost model: per (b, h, chunk)
    ``C Bᵀ`` (2Q²N), the scores times x (2Q²P), the inter-chunk term
    (2QNP) and the state update (2PQN), at the padded length.  ``C Bᵀ`` is
    the same for every head and counted per head.  The bf16 kernel splits
    a head's P over blocks of 32 columns, each of which computes ``C Bᵀ``
    and the scores times x on the 16 x 16 blocks on and below the diagonal
    (36 of 64), and the two products that take an f32 operand twice (bf16
    hi + lo); the count stays the function's, not the kernel's."""
    b, s, h, p = x_shape
    q = chunk
    nc = -(-s // q)
    return float(b * h * nc * (2 * q * q * n + 2 * q * q * p + 4 * q * n * p))


OP_FLOPS["ssd_scan"] = lambda x, dt, A, B, C, chunk: flops(tuple(x.shape), B.shape[-1], chunk)


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry point of ``csrc/ssd_scan.cu``, built on first use."""
    fn = build.load("ssd_scan").ssd_scan_fwd
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 10
                   + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(x, dt, A, B, C, chunk):
    """What the op takes; checked on every device, so the CPU tests reach it."""
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or B.dim() != 3 or C.shape != B.shape:
        raise ValueError(f"want x (b,s,h,p), dt (b,s,h), A (h,), B/C (b,s,n); got"
                         f" {tuple(x.shape)}, {tuple(dt.shape)}, {tuple(A.shape)},"
                         f" {tuple(B.shape)}, {tuple(C.shape)}")
    b, s, h, _ = x.shape
    if tuple(dt.shape) != (b, s, h) or A.shape[0] != h or tuple(B.shape[:2]) != (b, s):
        raise ValueError(f"x {tuple(x.shape)}, dt {tuple(dt.shape)}, A {tuple(A.shape)} and"
                         f" B {tuple(B.shape)} disagree on b, s or h")
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    for name, t in (("dt", dt), ("A", A), ("B", B), ("C", C)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"x must be one of {list(_DTYPE_CODES)}, got {x.dtype}")
    if B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"B and C must be x's dtype {x.dtype}, got {B.dtype}, {C.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"dt and A must be float32, got {dt.dtype}, {A.dtype}")


def _outputs(x, n):
    b, s, h, p = x.shape
    return (x.new_empty((b, s, h, p)),
            x.new_empty((b, h, p, n), dtype=torch.float32))


@torch.library.custom_op("repro_torch::ssd_scan", mutates_args=(), device_types="cpu")
def _ssd_scan_op(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                 C: torch.Tensor, chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    _check(x, dt, A, B, C, chunk)
    return ssd_scan_plain(x, dt, A, B, C, chunk)


@_ssd_scan_op.register_kernel("cuda")
def _ssd_scan_cuda(x, dt, A, B, C, chunk):
    _check(x, dt, A, B, C, chunk)
    b, s, h, p = x.shape
    n = B.shape[-1]
    if chunk > MAX_CHUNK or p > MAX_HEAD_DIM or n > MAX_STATE:
        raise ValueError(f"the CUDA kernel takes chunk <= {MAX_CHUNK}, p <= {MAX_HEAD_DIM}"
                         f" and n <= {MAX_STATE}; got chunk {chunk}, p {p}, n {n}")
    for name, t in (("x", x), ("B", B), ("C", C)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have unit stride in its last dim, got"
                             f" strides {t.stride()}")
    if not A.is_contiguous():
        raise ValueError("A must be contiguous")
    if x.dtype == torch.bfloat16:
        # the tensor-core kernel copies whole 8-column (16-byte) pieces
        if p % 8 or n % 8:
            raise ValueError(f"the bf16 kernel takes p and n in multiples of 8, got p {p},"
                             f" n {n}")
        for name, t in (("x", x), ("B", B), ("C", C)):
            if t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:-1]):
                raise ValueError(f"the bf16 kernel reads {name} in 16-byte pieces: its address"
                                 f" and strides {t.stride()} must be 16-byte aligned")
    y, state = _outputs(x, n)
    if y.numel() == 0:
        return y, state.zero_()
    err = _kernel()(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
                    y.data_ptr(), state.data_ptr(), b, s, h, p, n, chunk,
                    x.stride(0), x.stride(1), x.stride(2), dt.stride(0), dt.stride(1),
                    dt.stride(2), B.stride(0), B.stride(1), C.stride(0), C.stride(1),
                    _DTYPE_CODES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {err}")
    ssd_scan.launches += 1
    return y, state


@_ssd_scan_op.register_fake
def _ssd_scan_fake(x, dt, A, B, C, chunk):
    _check(x, dt, A, B, C, chunk)
    return _outputs(x, B.shape[-1])


def ssd_scan(x, dt, A, B, C, *, chunk: int = 128):
    """(y (b,s,h,p) in x's dtype, final state (b,h,p,n) f32).

    ``x``, ``B`` and ``C`` may be strided views (unit stride in the last
    dim, as the column slices of the SSM block's conv output are): the
    kernel reads them in place.  The chunk is ``min(chunk, s)``, as the JAX
    wrapper takes it.
    """
    return _ssd_scan_op(x, dt, A, B, C, min(chunk, max(x.shape[1], 1)))


ssd_scan.launches = 0
