"""Fused attention over one chunk of queries: the compiler's dispatch targets.

Kernel dispatch (``core.kernel_dispatch``) swaps a matched softmax-attention
chunk-loop body for one of two functions, in the JAX package's flat layout:

* :func:`computed_attention` -- ``q`` (N*group, Sq, hd), ``k``/``v``
  (N, Skv, hd); query row ``a`` sits at kv position ``q_offset + a`` and the
  causal / sliding-window predicate is computed from positions.  Kv tiles the
  band cannot reach are never visited.
* :func:`masked_attention` -- the same with an explicit bool ``mask``
  (Nm, Sq, Skv), Nm in {1, N*group} (True = attend).  In bf16 the kernel
  skips the kv tiles where a query tile's mask is all False, unless a row
  of that tile has no live key at all (it averages every V).

Query head ``n`` attends with kv head ``n // group`` (native GQA: K and V are
not repeated).  Masked logits are ``-1e30`` and the output is
``acc / max(l, 1e-30)``, so a row whose visited keys are all masked gets the
mean of their V, as the Pallas kernels give.  For :func:`computed_attention`
"visited" means the kv tiles of ``BLOCK_KV`` keys that the band reaches from
the row's tile of ``BLOCK_Q`` queries, which is what the tile skip of the
TPU kernel does at its own block sizes.

On a CUDA tensor each wrapper launches the hand-written kernel in
``csrc/chunked_attention.cu`` (or raises); on a CPU tensor it runs the plain
PyTorch version beside it.  Each wrapper counts its kernel launches in
``.launches``.  The source routes by dtype: bf16 runs on the tensor cores
(wgmma, P in registers as bf16 hi + lo; a mask is first classified by
tiles into a workspace of :func:`masked_workspace_bytes`); f32 runs on
CUDA-core f32 FMAs.  Both kernels walk the same 64 x 64 tiles
(:data:`BLOCK_Q`, :data:`BLOCK_KV`).  :func:`cuda_refusal` states the head
dims the kernels take, for the wrappers and for kernel dispatch.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import build

NEG_INF = -1e30
BLOCK_Q = 64     # query rows per thread block of the CUDA kernel
BLOCK_KV = 64    # keys per staged tile of the CUDA kernel

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 80, 96, 128, 256)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _softmax_av(s, v, visited=None):
    """``acc / max(l, 1e-30)`` of the online softmax, in one pass: ``s``
    (..., Sq, Skv) f32 logits with masked entries at -1e30; keys outside
    ``visited`` carry weight 0."""
    if visited is not None:
        s = torch.where(visited, s, float("-inf"))
    m = s.amax(dim=-1, keepdim=True).clamp_min(NEG_INF)
    p = torch.exp(s - m)
    return (p @ v) / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)


def _repeat_kv(k, group):
    return k if group == 1 else k.repeat_interleave(group, dim=0)


def band_tiles(Sq: int, Skv: int, q_offset: int, *, causal: bool, window,
               block_q: int = BLOCK_Q, block_kv: int = BLOCK_KV):
    """(lo, hi) kv-tile range visited by each query tile, as lists."""
    n_tiles = -(-Skv // block_kv)
    los, his = [], []
    for q0 in range(0, Sq, block_q):
        q_end = min(q0 + block_q, Sq)
        hi = n_tiles
        if causal:
            last = q_offset + q_end - 1
            hi = 0 if last < 0 else min(n_tiles, last // block_kv + 1)
        lo = max(0, (q_offset + q0 - (window - 1)) // block_kv) if window else 0
        los.append(lo)
        his.append(hi)
    return los, his


def computed_attention_plain(q, k, v, q_offset=None, *, scale: float, causal: bool = True,
                             window: Optional[int] = None, group: int = 1,
                             block_q: int = BLOCK_Q, block_kv: int = BLOCK_KV):
    """Plain PyTorch version of the computed-mask kernel (same signature).

    ``block_q``/``block_kv`` are the tile sizes whose band decides which keys a
    row visits; they default to the CUDA kernel's, and the tests pass the
    Pallas kernel's to compare with it on rows that see no live key.
    """
    Nq, Sq, hd = q.shape
    Skv = k.shape[1]
    if q_offset is None:
        q_offset = Skv - Sq
    q_offset = int(q_offset)
    dev = q.device
    s = (q.float() @ _repeat_kv(k, group).float().transpose(1, 2)) * scale
    qpos = q_offset + torch.arange(Sq, device=dev)[:, None]
    kpos = torch.arange(Skv, device=dev)[None, :]
    live = torch.ones((Sq, Skv), dtype=torch.bool, device=dev)
    if causal:
        live = live & (kpos <= qpos)
    if window is not None:
        live = live & (qpos - kpos < window)
    s = torch.where(live, s, NEG_INF)
    los, his = band_tiles(Sq, Skv, q_offset, causal=causal, window=window,
                          block_q=block_q, block_kv=block_kv)
    tile = torch.arange(Skv, device=dev) // block_kv                      # (Skv,)
    row_tile = torch.arange(Sq, device=dev) // block_q                    # (Sq,)
    lo = torch.tensor(los, device=dev)[row_tile][:, None]
    hi = torch.tensor(his, device=dev)[row_tile][:, None]
    visited = (tile[None, :] >= lo) & (tile[None, :] < hi)
    out = _softmax_av(s, _repeat_kv(v, group).float(), visited)
    return out.to(q.dtype)


def masked_attention_plain(q, k, v, mask, *, scale: float, group: int = 1):
    """Plain PyTorch version of the bool-mask kernel (same signature)."""
    s = (q.float() @ _repeat_kv(k, group).float().transpose(1, 2)) * scale
    s = torch.where(mask, s, NEG_INF)
    return _softmax_av(s, _repeat_kv(v, group).float()).to(q.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _kernels():
    """The two C entry points of ``csrc/chunked_attention.cu``, built on first use."""
    lib = build.load("chunked_attention")
    computed = lib.computed_attention_fwd
    computed.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    computed.restype = ctypes.c_int
    masked = lib.masked_attention_fwd
    masked.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p]
    masked.restype = ctypes.c_int
    return computed, masked


def _check(q, k, v, group, mask=None):
    """What the kernels take; checked on every device, so the CPU tests reach it."""
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape:
        raise ValueError(f"want q (N*group, Sq, hd), k/v (N, Skv, hd); got"
                         f" {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    Nq, Sq, hd = q.shape
    N, Skv, hd_k = k.shape
    if group < 1 or Nq != N * group or hd_k != hd:
        raise ValueError(f"q heads {Nq} != kv heads {N} x group {group}, or hd differs")
    for name, t in (("k", k), ("v", v), ("mask", mask)):
        if t is not None and t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share a dtype in {list(_DTYPE_CODES)}, got"
                        f" {q.dtype}/{k.dtype}/{v.dtype}")
    if mask is not None:
        if mask.dtype != torch.bool or mask.dim() != 3 or mask.shape[1:] != (Sq, Skv) \
                or mask.shape[0] not in (1, Nq):
            raise ValueError(f"mask must be bool (1 or {Nq}, {Sq}, {Skv}), got"
                             f" {mask.dtype} {tuple(mask.shape)}")


def masked_workspace_bytes(mask_heads: int, Sq: int, Skv: int, dtype: torch.dtype) -> int:
    """Device bytes a CUDA :func:`masked_attention` call allocates besides
    its output: for bf16, the mask's tile classes, visit lists and 64 x 64
    bit tiles (about an eighth of the mask); f32 allocates none."""
    if dtype == torch.float32:
        return 0
    n_qt, n_kt = -(-Sq // BLOCK_Q), -(-Skv // BLOCK_KV)
    tiles = mask_heads * n_qt * n_kt
    return tiles * (64 * 8 + 4 + 1) + mask_heads * n_qt * 4 + mask_heads * Sq


def cuda_refusal(hd: int) -> Optional[str]:
    """Why the CUDA kernels (both of them) refuse head dim ``hd``, or None
    if they take it.  The wrappers raise with this message on a CUDA tensor;
    kernel dispatch refuses a site targeted at the card with it."""
    if hd not in _HEAD_DIMS:
        return f"the CUDA kernel takes hd in {_HEAD_DIMS}, got {hd}"
    return None


def _cuda_ready(q, k, v, mask=None):
    """What the CUDA kernels take beyond :func:`_check`; raises on anything
    else, the device last."""
    why = cuda_refusal(q.shape[-1])
    if why is not None:
        raise ValueError(why)
    for name, t in (("q", q), ("k", k), ("v", v), ("mask", mask)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")


def computed_attention(q, k, v, q_offset=None, *, scale: float, causal: bool = True,
                       window: Optional[int] = None, group: int = 1,
                       block_q: int = 128, block_kv: int = 128, buffer_depth: int = 2):
    """Fused attention with the mask computed from positions.

    ``q`` (N*group, Sq, hd); ``k``/``v`` (N, Skv, hd).  ``q_offset`` is the kv
    position of query row 0, a Python int (default ``Skv - Sq``: queries
    right-aligned to the keys).  Returns (N*group, Sq, hd) in q's dtype.

    ``block_q``, ``block_kv`` and ``buffer_depth`` are accepted for signature
    parity with the JAX wrapper and ignored: they sized the Mosaic blocks and
    DMA buffers on the TPU; the CUDA kernel has fixed 64 x 64 tiles.
    """
    del block_q, block_kv, buffer_depth
    _check(q, k, v, group)
    Nq, Sq, hd = q.shape
    Skv = k.shape[1]
    if q_offset is None:
        q_offset = Skv - Sq
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if q.device.type == "cpu":
        return computed_attention_plain(q, k, v, q_offset, scale=scale, causal=causal,
                                        window=window, group=group)
    _cuda_ready(q, k, v)
    out = torch.empty_like(q)
    if out.numel() == 0 or Skv == 0:
        return out.zero_()
    err = _kernels()[0](q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                        Nq, group, Sq, Skv, hd, int(q_offset), int(bool(causal)),
                        int(window or 0), float(scale), _DTYPE_CODES[q.dtype],
                        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"computed_attention kernel launch failed: CUDA error {err}")
    computed_attention.launches += 1
    return out


def masked_attention(q, k, v, mask, *, scale: float, group: int = 1,
                     block_q: int = 128, block_kv: int = 128, buffer_depth: int = 2):
    """Fused attention with an explicit bool mask (Nm, Sq, Skv), Nm in
    {1, N*group}.  Tile arguments as in :func:`computed_attention`: accepted
    and ignored."""
    del block_q, block_kv, buffer_depth
    _check(q, k, v, group, mask)
    if q.device.type == "cpu":
        return masked_attention_plain(q, k, v, mask, scale=scale, group=group)
    _cuda_ready(q, k, v, mask)
    Nq, Sq, hd = q.shape
    Skv = k.shape[1]
    out = torch.empty_like(q)
    if out.numel() == 0 or Skv == 0:
        return out.zero_()
    ws_bytes = masked_workspace_bytes(mask.shape[0], Sq, Skv, q.dtype)
    ws = torch.empty(ws_bytes, dtype=torch.uint8, device=q.device) if ws_bytes else None
    err = _kernels()[1](q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
                        out.data_ptr(), Nq, group, Sq, Skv, hd, mask.shape[0],
                        float(scale), _DTYPE_CODES[q.dtype],
                        0 if ws is None else ws.data_ptr(), ws_bytes,
                        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"masked_attention kernel launch failed: CUDA error {err}")
    masked_attention.launches += 1
    return out


computed_attention.launches = 0
masked_attention.launches = 0
