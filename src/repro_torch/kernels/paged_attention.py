"""Ragged paged attention: the paged serving step's kernel.

The KV pool (``serving.kv_pool``) stores fixed ``page_size`` pages in the
fused head-interleaved layout ``[K0,V0,K1,V1,..]`` on the head axis, with
one page table per sequence.  :func:`paged_attention_blocked` attends a
ragged batch of query rows against that pool in place:

* row ``s`` carries ``q_lens[s]`` query tokens (1 for decode rows, a
  planner-sized chunk for prefill rows) against ``kv_lens[s]`` context
  tokens, which already include the row's own new tokens;
* attention is causal within each sequence: query ``i`` of row ``s`` sits
  at position ``kv_lens[s] - q_lens[s] + i``.

On a CUDA tensor it launches the hand-written kernel in
``csrc/paged_attention.cu`` (or raises); on a CPU tensor it runs
:func:`paged_attention_blocked_plain`, the same function in plain PyTorch.
Query rows at or past ``q_lens[s]`` come back as zeros on both paths.

The kernel splits the keys of each row's first query tile (all of a decode
row's queries) into ranges of :func:`split_plan`'s size, computes a partial
softmax per range and merges the partials with log-sum-exp weights
(flash-decoding); the split count comes from the page table's width, never
from ``kv_lens``, so the host never waits for the device.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from . import build, refuse_grad

NEG_INF = -1e30

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 96, 128, 256)
SPLIT_KEYS = 256   # keys per split, rounded up to whole pages


def split_plan(page_size: int, max_pages: int):
    """(n_split, split_keys) of a launch, from the page table's shape alone:
    its ``max_pages * page_size`` keys in ranges of :data:`SPLIT_KEYS`
    rounded up to whole pages (one range if that covers them)."""
    split_keys = -(-SPLIT_KEYS // page_size) * page_size
    width = max_pages * page_size
    if width <= split_keys:
        return 1, width
    return -(-width // split_keys), split_keys


def query_tile(q_max: int, group: int) -> int:
    """Query vectors a kernel block takes: the least of 1, 4, 8 that holds
    a row's ``q_max * group`` vectors of one kv head, else 8."""
    n = q_max * group
    return 1 if n <= 1 else 4 if n <= 4 else 8


def interleave_kv(k, v):
    """Fuse K/V into the pool's layout: (..., Kv, hd) -> (..., 2*Kv, hd)
    ordered [K0,V0,K1,V1,..]."""
    Kv, hd = k.shape[-2:]
    return torch.stack([k, v], dim=-2).reshape(*k.shape[:-2], 2 * Kv, hd)


def split_kv(pages):
    """Inverse of :func:`interleave_kv`: (..., 2*Kv, hd) -> k, v."""
    two_kv, hd = pages.shape[-2:]
    kv = pages.reshape(*pages.shape[:-2], two_kv // 2, 2, hd)
    return kv[..., 0, :], kv[..., 1, :]


def paged_attention_blocked_plain(q, kv_pages, page_table, q_lens, kv_lens, *,
                                  scale: Optional[float] = None):
    """Plain PyTorch version of the kernel: gather every row's pages into a
    dense KV and run masked f32 softmax attention.  Same signature, same
    outputs (padding rows are zeros)."""
    S, q_max, H, hd = q.shape
    P, page_size, two_kv, _ = kv_pages.shape
    Kv = two_kv // 2
    G = H // Kv
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    dev = q.device
    table = page_table.long().clamp(0, P - 1)
    L = table.shape[1] * page_size
    k, v = split_kv(kv_pages[table].reshape(S, L, two_kv, hd).float())  # (S,L,Kv,hd)
    qg = q.float().reshape(S, q_max, Kv, G, hd)
    logits = torch.einsum("sqkgd,slkd->skgql", qg, k) * scale
    q_lens = q_lens.long()
    kv_lens = kv_lens.long()
    qpos = (kv_lens - q_lens)[:, None] + torch.arange(q_max, device=dev)[None, :]
    kpos = torch.arange(L, device=dev)
    mask = (kpos[None, None, :] <= qpos[:, :, None]) & (
        kpos[None, None, :] < kv_lens[:, None, None])                  # (S,q_max,L)
    logits = torch.where(mask[:, None, None], logits, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1)                                                  # (S,Kv,G,q_max)
    acc = torch.einsum("skgql,slkd->sqkgd", p, v)
    out = acc / l.clamp_min(1e-30).permute(0, 3, 1, 2)[..., None]
    real = torch.arange(q_max, device=dev)[None, :] < q_lens[:, None]
    out = torch.where(real[:, :, None, None, None], out, 0.0)
    return out.reshape(S, q_max, H, hd).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry point of ``csrc/paged_attention.cu``, built on first use."""
    fn = build.load("paged_attention").paged_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 11 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def cuda_refusal(hd: int) -> Optional[str]:
    """Why the CUDA kernel refuses head dim ``hd``, or None if it takes it.
    The wrapper raises with this message on a CUDA tensor, and the paged
    engine asks it when it is built for the card; the plain version on the
    CPU takes every head dim, as the JAX kernel does."""
    if hd not in _HEAD_DIMS:
        return f"the CUDA paged-attention kernel takes hd in {_HEAD_DIMS}, got {hd}"
    return None


def _check_args(q, kv_pages, page_table, q_lens, kv_lens):
    """What the function takes (any head dim); checked on every device, so
    the CPU tests reach it too.  What only the CUDA kernel refuses is
    :func:`cuda_refusal`'s."""
    S, q_max, H, hd = q.shape
    P, page_size, two_kv, hd_kv = kv_pages.shape
    for name, t in (("kv_pages", kv_pages), ("page_table", page_table),
                    ("q_lens", q_lens), ("kv_lens", kv_lens)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if q.dtype not in _DTYPE_CODES or kv_pages.dtype != q.dtype:
        raise TypeError(f"q/kv_pages must share a dtype in {list(_DTYPE_CODES)},"
                        f" got {q.dtype}/{kv_pages.dtype}")
    if hd_kv != hd or two_kv % 2 or H % max(two_kv // 2, 1):
        raise ValueError(f"unsupported shapes q={tuple(q.shape)}"
                         f" kv_pages={tuple(kv_pages.shape)}")
    if page_table.dim() != 2 or page_table.shape[0] != S or q_lens.shape != (S,) \
            or kv_lens.shape != (S,):
        raise ValueError("page_table must be (S, max_pages), q_lens/kv_lens (S,)")
    if not (q.is_contiguous() and kv_pages.is_contiguous()):
        raise ValueError("q and kv_pages must be contiguous")


def paged_attention_blocked(q, kv_pages, page_table, q_lens, kv_lens, *,
                            scale: Optional[float] = None,
                            pages_per_step: int = 1):
    """Ragged paged attention over per-sequence-blocked queries.

    ``q``: (S, q_max, H, hd), row ``s`` holding ``q_lens[s]`` real tokens
    (left-aligned).  ``kv_pages``: (P, page_size, 2*Kv, hd) in the
    interleaved layout.  ``page_table``: (S, max_pages) int; entries past a
    row's page count are never read.  ``q_lens``/``kv_lens``: (S,) int.
    Returns (S, q_max, H, hd) in q's dtype, zeros on padding rows.

    ``pages_per_step`` is accepted for signature parity with the JAX
    wrapper and ignored: it sized the Mosaic DMA step on the TPU, and the
    CUDA kernel splits the keys by :func:`split_plan`.
    """
    del pages_per_step
    _check_args(q, kv_pages, page_table, q_lens, kv_lens)
    if q.device.type == "cpu":
        return paged_attention_blocked_plain(q, kv_pages, page_table, q_lens,
                                             kv_lens, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_blocked: no kernel for device {q.device}")
    refuse_grad("paged_attention_blocked", q, kv_pages)
    S, q_max, H, hd = q.shape
    why = cuda_refusal(hd)
    if why is not None:
        raise ValueError(why)
    P, page_size, two_kv, _ = kv_pages.shape
    page_table = page_table.to(torch.int32).contiguous()
    q_lens = q_lens.to(torch.int32).contiguous()
    kv_lens = kv_lens.to(torch.int32).contiguous()
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    if q.data_ptr() % 16 or kv_pages.data_ptr() % 16:
        raise ValueError("q and kv_pages must be 16-byte aligned (the kernel reads 16-byte words)")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    Kv = two_kv // 2
    vt = query_tile(q_max, H // Kv)
    n_split, split_keys = split_plan(page_size, page_table.shape[1])
    # the partials (acc, then (m, l) pairs) of each row's first query tile
    ws = (torch.empty(S * Kv * vt * n_split * (hd + 2), dtype=torch.float32,
                      device=q.device) if n_split > 1 else None)
    err = _kernel()(q.data_ptr(), kv_pages.data_ptr(), page_table.data_ptr(),
                    q_lens.data_ptr(), kv_lens.data_ptr(), out.data_ptr(),
                    None if ws is None else ws.data_ptr(),
                    S, q_max, H, Kv, hd, P, page_size, page_table.shape[1], vt,
                    n_split, split_keys, float(scale), _DTYPE_CODES[q.dtype],
                    torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA error {err}")
    paged_attention_blocked.launches += 1
    return out


paged_attention_blocked.launches = 0
