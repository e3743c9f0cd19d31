"""Synthetic data pipeline.

Seeded, deterministic token / frame / patch batches for every architecture
family, plus ``batch_specs``, the same batch as ``meta`` tensors (the
port's ShapeDtypeStructs).  Token streams follow a Zipfian marginal with
short-range structure (a copied half-window) so language-model training
losses fall meaningfully rather than flatlining at log(V).  The batches are
drawn with numpy exactly as the JAX package's ``data/synthetic.py`` draws
them, so one seed gives bit-equal tokens, labels, patches and frames in
both packages.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..device import resolve_device


def _zipf_tokens(rng: np.random.Generator, shape, vocab: int) -> np.ndarray:
    # Zipf over the vocab via inverse-CDF on precomputed weights
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    w = 1.0 / ranks
    cdf = np.cumsum(w) / w.sum()
    u = rng.random(shape)
    return np.searchsorted(cdf, u).astype(np.int32)


def make_batch(cfg: ModelConfig, batch: int, seq_len: int, *, seed: int = 0,
               with_labels: bool = True, device="cuda") -> Dict[str, torch.Tensor]:
    """One batch, drawn on the host and copied to ``device``: ``tokens``
    (B, S) int32 (``frames`` (B, S, d) f32 for audio), ``patches`` (B,
    n_frontend_tokens, d) f32 for vlm, and ``labels`` (B, S) int32, the
    tokens shifted left by one (wrapping)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    out: Dict[str, np.ndarray] = {}
    if cfg.family == "audio":
        out["frames"] = rng.standard_normal((batch, seq_len, cfg.d_model), dtype=np.float32)
        if with_labels:
            out["labels"] = rng.integers(0, cfg.vocab_size, (batch, seq_len), dtype=np.int32)
        return {k: torch.from_numpy(v).to(dev) for k, v in out.items()}

    tokens = _zipf_tokens(rng, (batch, seq_len), cfg.vocab_size)
    # inject short-range repetition structure: copy a shifted window
    if seq_len >= 8:
        half = seq_len // 2
        tokens[:, half: half + half // 2] = tokens[:, : half // 2]
    out["tokens"] = tokens
    if cfg.family == "vlm":
        out["patches"] = rng.standard_normal(
            (batch, cfg.n_frontend_tokens, cfg.d_model), dtype=np.float32) * 0.02
    if with_labels:
        out["labels"] = np.concatenate([tokens[:, 1:], tokens[:, :1]], axis=1)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in out.items()}


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, batch: int, seq_len: int, *,
                with_labels: bool = True) -> Dict[str, torch.Tensor]:
    """``meta`` tensors matching :func:`make_batch` (for a trace or a dry run)."""
    out: Dict[str, Any] = {}
    if cfg.family == "audio":
        out["frames"] = _meta((batch, seq_len, cfg.d_model), torch.float32)
        if with_labels:
            out["labels"] = _meta((batch, seq_len), torch.int32)
        return out
    out["tokens"] = _meta((batch, seq_len), torch.int32)
    if cfg.family == "vlm":
        out["patches"] = _meta((batch, cfg.n_frontend_tokens, cfg.d_model), torch.float32)
    if with_labels:
        out["labels"] = _meta((batch, seq_len), torch.int32)
    return out


def synthetic_stream(cfg: ModelConfig, batch: int, seq_len: int, *, seed: int = 0,
                     device="cuda") -> Iterator[Dict[str, torch.Tensor]]:
    """Batch ``i`` is ``make_batch(..., seed=seed + i)``."""
    step = 0
    while True:
        yield make_batch(cfg, batch, seq_len, seed=seed + step, device=device)
        step += 1
