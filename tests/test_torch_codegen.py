"""Port one-shot ``build_chunked_fn`` against the unchunked function and the JAX package.

The cases of the JAX package's property tests (``test_core_autochunk.py``,
``test_core_padded_chunks.py``) on fixed seeds: every one of the first
candidates the search finds, at its first chunk counts, computes the
unchunked function within 1e-5; counts that do not divide the extent stay
exact through the clamped last chunk; and each output is held against the
JAX function on the same numpy inputs.  The per-stage closure and the
lowering backend's rewrite + emit give the same result.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import (
    apply_chunk,
    build_chunked_fn,
    emit,
    estimate_memory,
    search_chunks,
    stats,
    trace,
)

torch.set_num_threads(2)


def _f(w, x):
    h = torch.tanh(x @ w["a"])
    return torch.softmax(h, dim=-1) @ w["b"] + x


def _jf(w, x):
    h = jnp.tanh(x @ w["a"])
    return jax.nn.softmax(h, axis=-1) @ w["b"] + x


def _setup(s, d, seed, batch=2):
    rng = np.random.default_rng(seed)
    w = {"a": rng.standard_normal((d, 2 * d), dtype=np.float32) * 0.2,
         "b": rng.standard_normal((2 * d, d), dtype=np.float32) * 0.2}
    x = rng.standard_normal((batch, s, d), dtype=np.float32)
    tw = {k: torch.from_numpy(v) for k, v in w.items()}
    leaves = [tw["a"], tw["b"], torch.from_numpy(x)]

    def flat_fn(a, b, xx):
        return (_f({"a": a, "b": b}, xx),)

    g, _ = trace(flat_fn, leaves, weight_argnums=())
    return g, leaves, np.asarray(_jf(w, x))


@pytest.mark.parametrize("seed,s,d", [(0, 16, 8), (1, 24, 16), (2, 32, 8), (3, 48, 16)])
def test_any_candidate_is_output_preserving(seed, s, d):
    g, leaves, want = _setup(s, d, seed)
    y0 = _f({"a": leaves[0], "b": leaves[1]}, leaves[2]).numpy()
    np.testing.assert_allclose(y0, want, atol=1e-5)
    cands = search_chunks(g, estimate_memory(g), window=32)
    assert cands
    before = stats.snapshot()
    checked = 0
    for cand in cands[:8]:
        for n in cand.divisors()[:2]:
            y1 = build_chunked_fn(g, cand, n)(*leaves)[0].numpy()
            np.testing.assert_allclose(y1, y0, atol=1e-5)
            np.testing.assert_allclose(y1, want, atol=1e-5)
            checked += 1
    assert checked > 0 and stats.delta(before)["codegen_calls"] == checked


@pytest.mark.parametrize("s,n", [(17, 4), (100, 3), (33, 32), (7, 2), (64, 5)])
def test_non_divisible_chunk_counts_exact(s, n):
    g, leaves, want = _setup(s, 16, 0, batch=1)
    cands = [c for c in search_chunks(g, estimate_memory(g), window=32) if c.chunk_extent == s]
    assert cands, "expected a sequence-extent candidate"
    y = build_chunked_fn(g, cands[0], n)(*leaves)[0].numpy()
    np.testing.assert_allclose(y, want, atol=1e-5)


def test_closure_equals_the_lowering_rewrite():
    g, leaves, _ = _setup(48, 16, 5)
    cand = [c for c in search_chunks(g, estimate_memory(g), window=32)
            if c.chunk_extent == 48][0]
    before = stats.snapshot()
    y_closure = build_chunked_fn(g, cand, 4)(*leaves)[0]
    d = stats.delta(before)
    assert d["codegen_calls"] == 1 and d["lowering_rewrites"] == 0 and d["trace_calls"] == 0
    y_rewrite = emit(apply_chunk(g, cand, 4))(*leaves)[0]
    assert torch.equal(y_closure, y_rewrite)
