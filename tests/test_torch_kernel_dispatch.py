"""Port kernel dispatch against the JAX package's on the same attention bodies.

The attention cases of ``tests/test_kernel_dispatch.py`` written as torch
functions: causal / non-causal x Kv x window, chunks that do not divide the
sequence, the True-means-masked mask convention, a GeGLU body that must not
match, ``kernel_dispatch='off'`` touching nothing, and ``mask_mode='bool'``
taking the bool-mask kernel.  The same numpy inputs go through the JAX
compiler (Pallas in interpret mode) and the port's (plain kernels on CPU
tensors); hit / miss / computed-mask counters agree, the wrappers are called
once per chunk, and outputs equal the undispatched chunk loop (1e-5).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ChunkConfig as JChunkConfig
from repro.core import autochunk as jautochunk
from repro.core import stats as jstats
from repro.models import layers as JL
from repro_torch.core import ChunkConfig, autochunk, stats
from repro_torch.kernels import chunked_attention as CA
from repro_torch.models import layers as L

torch.set_num_threads(2)
ATOL = 1e-5
COUNTERS = ("kernel_dispatch_hits", "kernel_dispatch_misses", "kernel_dispatch_computed_mask")


def _attn(S, causal, window=None):
    def attn(qkv):
        q, k, v = qkv
        pos = torch.arange(S, device=q.device)
        return L.gqa_attention(q, k, v, q_pos=pos, kv_pos=pos, causal=causal, window=window)

    def jattn(qkv):
        q, k, v = qkv
        pos = jnp.arange(S)
        return JL.gqa_attention(q, k, v, q_pos=pos, kv_pos=pos, causal=causal, window=window)

    return attn, jattn


def _qkv(B=2, S=64, H=4, Kv=2, hd=8, seed=0):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s, dtype=np.float32)
            for s in ((B, S, H, hd), (B, S, Kv, hd), (B, S, Kv, hd))]
    return tuple(torch.from_numpy(a) for a in arrs), tuple(jnp.asarray(a) for a in arrs)


def _port(fn, args, *, kernel_dispatch, weight_argnums=(), **kw):
    cf = autochunk(fn, ChunkConfig(budget_ratio=0.3, weight_argnums=weight_argnums,
                                   kernel_dispatch=kernel_dispatch, **kw), bucketer=None)
    before = stats.snapshot()
    compiled = cf.trace(*args).search().compile()
    d = stats.delta(before)
    return compiled, {k: d[k] for k in COUNTERS}


def _jax(fn, args, *, kernel_dispatch, weight_argnums=(), **kw):
    cf = jautochunk(fn, JChunkConfig(budget_ratio=0.3, weight_argnums=weight_argnums,
                                     kernel_dispatch=kernel_dispatch, **kw), bucketer=None)
    before = jstats.snapshot()
    compiled = cf.trace(*args).search().compile()
    d = jstats.delta(before)
    return compiled, {k: d[k] for k in COUNTERS}


@pytest.fixture
def kernel_calls(monkeypatch):
    """Count calls of the two wrappers (on CPU tensors they run the plain
    versions; ``.launches`` counts kernel launches on the card only)."""
    calls = {"computed": 0, "masked": 0}
    for name, key in (("computed_attention", "computed"), ("masked_attention", "masked")):
        fn = getattr(CA, name)

        def spy(*a, _fn=fn, _key=key, **k):
            calls[_key] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(CA, name, spy)
    return calls


@pytest.mark.parametrize("causal,Kv,window", [
    (True, 2, None),    # causal + GQA
    (False, 4, None),   # full attention, MHA
    (True, 4, None),    # causal MHA
    (True, 2, 16),      # sliding window + GQA
])
def test_attention_dispatch_matches_loop_body_and_jax(causal, Kv, window, kernel_calls):
    S = 64
    attn, jattn = _attn(S, causal, window)
    qkv, jqkv = _qkv(S=S, Kv=Kv)
    y_ref = attn(qkv).numpy()
    off, _ = _port(attn, (qkv,), kernel_dispatch="off")
    on, counts = _port(attn, (qkv,), kernel_dispatch="on")
    _, jcounts = _jax(jattn, (jqkv,), kernel_dispatch="on")
    assert counts == jcounts
    assert counts["kernel_dispatch_hits"] >= 1
    y_off, y_on = off(qkv).numpy(), on(qkv).numpy()
    np.testing.assert_allclose(y_off, y_ref, atol=ATOL)
    np.testing.assert_allclose(y_on, y_off, atol=ATOL)
    loops = [r for r in on.result.plan]
    assert kernel_calls["computed"] == sum(r.n_chunks for r in loops) and not kernel_calls["masked"]


def test_attention_dispatch_non_divisible_chunks(kernel_calls):
    """S=60 never splits evenly into the powers of two the search prefers:
    the clamped last chunk must stay exact."""
    attn, jattn = _attn(60, True)
    qkv, jqkv = _qkv(S=60, Kv=2)
    on, counts = _port(attn, (qkv,), kernel_dispatch="on", beam=8)
    _, jcounts = _jax(jattn, (jqkv,), kernel_dispatch="on", beam=8)
    assert counts == jcounts
    np.testing.assert_allclose(on(qkv).numpy(), attn(qkv).numpy(), atol=ATOL)
    assert counts["kernel_dispatch_hits"] + counts["kernel_dispatch_misses"] >= 1
    assert kernel_calls["computed"] >= counts["kernel_dispatch_hits"]


def test_attention_dispatch_inverted_mask_convention(kernel_calls):
    """``where(banned, -1e30, scores)`` (True = masked) dispatches with the
    mask negated: the kernels' convention is True = attend."""
    B, S, H, hd = 2, 48, 2, 8

    def attn(qkv):
        q, k, v = qkv
        s = q.permute(0, 2, 1, 3) @ k.permute(0, 2, 3, 1) / math.sqrt(hd)
        banned = ~torch.tril(torch.ones((S, S), dtype=torch.bool, device=q.device))
        s = torch.where(banned, -1e30, s)
        return (torch.softmax(s, dim=-1) @ v.permute(0, 2, 1, 3)).permute(0, 2, 1, 3)

    def jattn(qkv):
        q, k, v = qkv
        s = jnp.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(hd)
        banned = ~jnp.tril(jnp.ones((S, S), bool))
        s = jnp.where(banned[None, None], -1e30, s)
        return jnp.einsum("bhqk,bkhd->bqhd", jax.nn.softmax(s, axis=-1), v)

    rng = np.random.default_rng(4)
    arrs = [rng.standard_normal((B, S, H, hd), dtype=np.float32) for _ in range(3)]
    qkv = tuple(torch.from_numpy(a) for a in arrs)
    on, counts = _port(attn, (qkv,), kernel_dispatch="on")
    _, jcounts = _jax(jattn, (tuple(jnp.asarray(a) for a in arrs),), kernel_dispatch="on")
    assert counts == jcounts and counts["kernel_dispatch_hits"] >= 1
    np.testing.assert_allclose(on(qkv).numpy(), attn(qkv).numpy(), atol=ATOL)
    # a tril mask is not position algebra the classifier evaluates (nor in
    # the JAX matcher): it streams as a bool mask
    assert kernel_calls["masked"] >= 1 and counts["kernel_dispatch_computed_mask"] == 0


def test_geglu_does_not_dispatch(kernel_calls):
    """A GELU-gated FFN is not attention (nor SwiGLU): nothing dispatches."""
    d, f = 32, 128
    rng = np.random.default_rng(2)
    w_np = {"w_in": rng.standard_normal((d, 2 * f), dtype=np.float32) * 0.1,
            "w_out": rng.standard_normal((f, d), dtype=np.float32) * 0.1}
    x_np = rng.standard_normal((2, 48, d), dtype=np.float32)

    def geglu(w, x):
        u, g = torch.chunk(x @ w["w_in"], 2, dim=-1)
        return (u * torch.nn.functional.gelu(g)) @ w["w_out"]

    def jgeglu(w, x):
        u, g = jnp.split(x @ w["w_in"], 2, axis=-1)
        return (u * jax.nn.gelu(g)) @ w["w_out"]

    w = {k: torch.from_numpy(v) for k, v in w_np.items()}
    x = torch.from_numpy(x_np)
    on, counts = _port(geglu, (w, x), kernel_dispatch="on", weight_argnums=(0,))
    _, jcounts = _jax(jgeglu, ({k: jnp.asarray(v) for k, v in w_np.items()},
                               jnp.asarray(x_np)), kernel_dispatch="on", weight_argnums=(0,))
    assert counts["kernel_dispatch_hits"] == jcounts["kernel_dispatch_hits"] == 0
    np.testing.assert_allclose(on(w, x).numpy(), geglu(w, x).numpy(), atol=ATOL)
    assert kernel_calls == {"computed": 0, "masked": 0}


def test_dispatch_off_never_touches_kernels(kernel_calls):
    attn, _ = _attn(64, True)
    qkv, _ = _qkv(S=64)
    off, counts = _port(attn, (qkv,), kernel_dispatch="off")
    off(qkv)
    assert counts == dict.fromkeys(COUNTERS, 0)
    assert kernel_calls == {"computed": 0, "masked": 0}


def test_bool_mask_mode_takes_the_masked_kernel(kernel_calls):
    attn, jattn = _attn(64, True)
    qkv, jqkv = _qkv(S=64)
    on, counts = _port(attn, (qkv,), kernel_dispatch="on", mask_mode="bool")
    _, jcounts = _jax(jattn, (jqkv,), kernel_dispatch="on", mask_mode="bool")
    assert counts == jcounts
    assert counts["kernel_dispatch_hits"] >= 1 and counts["kernel_dispatch_computed_mask"] == 0
    np.testing.assert_allclose(on(qkv).numpy(), attn(qkv).numpy(), atol=ATOL)
    assert kernel_calls["masked"] >= 1 and kernel_calls["computed"] == 0


def test_auto_resolves_to_cuda_availability():
    assert ChunkConfig(kernel_dispatch="auto").resolve_kernel_dispatch() \
        == torch.cuda.is_available()
    assert ChunkConfig(kernel_dispatch="on").resolve_kernel_dispatch() is True
    assert ChunkConfig(kernel_dispatch="off").resolve_kernel_dispatch() is False
    assert ChunkConfig(kernel_dispatch="on").cache_token() \
        != ChunkConfig(kernel_dispatch="off").cache_token()
