"""Port kernel dispatch against the JAX package's on the same bodies.

The attention cases of ``tests/test_kernel_dispatch.py`` written as torch
functions: causal / non-causal x Kv x window, chunks that do not divide the
sequence, the True-means-masked mask convention, a GeGLU body that must not
match, ``kernel_dispatch='off'`` touching nothing, and ``mask_mode='bool'``
taking the bool-mask kernel.  The same numpy inputs go through the JAX
compiler (Pallas in interpret mode) and the port's (plain kernels on CPU
tensors); hit / miss / computed-mask counters agree, the wrappers are called
once per chunk, and outputs equal the undispatched chunk loop (1e-5).

The SwiGLU cases: the fused ``w_in`` split by ``torch.chunk`` (the form
``layers.mlp`` writes) dispatches in the port, where the JAX matcher misses
it (ROADMAP C-ref-1), so it is held against JAX's eager function; separate
weights at an odd length of 17 dispatch in both; ``g * sigmoid(g)`` matches
like ``silu``; a GELU-gated body inside a chunk loop does not match;
selection charges a SwiGLU candidate the kernel's bytes.
The port's linear layers merge the batch into the rows (``view(B*S, d)``),
so a chunk flows through them at batch 1 only: the SwiGLU cases use one
sequence where the JAX tests use two.
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
from repro_torch.core.estimation import estimate_memory
from repro_torch.core.graph import op_name, trace
from repro_torch.core.kernel_dispatch import annotate_candidates
from repro_torch.core.lowering import is_chunk_loop
from repro_torch.core.search import search_chunks
from repro_torch.kernels import chunked_attention as CA
from repro_torch.kernels import chunked_ffn as CF
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


def test_geglu_in_a_chunk_loop_does_not_dispatch(kernel_calls, ffn_calls):
    """At batch 1 the chunk flows through the linear layers, so the GELU-gated
    body does reach a chunk loop; the SwiGLU matcher refuses it (as JAX's
    does) and the loop keeps its generic body."""
    d, f = 32, 128
    rng = np.random.default_rng(5)
    w_np = {"w_in": rng.standard_normal((d, 2 * f), dtype=np.float32) * 0.1,
            "w_out": rng.standard_normal((f, d), dtype=np.float32) * 0.1}
    x_np = rng.standard_normal((1, 48, d), dtype=np.float32)

    def geglu(w, x):
        u, g = torch.chunk(x @ w["w_in"], 2, dim=-1)
        return (u * torch.nn.functional.gelu(g)) @ w["w_out"]

    def jgeglu(w, x):
        u, g = jnp.split(x @ w["w_in"], 2, axis=-1)
        return (u * jax.nn.gelu(g)) @ w["w_out"]

    w = {k: torch.from_numpy(v) for k, v in w_np.items()}
    x = torch.from_numpy(x_np)
    cf = autochunk(geglu, ChunkConfig(budget_ratio=0.3, weight_argnums=(0,),
                                      kernel_dispatch="on"), bucketer=None)
    before = stats.snapshot()
    planned = cf.trace(w, x).search()
    on = planned.compile()
    counts = {k: v for k, v in stats.delta(before).items() if k in COUNTERS}
    loops = [n for n in planned.graph.nodes if is_chunk_loop(n)]
    assert any(op_name(op.node) == "gelu" for n in loops for op in n.params["body"])
    assert not any(n.params["dispatches"] for n in loops)
    _, jcounts = _jax(jgeglu, ({k: jnp.asarray(v) for k, v in w_np.items()},
                               jnp.asarray(x_np)), kernel_dispatch="on", weight_argnums=(0,))
    assert counts["kernel_dispatch_hits"] == jcounts["kernel_dispatch_hits"] == 0
    assert counts["kernel_dispatch_misses"] >= 1
    off, _ = _port(geglu, (w, x), kernel_dispatch="off", weight_argnums=(0,))
    y_on = on(w, x).numpy()
    np.testing.assert_allclose(y_on, off(w, x).numpy(), atol=ATOL)
    np.testing.assert_allclose(y_on, geglu(w, x).numpy(), atol=ATOL)
    assert ffn_calls["n"] == 0 and kernel_calls == {"computed": 0, "masked": 0}


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


# ---------------------------------------------------------------------------
# SwiGLU
# ---------------------------------------------------------------------------

@pytest.fixture
def ffn_calls(monkeypatch):
    """Count calls of the chunked_ffn wrapper (plain version on CPU tensors)."""
    calls = {"n": 0}
    fn = CF.chunked_ffn

    def spy(*a, **k):
        calls["n"] += 1
        return fn(*a, **k)

    monkeypatch.setattr(CF, "chunked_ffn", spy)
    return calls


def _swiglu_weights(d, f, seed, fused=True):
    rng = np.random.default_rng(seed)
    shapes = {"w_in": (d, 2 * f), "w_out": (f, d)} if fused else \
        {"wg": (d, f), "wu": (d, f), "wd": (f, d)}
    w_np = {k: rng.standard_normal(s, dtype=np.float32) * 0.1 for k, s in shapes.items()}
    return w_np, {k: torch.from_numpy(v) for k, v in w_np.items()}


def _swiglu_fused(w, x):
    u, g = torch.chunk(x @ w["w_in"], 2, dim=-1)
    return (u * torch.nn.functional.silu(g)) @ w["w_out"]


def _swiglu_sliced(w, x):
    h = x @ w["w_in"]
    f = h.shape[-1] // 2
    return (h[..., :f] * torch.nn.functional.silu(h[..., f:])) @ w["w_out"]


def _swiglu_sigmoid(w, x):
    u, g = torch.chunk(x @ w["w_in"], 2, dim=-1)
    return (u * (g * torch.sigmoid(g))) @ w["w_out"]


def _jswiglu_fused(w, x):
    u, g = jnp.split(x @ w["w_in"], 2, axis=-1)
    return (u * jax.nn.silu(g)) @ w["w_out"]


@pytest.mark.parametrize("fn", [_swiglu_fused, _swiglu_sliced, _swiglu_sigmoid],
                         ids=["chunk", "slices", "mul-sigmoid"])
def test_swiglu_dispatch_fused_w_in(fn, ffn_calls):
    """The fused ``w_in`` dispatches once in the port (the JAX matcher misses
    ``jnp.split``: C-ref-1, so the JAX side is its eager function)."""
    d, f = 32, 256
    w_np, w = _swiglu_weights(d, f, seed=0)
    x_np = np.random.default_rng(10).standard_normal((1, 48, d), dtype=np.float32)
    x = torch.from_numpy(x_np)
    y_ref = np.asarray(_jswiglu_fused({k: jnp.asarray(v) for k, v in w_np.items()},
                                      jnp.asarray(x_np)))
    off, _ = _port(fn, (w, x), kernel_dispatch="off", weight_argnums=(0,))
    on, counts = _port(fn, (w, x), kernel_dispatch="on", weight_argnums=(0,))
    assert counts["kernel_dispatch_hits"] == 1 and counts["kernel_dispatch_misses"] == 0
    y_off, y_on = off(w, x).numpy(), on(w, x).numpy()
    np.testing.assert_allclose(fn(w, x).numpy(), y_ref, atol=ATOL)
    np.testing.assert_allclose(y_on, y_off, atol=ATOL)
    np.testing.assert_allclose(y_on, y_ref, atol=ATOL)
    assert ffn_calls["n"] == sum(r.n_chunks for r in on.result.plan) >= 2


def test_swiglu_dispatch_split_weights_odd_seq(ffn_calls):
    d, f = 32, 256
    w_np, w = _swiglu_weights(d, f, seed=1, fused=False)
    x_np = np.random.default_rng(11).standard_normal((1, 17, d), dtype=np.float32)
    x = torch.from_numpy(x_np)

    def split(w, x):
        return (torch.nn.functional.silu(x @ w["wg"]) * (x @ w["wu"])) @ w["wd"]

    def jsplit(w, x):
        return (jax.nn.silu(x @ w["wg"]) * (x @ w["wu"])) @ w["wd"]

    on, counts = _port(split, (w, x), kernel_dispatch="on", weight_argnums=(0,))
    jw = {k: jnp.asarray(v) for k, v in w_np.items()}
    jon, jcounts = _jax(jsplit, (jw, jnp.asarray(x_np)), kernel_dispatch="on",
                        weight_argnums=(0,))
    assert counts["kernel_dispatch_hits"] == jcounts["kernel_dispatch_hits"] == 1
    y_ref = np.asarray(jsplit(jw, jnp.asarray(x_np)))
    np.testing.assert_allclose(on(w, x).numpy(), y_ref, atol=ATOL)
    np.testing.assert_allclose(np.asarray(jon.fn(jw, jnp.asarray(x_np))), y_ref, atol=ATOL)
    assert ffn_calls["n"] == sum(r.n_chunks for r in on.result.plan) >= 2


def test_annotate_charges_swiglu_kernel_bytes():
    """A candidate holding the whole SwiGLU is charged the kernel's output
    per chunk row (f32: no workspace), not the (c, 2f) gate/up slice the
    generic body would hold."""
    d, f, S = 32, 256, 48
    _, w = _swiglu_weights(d, f, seed=2)
    x = torch.zeros((1, S, d))
    g, _ = trace(_swiglu_fused, [w, x], weight_argnums=(0,))
    prof = estimate_memory(g)
    cands = search_chunks(g, prof)
    annotate_candidates(g, cands)
    whole = [c for c in cands if c.kernel_bytes is not None]
    assert whole, "no candidate holds the whole SwiGLU"
    for c in whole:
        n = 4
        ext = -(-c.chunk_extent // n)
        assert c.chunked_body_peak(n) == c.kernel_bytes(ext) == ext * d * 4
        assert c.kernel_bytes(ext) < ext * 2 * f * 4     # the gate/up slice
    # bf16: the f32 accumulator rides on top of the output
    gb, _ = trace(_swiglu_fused, [{k: v.bfloat16() for k, v in w.items()}, x.bfloat16()],
                  weight_argnums=(0,))
    cb = search_chunks(gb, estimate_memory(gb))
    annotate_candidates(gb, cb)
    kb = [c for c in cb if c.kernel_bytes is not None]
    assert kb and all(c.kernel_bytes(r) == r * (d * 2 + d * 4) for c in kb for r in (1, 17))


def test_swiglu_body_that_escapes_does_not_dispatch(ffn_calls):
    """If the gate/up product is read outside the match, the kernel cannot
    replace it: the body keeps its generic loop and the output is exact."""
    d, f = 32, 128
    _, w = _swiglu_weights(d, f, seed=3)
    x = torch.from_numpy(np.random.default_rng(12).standard_normal((1, 48, d),
                                                                   dtype=np.float32))

    def leaky(w, x):
        u, g = torch.chunk(x @ w["w_in"], 2, dim=-1)
        h = u * torch.nn.functional.silu(g)
        return h @ w["w_out"], h.sum(-1)

    on, counts = _port(leaky, (w, x), kernel_dispatch="on", weight_argnums=(0,))
    assert counts["kernel_dispatch_hits"] == 0
    for got, want in zip(on(w, x), leaky(w, x)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)
    assert ffn_calls["n"] == 0
