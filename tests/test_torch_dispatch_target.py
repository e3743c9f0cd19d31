"""Kernel dispatch against the device it targets (ROADMAP C-1).

A site targeted at the card dispatches only where the CUDA kernel takes
its shapes: attention at hd 32, 64, 80, 96, 128 and 256
(``chunked_attention.cuda_refusal``), SwiGLU with d a multiple of 64 and f
of the FFN kernel's f tile (``chunked_ffn.cuda_refusal``).  A phi3-mini
block in float32 at its full width and S 8192, planned on ``meta`` for the
card at budget 0.03, chunks its attention as the JAX package's plan does
(ROADMAP C-3).  Elsewhere the site keeps its generic chunk
loop, counts a miss, and its output equals the undispatched program's.  The
compiles run here on CPU tensors with ``kernel_target='cuda'``; with the
default target, which follows the CPU inputs, the plain versions take any
shape and every site dispatches.  Outputs of the same program with and
without dispatch agree to 1e-5 (float32; the plain versions sum in another
order than the chunk loop).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import ChunkConfig, ChunkedFunction, autochunk, stats
from repro_torch.core.lowering import is_chunk_loop
from repro_torch.kernels import chunked_attention as CA
from repro_torch.kernels import chunked_ffn as CF
from repro_torch.models import layers as L
from repro_torch.models import model as M

torch.set_num_threads(2)
ATOL = 1e-5
COUNTERS = ("kernel_dispatch_hits", "kernel_dispatch_misses")


def _compile(fn, args, *, weight_argnums=(), **kw):
    cf = autochunk(fn, ChunkConfig(budget_ratio=0.3, weight_argnums=weight_argnums,
                                   kernel_dispatch=kw.pop("kernel_dispatch", "on"), **kw),
                   bucketer=None)
    before = stats.snapshot()
    compiled = cf.trace(*args).search().compile()
    d = stats.delta(before)
    return compiled, {k: d[k] for k in COUNTERS}


def _attn(S, causal=True):
    def attn(qkv):
        q, k, v = qkv
        pos = torch.arange(S, device=q.device)
        return L.gqa_attention(q, k, v, q_pos=pos, kv_pos=pos, causal=causal)
    return attn


def _qkv(hd, S, H=4, Kv=2, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
                 for s in ((1, S, H, hd), (1, S, Kv, hd), (1, S, Kv, hd)))


# (hd, S): S long enough that the scores, not q/k/v, set the peak, so the
# plan's one chunk loop holds the attention site; hd 48 has no instance
ATTN_SHAPES = [(32, 512), (64, 512), (128, 512), (80, 512), (96, 512), (256, 768), (48, 512)]
TAKEN_HEAD_DIMS = (32, 64, 80, 96, 128, 256)


@pytest.mark.parametrize("hd,S", ATTN_SHAPES)
def test_attention_predicate_for_a_cuda_target(hd, S):
    """The CUDA kernel's head dims are what a card-targeted compile takes;
    the CPU-targeted compile of the same site dispatches at every hd."""
    taken = hd in TAKEN_HEAD_DIMS
    assert (CA.cuda_refusal(hd) is None) == taken
    if not taken:
        assert f"hd in {TAKEN_HEAD_DIMS}" in CA.cuda_refusal(hd)
    qkv = _qkv(hd, S, seed=hd)
    _, counts = _compile(_attn(S), (qkv,), kernel_target="cuda")
    assert counts == {"kernel_dispatch_hits": int(taken), "kernel_dispatch_misses": int(not taken)}
    _, counts = _compile(_attn(S), (qkv,), kernel_target="cpu")
    assert counts == {"kernel_dispatch_hits": 1, "kernel_dispatch_misses": 0}


def test_causal_gqa_hd96_targeted_at_the_card_keeps_its_loop(monkeypatch):
    """phi3-mini's head dim, targeted at the card, dispatches to the
    attention wrapper (here its plain version, on CPU tensors) and keeps the
    undispatched program's output.  A head dim without an instance (48)
    keeps its generic loop: a miss, no wrapper call, the undispatched
    output exactly; the same compile with the default target (the CPU
    inputs' device) dispatches."""
    calls = []
    for name in ("computed_attention", "masked_attention"):
        fn = getattr(CA, name)
        monkeypatch.setattr(CA, name, lambda *a, _fn=fn, **k: calls.append(1) or _fn(*a, **k))
    S = 512
    attn = _attn(S)
    qkv = _qkv(96, S)
    card, counts = _compile(attn, (qkv,), kernel_target="cuda")
    assert counts == {"kernel_dispatch_hits": 1, "kernel_dispatch_misses": 0}
    np.testing.assert_allclose(card(qkv).numpy(), attn(qkv).numpy(), atol=ATOL)
    assert calls
    calls.clear()
    qkv = _qkv(48, S)
    off, _ = _compile(attn, (qkv,), kernel_dispatch="off")
    card, counts = _compile(attn, (qkv,), kernel_target="cuda")
    assert counts == {"kernel_dispatch_hits": 0, "kernel_dispatch_misses": 1}
    y_card = card(qkv)
    assert not calls
    np.testing.assert_array_equal(y_card.numpy(), off(qkv).numpy())
    np.testing.assert_allclose(y_card.numpy(), attn(qkv).numpy(), atol=ATOL)
    cpu, counts = _compile(attn, (qkv,))
    assert counts == {"kernel_dispatch_hits": 1, "kernel_dispatch_misses": 0}
    np.testing.assert_allclose(cpu(qkv).numpy(), y_card.numpy(), atol=ATOL)
    assert calls


def test_phi3_float32_block_plan_for_the_card_chunks_its_attention():
    """ROADMAP C-3: one full-width phi3-mini block (hd 96) in float32 at
    S 8192, traced on ``meta`` and planned for the card at budget 0.03 (the
    per-block budget of the card's run), has one stage whose chunk loop
    holds both the attention and the SwiGLU site, each dispatched.  The
    JAX package's plan of the same block at the same budget also chunks
    the attention (one stage over the attention alone, 128 chunks); the
    port's chunks are smaller (1024 of 8 rows) because its estimator's
    baseline peak is 0.62x the jaxpr's, so the same ratio is fewer bytes."""
    cfg = get_config("phi3-mini-3.8b").with_(dtype="float32", n_layers=1, scan_layers=False)
    p = M._index_tree(M.init_params(cfg, device="meta")["blocks"][0])
    x = torch.empty((1, 8192, cfg.d_model), device="meta")
    cf = ChunkedFunction(lambda p, x: M.dense_block_full(cfg, p, x, window=None, causal=True),
                         ChunkConfig.from_scalar(0.03, weight_argnums=(0,), dim_blocklist=(0,),
                                                 kernel_target="cuda", kernel_dispatch="on"))
    before = stats.snapshot()
    planned = cf.trace(p, x).search()
    d = stats.delta(before)
    loops = {k.kind: (n.params["c"], n.params["n_iters"]) for n in planned.graph.nodes
             if is_chunk_loop(n) for k in n.params["dispatches"]}
    assert len(planned.plan.stages) == 1
    assert loops == {"attention": (8, 1024), "swiglu": (8, 1024)}
    assert d["kernel_dispatch_misses"] == 0


def _swiglu(w, x):
    u, g = torch.chunk(x @ w["w_in"], 2, dim=-1)
    return (u * torch.nn.functional.silu(g)) @ w["w_out"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,f", [(64, 128), (128, 256), (32, 128), (64, 96), (96, 192)])
def test_swiglu_predicate_for_a_cuda_target(d, f, dtype):
    """d must be a multiple of 64 and f of the f tile (64 in f32, 128 in
    bf16); a site off the tiles keeps its loop on the card and dispatches
    on the CPU."""
    dt = getattr(torch, dtype)
    taken = d % CF.D_STEP == 0 and f % CF.F_TILE[dt] == 0
    assert (CF.cuda_refusal(d, f, dt) is None) == taken
    rng = np.random.default_rng(d + f)
    w = {"w_in": torch.from_numpy(rng.standard_normal((d, 2 * f), dtype=np.float32) * 0.1),
         "w_out": torch.from_numpy(rng.standard_normal((f, d), dtype=np.float32) * 0.1)}
    w = {k: v.to(dt) for k, v in w.items()}
    x = torch.from_numpy(rng.standard_normal((1, 48, d), dtype=np.float32)).to(dt)
    card, counts = _compile(_swiglu, (w, x), weight_argnums=(0,), kernel_target="cuda")
    assert counts["kernel_dispatch_hits"] == int(taken)
    _, counts = _compile(_swiglu, (w, x), weight_argnums=(0,), kernel_target="cpu")
    assert counts["kernel_dispatch_hits"] == 1
    if not taken:
        off, _ = _compile(_swiglu, (w, x), weight_argnums=(0,), kernel_dispatch="off")
        np.testing.assert_array_equal(card(w, x).float().numpy(), off(w, x).float().numpy())


def test_swiglu_predicate_reads_strides_and_alignment():
    """What the wrapper checks on real tensors, the predicate states: a
    column view at an odd offset, a transposed w_down, a row stride off 8."""
    bf = torch.bfloat16
    ok = ((64, 1), (512, 1), (512, 1), (64, 1))
    assert CF.cuda_refusal(64, 128, bf, strides=ok, addresses=(0, 256, 0, 0)) is None
    assert "aligned" in CF.cuda_refusal(64, 128, bf, strides=ok, addresses=(0, 2, 0, 0))
    assert "w_down" in CF.cuda_refusal(64, 128, bf, strides=ok[:3] + ((1, 128),))
    assert "row stride" in CF.cuda_refusal(64, 128, bf, strides=((68, 1),) + ok[1:])


def test_target_follows_the_inputs_and_keys_the_plan():
    cfg = ChunkConfig()
    assert cfg.resolve_kernel_target("cpu") == "cpu"
    assert cfg.resolve_kernel_target("cuda") == "cuda"
    assert cfg.resolve_kernel_target(None) == ("cuda" if torch.cuda.is_available() else "cpu")
    assert ChunkConfig(kernel_target="cuda").resolve_kernel_target("cpu") == "cuda"
    assert cfg.cache_token("cpu") != cfg.cache_token("cuda")
    assert ChunkConfig(kernel_target="cuda").cache_token("cpu") == cfg.cache_token("cuda")
    with pytest.raises(ValueError):
        ChunkConfig(kernel_target="tpu")
    traced = autochunk(_attn(32), ChunkConfig(kernel_dispatch="on"),
                       bucketer=None).trace(_qkv(32, 32))
    assert (traced.device, traced.target) == ("cpu", "cpu")
