"""Kernel dispatch against the device it targets (ROADMAP C-1).

A site targeted at the card dispatches only where the CUDA kernel takes
its shapes: attention at hd 32, 64, 80, 96, 128 and 256
(``chunked_attention.cuda_refusal``), SwiGLU with d a multiple of 64 and f
of the FFN kernel's f tile (``chunked_ffn.cuda_refusal``).  A phi3-mini
block in float32 at its full width and S 8192, planned on ``meta`` for the
card at budget 0.03, chunks its attention as the JAX package's plan does
(ROADMAP C-3) and ends within its budget (C-5).  Elsewhere the site keeps its generic chunk
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
from repro_torch.core import kernel_dispatch as KD
from repro_torch.core.estimation import estimate_memory
from repro_torch.core.graph import op_name, trace
from repro_torch.core.kernel_dispatch import annotate_candidates
from repro_torch.core.lowering import apply_chunk, is_chunk_loop
from repro_torch.core.search import search_chunks
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


def _phi3_f32_block_planned():
    cfg = get_config("phi3-mini-3.8b").with_(dtype="float32", n_layers=1, scan_layers=False)
    p = M._index_tree(M.init_params(cfg, device="meta")["blocks"][0])
    x = torch.empty((1, 8192, cfg.d_model), device="meta")
    cf = ChunkedFunction(lambda p, x: M.dense_block_full(cfg, p, x, window=None, causal=True),
                         ChunkConfig.from_scalar(0.03, weight_argnums=(0,), dim_blocklist=(0,),
                                                 kernel_target="cuda", kernel_dispatch="on"))
    before = stats.snapshot()
    planned = cf.trace(p, x).search()
    return planned, stats.delta(before)


def test_phi3_float32_block_plan_for_the_card_chunks_its_attention():
    """ROADMAP C-3 and C-5: one full-width phi3-mini block (hd 96) in
    float32 at S 8192, traced on ``meta`` and planned for the card at budget
    0.03 (the per-block budget of the card's run), has one stage whose chunk
    loop holds both the attention and the SwiGLU site, each dispatched, and
    ends within its budget.  The JAX package's plan of the same block at the
    same budget also chunks the attention (one stage over the attention
    alone, 128 chunks).

    Re-pinned for C-5: the plan was 1024 chunks of 8 rows and ended at
    604,188,672 B against a 520,429,240 B budget, because selection capped a
    dispatched body's charge at its generic estimate while the attention
    kernel copied its full-length K and V (201,326,592 B) in every chunk.
    Selection now charges the dispatched body as it is, and those copies are
    made once, by graph nodes before the loop, so K and V's sources die
    there: 16 chunks of 512 rows, 456,163,328 B."""
    planned, d = _phi3_f32_block_planned()
    loops = {k.kind: (n.params["c"], n.params["n_iters"]) for n in planned.graph.nodes
             if is_chunk_loop(n) for k in n.params["dispatches"]}
    assert len(planned.plan.stages) == 1
    assert loops == {"attention": (512, 16), "swiglu": (512, 16)}
    assert d["kernel_dispatch_misses"] == 0
    assert planned.plan.final_peak <= planned.plan.budget_bytes


def test_phi3_float32_block_copies_k_and_v_once_before_its_loop():
    """C-5: the f32 phi3-mini block's dispatched graph makes the attention
    kernel's contiguous K and V in two ``attention_kv_operand`` nodes just
    before the chunk loop, which reads them in place of RoPE's K and the V
    projection; those die at the copies, and the body's modeled peak holds
    no full-length K or V.  The plan ends within its budget with both sites
    dispatched."""
    planned, d = _phi3_f32_block_planned()
    g = planned.graph
    (i_loop,) = [i for i, n in enumerate(g.nodes) if is_chunk_loop(n)]
    loop = g.nodes[i_loop]
    ops = [g.nodes[i_loop - 2], g.nodes[i_loop - 1]]
    assert [op_name(n) for n in ops] == ["attention_kv_operand"] * 2
    assert set(ops) <= set(loop.invars)
    for op in ops:
        (src,) = op.all_input_nodes
        assert g.last_use[src] == g.nodes.index(op)
        assert tuple(op.meta["val"].shape) == (32, 8192, 96)
    kv_bytes = 2 * 32 * 8192 * 96 * 4
    assert loop.params["body_peak"] < kv_bytes
    assert sorted(k.kind for k in loop.params["dispatches"]) == ["attention", "swiglu"]
    assert (d["kernel_dispatch_hits"], d["kernel_dispatch_misses"]) == (2, 0)
    assert planned.plan.final_peak <= planned.plan.budget_bytes


def test_phi3_float32_block_with_a_refused_head_dim_chunks_its_attention(monkeypatch):
    """ROADMAP C-4: with hd 96 refused by the card's attention kernel, the
    f32 phi3-mini block (full width, S 8192, budget 0.03, planned on ``meta``
    for the card) still gets a stage whose chunk loop holds the attention as
    a generic loop, as the bf16 search does; the SwiGLU site in the same
    loop dispatches (a loop with a match counts a hit, not a miss).
    Before the repair, the kernel bytes of the dispatched SwiGLU alone capped
    the estimate of a body that also held the generic attention's scores,
    so the search stopped after one stage at 2,625,679,364 B against a
    520,429,240 B budget."""
    refusal = CA.cuda_refusal
    monkeypatch.setattr(CA, "cuda_refusal",
                        lambda hd, *a, **k: "hd 96 refused" if hd == 96 else refusal(hd, *a, **k))
    cfg = get_config("phi3-mini-3.8b").with_(dtype="float32", n_layers=1, scan_layers=False)
    p = M._index_tree(M.init_params(cfg, device="meta")["blocks"][0])
    x = torch.empty((1, 8192, cfg.d_model), device="meta")
    cf = ChunkedFunction(lambda p, x: M.dense_block_full(cfg, p, x, window=None, causal=True),
                         ChunkConfig.from_scalar(0.03, weight_argnums=(0,), dim_blocklist=(0,),
                                                 kernel_target="cuda", kernel_dispatch="on"))
    before = stats.snapshot()
    planned = cf.trace(p, x).search()
    d = stats.delta(before)
    loops = [n for n in planned.graph.nodes if is_chunk_loop(n)]
    assert any("softmax" in str(op.node.target) for n in loops for op in n.params["body"])
    assert [k.kind for n in loops for k in n.params["dispatches"]] == ["swiglu"]
    assert (d["kernel_dispatch_hits"], d["kernel_dispatch_misses"]) == (1, 0)
    assert planned.plan.final_peak < 2_625_679_364
    assert planned.plan.final_peak <= planned.plan.budget_bytes


def test_phi3_float32_block_with_a_refused_swiglu_charges_its_generic_ffn(monkeypatch):
    """C-4's mirror: the phi3-mini f32 block (full width, S 8192, on
    ``meta``) with the attention dispatched and the SwiGLU refused by the
    card's FFN kernel.  Selection charges a candidate holding both sites
    the peak the estimator gives its body after dispatch, which counts the
    refused SwiGLU's chunk-sized ``x @ w_in`` product as well as the
    attention kernel's bytes (before, the kernel's bytes alone)."""
    monkeypatch.setattr(CF, "cuda_refusal", lambda *a, **k: "refused")
    cfg = get_config("phi3-mini-3.8b").with_(dtype="float32", n_layers=1, scan_layers=False)
    p = M._index_tree(M.init_params(cfg, device="meta")["blocks"][0])
    x = torch.empty((1, 8192, cfg.d_model), device="meta")
    g, _ = trace(lambda p, x: M.dense_block_full(cfg, p, x, window=None, causal=True), [p, x],
                 weight_argnums=(0,))
    prof = estimate_memory(g)
    cands = search_chunks(g, prof, peak_node=prof.peak_node, dim_blocklist=frozenset({0}))
    annotate_candidates(g, cands, target="cuda")
    both = [c for c in cands if c.kernel_bytes is not None
            and {"_softmax", "silu"} <= {op_name(g.nodes[i]) for i in c.in_loop}]
    assert both, "no candidate holds the attention and the SwiGLU"
    # 2 chunks of 4096 rows: the generic FFN's products outweigh the
    # attention kernel's bytes (its full-length K and V operands included)
    n, c_rows = 2, 4096
    for cand in both:
        ctx = KD._ctx_from_candidate(g, cand, KD._outer_nodes(g))
        matches = KD.match_body(ctx, target="cuda")
        assert [m.kind for m in matches] == ["attention"]
        # x @ w_in and silu(gate) live together, f32 (the attention kernel's
        # root and operands come to 301,989,888 B here)
        assert cand.kernel_bytes(c_rows) >= c_rows * (2 + 1) * cfg.d_ff * 4
        g2 = apply_chunk(g, cand, n)
        node = next(nd for nd in g2.nodes if is_chunk_loop(nd))
        assert KD.dispatch_node(node, g2, target="cuda") == 1
        assert cand.kernel_bytes(c_rows) == node.params["body_peak"]


@pytest.mark.parametrize("window", [None, 24], ids=["causal", "window"])
def test_heads_chunked_attention_dispatches_the_computed_band(window):
    """A loop over attention heads (every query row in each chunk, K, V
    sliced alike, the position mask shared by the heads) dispatches onto
    ``computed_attention`` with its band from position 0, copies nothing
    per chunk beyond its heads' share, and gives the undispatched program's
    output (float32, 1e-5)."""
    S, H, Kv, hd = 64, 4, 4, 32            # one query head a kv head, as phi3-mini

    def attn(qkv):
        q, k, v = qkv
        pos = torch.arange(S, device=q.device)
        return L.gqa_attention(q, k, v, q_pos=pos, kv_pos=pos, causal=True, window=window)

    qkv = _qkv(hd, S, H=H, Kv=Kv, seed=3)
    g, _ = trace(attn, [tuple(t.to("meta") for t in qkv)], weight_argnums=())
    prof = estimate_memory(g)
    at = next(i for i, n in enumerate(g.nodes) if op_name(n) == "_softmax")
    cands = [c for c in search_chunks(g, prof, peak_node=at) if c.chunk_extent == Kv and
             [op_name(g.nodes[i]) for i in c.in_loop].count("bmm") == 2]
    assert cands, "no candidate chunks the kv heads through both products"
    g2 = apply_chunk(g, cands[0], Kv)
    loop = next(n for n in g2.nodes if is_chunk_loop(n))
    before = stats.snapshot()
    assert KD.dispatch_node(loop, g2, target="cuda") == 1
    assert stats.delta(before)["kernel_dispatch_computed_mask"] == 1
    from repro_torch.core.lowering import emit
    (y,) = emit(g2)(*qkv)
    np.testing.assert_allclose(y.numpy(), attn(qkv).numpy(), atol=ATOL)


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


def test_dispatch_keeps_an_in_place_write_nothing_reads():
    """A dispatched attention site prunes the nodes the kernel made dead;
    an in-place write into an input (as a decode wave's ``copy_`` into its
    state cache) stays, though no output reads it."""
    S = 256

    def fn(qkv, out):
        out.copy_(qkv[0][:, -1])
        return _attn(S)(qkv)

    qkv = _qkv(32, S)
    compiled, counts = _compile(fn, (qkv, torch.zeros((1, 4, 32))))
    assert counts["kernel_dispatch_hits"] == 1
    out = torch.zeros((1, 4, 32))
    got = compiled(qkv, out)
    assert torch.equal(out, qkv[0][:, -1])
    np.testing.assert_allclose(got.numpy(), _attn(S)(qkv).numpy(), atol=ATOL)
