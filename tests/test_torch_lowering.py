"""Port lowering backend: rewrite semantics, one emit, no re-trace.

``apply_chunk`` is a pure rewrite (no trace); a three-stage plan replays
onto a traced graph with three rewrites, one emit and no trace at all (the
port verifies by re-estimating the rewritten graph, never by re-tracing:
its chunk loop is a Python loop and a trace would unroll it); the emitted
function equals the unchunked one (1e-5), also when the chunk count does
not divide the extent; the estimate of a rewritten graph recurses into the
chunk loops' bodies.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import (
    ChunkConfig,
    ChunkPlan,
    CostHyper,
    apply_chunk,
    autochunk,
    build_fn_from_plan,
    emit,
    estimate_memory,
    rank_candidates,
    search_chunks,
    stats,
    trace,
)
from repro_torch.core.lowering import is_chunk_loop

torch.set_num_threads(2)


def _two_softmax(w, x):
    s = (x @ w["a"]) @ (x @ w["b"]).transpose(1, 2)
    y1 = torch.softmax(s, dim=-1) @ x
    h = torch.tanh(y1 @ w["m"])
    s2 = (h @ w["c"]) @ (h @ w["d"]).transpose(1, 2)
    return y1 + torch.softmax(s2, dim=-1) @ h


def _softmax_chain(w, x):
    """Three softmax-attention blocks: three chunkable memory peaks."""
    h = x
    for i in range(3):
        wi = w[f"b{i}"]
        s = (h @ wi["a"]) @ (h @ wi["b"]).transpose(1, 2)
        h = h + torch.softmax(s, dim=-1) @ h
    return h


def _tensor(rng, shape, scale=1.0):
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * scale)


def _weights(d=32, seed=0):
    rng = np.random.default_rng(seed)
    return {n: _tensor(rng, (d, d), 0.1) for n in "abmcd"}


def _chain_weights(d=32, seed=0):
    rng = np.random.default_rng(seed)
    return {f"b{i}": {"a": _tensor(rng, (d, d), 0.1), "b": _tensor(rng, (d, d), 0.1)}
            for i in range(3)}


def _x(S=256, d=32, seed=1):
    return _tensor(np.random.default_rng(seed), (2, S, d))


def _flat(fn, args):
    leaves, spec = torch.utils._pytree.tree_flatten(tuple(args))

    def flat_fn(*ls):
        return (fn(*torch.utils._pytree.tree_unflatten(list(ls), spec)),)

    return flat_fn, leaves


def _three_stage_planned(w, x):
    cf = autochunk(_softmax_chain, ChunkConfig(budget_ratio=0.15, anneal=0, window=24),
                   bucketer=None)
    planned = cf.trace(w, x).search()
    assert len(planned.plan.stages) == 3, planned.plan.stages
    return planned


def test_apply_chunk_is_pure_rewrite_no_trace():
    w, x = _weights(), _x()
    flat_fn, flat = _flat(_two_softmax, (w, x))
    g, _ = trace(flat_fn, flat, weight_argnums=())
    prof = estimate_memory(g)
    ranked = rank_candidates(g, prof, search_chunks(g, prof), prof.peak_bytes // 3,
                             CostHyper())
    cand, n = ranked[0][0], ranked[0][1]
    before = stats.snapshot()
    g2 = apply_chunk(g, cand, n)
    d = stats.delta(before)
    assert d["trace_calls"] == 0 and d["lowering_rewrites"] == 1
    assert sum(is_chunk_loop(node) for node in g2.nodes) == 1
    assert estimate_memory(g2).peak_bytes < prof.peak_bytes
    assert not any(is_chunk_loop(node) for node in g.nodes)   # the original is untouched
    y = emit(g2)(*flat)[0]
    np.testing.assert_allclose(y.numpy(), _two_softmax(w, x).numpy(), atol=1e-5)


def test_emitted_fn_matches_reference():
    w, x = _chain_weights(), _x()
    planned = _three_stage_planned(w, x)
    assert sum(is_chunk_loop(n) for n in planned.graph.nodes) == 3
    flat = torch.utils._pytree.tree_leaves((w, x))
    y = emit(planned.graph)(*flat)[0]
    np.testing.assert_allclose(y.numpy(), _softmax_chain(w, x).numpy(), atol=1e-5)


def test_three_stage_plan_replays_without_a_trace():
    w, x = _chain_weights(), _x()
    plan = ChunkPlan.from_json(_three_stage_planned(w, x).plan.to_json())
    flat_fn, flat = _flat(_softmax_chain, (w, x))
    g0, _ = trace(flat_fn, flat, weight_argnums=())
    before = stats.snapshot()
    fn, g, prof = build_fn_from_plan(g0, plan)
    d = stats.delta(before)
    assert d["trace_calls"] == 0                # verified by re-estimation only
    assert d["lowering_emits"] == 1 and d["lowering_rewrites"] == 3
    assert d["search_passes"] == d["selection_passes"] == 0
    assert prof.peak_bytes == plan.final_peak
    np.testing.assert_allclose(fn(*flat)[0].numpy(), _softmax_chain(w, x).numpy(), atol=1e-5)


@pytest.mark.parametrize("budget", [0.4, 0.2])
def test_cold_compile_traces_once(budget):
    w, x = _weights(d=48), _x(S=128, d=48, seed=4)
    cf = autochunk(_two_softmax, ChunkConfig(budget_ratio=budget, anneal=0), bucketer=None)
    before = stats.snapshot()
    compiled = cf.compile(w, x)
    d = stats.delta(before)
    assert compiled.result.plan
    assert d["trace_calls"] == 1 and d["lowering_emits"] == 1
    np.testing.assert_allclose(compiled(w, x).numpy(), _two_softmax(w, x).numpy(), atol=1e-5)


def test_estimate_recurses_into_chunk_loops():
    w, x = _weights(), _x()
    flat_fn, flat = _flat(_two_softmax, (w, x))
    g, _ = trace(flat_fn, flat, weight_argnums=())
    prof = estimate_memory(g)
    cand = search_chunks(g, prof)[0]
    g2 = apply_chunk(g, cand, 4)
    i = next(k for k, node in enumerate(g2.nodes) if is_chunk_loop(node))
    loop = g2.nodes[i]
    assert loop.params["body_peak"] > 0
    base = estimate_memory(g2).per_node_bytes[i]
    loop.params["body_peak"] += 12345
    assert estimate_memory(g2).per_node_bytes[i] == base + 12345


@pytest.mark.parametrize("n", [3, 5, 7])
def test_non_divisible_chunks_clamp_the_last_chunk(n):
    w, x = _weights(), _x(S=256)
    flat_fn, flat = _flat(_two_softmax, (w, x))
    g, _ = trace(flat_fn, flat, weight_argnums=())
    prof = estimate_memory(g)
    cand = next(c for c in search_chunks(g, prof) if c.chunk_extent == 256)
    g2 = apply_chunk(g, cand, n)
    loop = next(node for node in g2.nodes if is_chunk_loop(node))
    assert loop.params["c"] * loop.params["n_iters"] > 256     # the last chunk overlaps
    np.testing.assert_allclose(emit(g2)(*flat)[0].numpy(), _two_softmax(w, x).numpy(),
                               atol=1e-5)
