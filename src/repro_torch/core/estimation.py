"""Estimation pass: liveness-based activation-memory analysis of a Graph.

AutoChunk's first compiler pass, over an aten graph.  A value is live from
the node that allocates it until the last use of its storage (views and
in-place ops extend their base's life and allocate nothing, see
``core.graph``).  The pass reports, per node, the bytes of intermediate
activation live while that node runs, the overall peak and where it sits.
Birth and death follow the JAX package's estimator: a node's output counts
while the node runs, is born if used later, and dies after its last use;
inputs and weights are never counted in the peak.  A chunk loop (after a
rewrite by ``core.lowering``) adds its modeled per-iteration body peak, as
the JAX estimator recurses into loop bodies.

The aten graph is finer than a jaxpr in some places (one ``_softmax`` node
where the jaxpr has max/sub/exp/sum/div) and coarser in others, so peaks
agree with the JAX estimator's in shape, not byte for byte.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Set

import torch
from torch.fx import Node

from ..obs.tracing import span
from . import stats
from .graph import Graph, node_outs, trace


@dataclass
class MemoryProfile:
    """Result of the estimation pass (single-device bytes)."""

    per_node_bytes: List[int]     # live intermediate bytes while node i runs
    peak_bytes: int               # max over nodes (intermediates only)
    peak_node: int                # index of the peak node
    io_bytes: int                 # inputs (non-weight) + outputs
    weight_bytes: int             # parameter memory (excluded from peak)


def _inner_peak(node) -> int:
    """Per-iteration live bytes of a chunk loop's body (0 for an aten node).

    The rewrite (``core.lowering``) models them when it builds the loop, so
    a rewritten graph is estimated directly, never re-traced: a re-trace of
    the emitted Python loop would unroll it into n_chunks copies of the body.
    """
    return 0 if isinstance(node, Node) else int(node.params["body_peak"])


def estimate_memory(g: Graph) -> MemoryProfile:
    """Run the estimation pass over a :class:`~repro_torch.core.graph.Graph`."""
    stats.bump("estimate_calls")
    per_node: List[int] = []
    live: Set[Node] = set()
    live_bytes = 0
    peak = 0
    peak_node = 0
    for i, node in enumerate(g.nodes):
        outs = node_outs(node)
        out_b = sum(g.node_bytes(v) for v in outs)
        cur = live_bytes + out_b + _inner_peak(node)
        per_node.append(cur)
        if cur > peak:
            peak, peak_node = cur, i
        # birth
        for v in outs:
            b = g.node_bytes(v)
            if b and g.last_use.get(v, -1) > i and v not in live:
                live.add(v)
                live_bytes += b
        # death
        dead = [v for v in live if g.last_use.get(v, -1) <= i]
        for v in dead:
            live.remove(v)
            live_bytes -= g.node_bytes(v)

    weight_b = sum(g.var_bytes(v) for v in g.weight_invars)
    io_b = (sum(g.var_bytes(v) for v in g.invars if v not in g.weight_invars)
            + sum(g.var_bytes(v) for v in g.outvars))
    return MemoryProfile(per_node_bytes=per_node, peak_bytes=peak,
                         peak_node=peak_node, io_bytes=io_b, weight_bytes=weight_b)


# ===========================================================================
# Prefill-chunk planning (paged continuous batching)
# ===========================================================================

@dataclass
class PrefillChunkPlan:
    """Planner output for the paged engine's chunked prefill.

    ``chunk`` is the largest candidate whose estimated one-block activation
    peak fits the budget; ``candidate_peaks`` records the whole sweep.
    """

    chunk: int
    peak_bytes: int                   # estimated peak at the chosen chunk
    budget_bytes: int                 # resolved absolute budget
    baseline_peak_bytes: int          # peak of the unchunked (full) prefill
    candidate_peaks: Dict[int, int]
    fits: bool                        # False => even the smallest candidate
                                      # exceeds the budget (best effort)


def prefill_block_step(cfg, chunk: int, kv_len: int):
    """``step(p, x, k, v)``: one attention block applied to a ``chunk``-token
    prefill slice ``x`` (1, chunk, d) attending to a ``kv_len`` context
    ``k``/``v`` (1, kv_len, Kv, hd): the paged engine's per-layer step."""
    from ..models import layers as L

    def step(p, x, k, v):
        qpos = (kv_len - chunk) + torch.arange(chunk, dtype=torch.int32, device=x.device)
        kvpos = torch.arange(kv_len, dtype=torch.int32, device=x.device)
        h = L.apply_norm(cfg, x, p["ln1"])
        q, _, _ = L.attn_project_qkv(cfg, p["attn"], h, qpos)
        o = L.gqa_attention(q, k, v, q_pos=qpos, kv_pos=kvpos, causal=True)
        x = x + o.reshape(1, chunk, -1) @ p["attn"]["wo"]
        h2 = L.apply_norm(cfg, x, p["ln2"])
        return x + L.mlp(cfg, p["mlp"], h2)

    return step


def _prefill_step_graph(cfg, chunk: int, kv_len: int) -> Graph:
    """Trace :func:`prefill_block_step` on the ``meta`` device."""
    from ..models import model as M

    meta = torch.device("meta")
    dt = cfg.torch_dtype
    p = M.dense_block_params(cfg, None, device=meta)
    x = torch.empty((1, chunk, cfg.d_model), dtype=dt, device=meta)
    k = torch.empty((1, kv_len, cfg.n_kv_heads, cfg.hd), dtype=dt, device=meta)
    v = torch.empty((1, kv_len, cfg.n_kv_heads, cfg.hd), dtype=dt, device=meta)
    g, _ = trace(prefill_block_step(cfg, chunk, kv_len), (p, x, k, v), weight_argnums=(0,))
    return g


def plan_prefill_chunk(cfg, *, budget: float, max_len: int,
                       min_chunk: int = 8) -> PrefillChunkPlan:
    """Pick the prefill chunk size from the activation budget.

    Each power-of-two candidate chunk (and ``max_len`` itself) is traced as
    one block step against a ``max_len`` context and run through
    :func:`estimate_memory`; the planner returns the largest chunk whose
    estimated peak fits.  ``budget`` follows the paper's scalar convention:
    <= 1.0 is a ratio of the unchunked full-prefill peak, > 1.0 is bytes.
    """
    candidates = []
    c = max(1, min_chunk)
    while c < max_len:
        candidates.append(c)
        c *= 2
    candidates.append(max_len)

    peaks: Dict[int, int] = {}
    with span("compile.plan_prefill", max_len=max_len, candidates=len(candidates)):
        for c in candidates:
            with span("compile.estimate", chunk=c):
                peaks[c] = estimate_memory(_prefill_step_graph(cfg, c, max_len)).peak_bytes
    baseline = peaks[max_len]
    budget_bytes = int(budget) if budget > 1.0 else int(baseline * budget)

    fitting = [c for c in candidates if peaks[c] <= budget_bytes]
    if fitting:
        chunk = max(fitting)
        fits = True
    else:
        chunk = min(candidates)  # best effort: smallest step we can take
        fits = False
    return PrefillChunkPlan(chunk=chunk, peak_bytes=peaks[chunk],
                            budget_bytes=budget_bytes, baseline_peak_bytes=baseline,
                            candidate_peaks=peaks, fits=fits)
