"""Codegen front end over the lowering backend.

* :func:`build_chunked_fn` is the one-shot per-stage closure: the chunk loop
  of one candidate as a Python closure over the graph, not a graph rewrite.
  Stacking stages nests closures.  Kept as an independent reference for
  property tests; the compile pipeline does not call it.
* :func:`build_fn_from_plan` replays a saved :class:`~repro_torch.core.plan.ChunkPlan`
  onto a freshly traced graph: its stages as successive rewrites
  (:func:`~repro_torch.core.lowering.apply_chunk`), kernel dispatch, one
  emit, and a re-estimate of the rewritten graph.  No search, no selection
  and no re-trace: the caller's trace of the function is the only one.
* :func:`graph_to_fn` is the identity emit.

A port of ``repro/core/codegen.py``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from . import stats
from .estimation import estimate_memory
from .graph import Graph, vshape
from .lowering import (
    LOOP_INDEX,
    _adjust_op,
    _narrow,
    _runtime_device,
    apply_chunk,
    call_op,
    emit,
    graph_callable,
)
from .plan import PlanApplyError
from .search import ChunkCandidate


def build_chunked_fn(g: Graph, cand: ChunkCandidate,
                     n_chunks: int) -> Callable[..., Tuple[Any, ...]]:
    """A flat callable computing ``g`` with ``cand`` run as a chunk loop.

    The prefix, the hoisted nodes and the suffix run whole; the region's
    in-loop nodes run once a chunk on ``narrow`` slices of the sliced
    inputs, with their shape arguments shrunk to the chunk, and each chunk
    of a loop output is copied into its full buffer.  ``n_chunks`` need not
    divide the extent: the last chunk is clamped to end at the extent and
    rewrites the tail with the same values.
    """
    stats.bump("codegen_calls")
    ext = cand.chunk_extent
    c = -(-ext // int(n_chunks))          # ceil: per-chunk slice extent
    n_iters = -(-ext // c)
    prefix = list(g.nodes[:cand.s])
    hoisted = [g.nodes[i] for i in cand.hoisted]
    body = [_adjust_op(g.nodes[i], cand.var_dim, ext, c) for i in cand.in_loop]
    suffix = list(g.nodes[cand.e + 1:])
    sliced, full_in = list(cand.sliced_in), list(cand.full_in)
    loop_out = [(v, cand.var_dim[v]) for v in cand.loop_out]
    consts, invars, outvars = dict(g.consts), list(g.invars), list(g.outvars)

    def run(nodes, env, device):
        for node in nodes:
            env[node] = call_op(node.target, node.args, node.kwargs, env, device)

    def fn(*flat_args):
        device = _runtime_device(flat_args)
        env: Dict[Any, Any] = {v: t.to(device) for v, t in consts.items()}
        env.update(zip(invars, flat_args))
        run(prefix, env, device)
        run(hoisted, env, device)
        bufs = [torch.empty(vshape(v), dtype=v.meta["val"].dtype, device=device)
                for v, _ in loop_out]
        for i in range(n_iters):
            start = min(i * c, ext - c)
            benv: Dict[Any, Any] = {v: env[v] for v in full_in}
            benv[LOOP_INDEX] = i
            for v, d in sliced:
                benv[v] = _narrow(env[v], d, start, c)
            for op in body:
                benv[op.node] = call_op(op.node.target, op.args, op.kwargs, benv, device)
            for buf, (v, d) in zip(bufs, loop_out):
                buf.narrow(d, start, c).copy_(benv[v])
        env.update((v, b) for (v, _), b in zip(loop_out, bufs))
        run(suffix, env, device)
        return tuple(env[v] for v in outvars)

    return fn


def build_fn_from_plan(baseline_graph: Graph, plan, *, rescale: bool = False,
                       record: List = None, kernel_dispatch: bool = False,
                       mask_mode: str = "auto", target: Optional[str] = None):
    """Apply a saved plan to ``baseline_graph`` (a trace of the function at
    the shapes to run).

    ``rescale=True`` permits a plan recorded at another shape of the same
    bucket: each stage's chunk extent is retargeted to the traced shapes,
    keeping the chunk count.  When ``record`` is a list, one
    ``(graph, candidate, n_chunks)`` triple per applied stage is appended.
    Any mismatch raises :class:`PlanApplyError` so the caller can search.

    Returns ``(flat_fn, final_graph, final_profile)``.
    """
    stats.bump("plan_replays")
    g = baseline_graph
    for stage_i, st in enumerate(plan.stages):
        try:
            cand = st.to_candidate(g, rescale=rescale)
            n = min(st.n_chunks, cand.chunk_extent) if rescale else st.n_chunks
            g2 = apply_chunk(g, cand, n)
        except PlanApplyError:
            raise
        except (RuntimeError, ValueError, KeyError, IndexError) as e:
            raise PlanApplyError(f"applying plan stage {stage_i} failed: {e!r}") from e
        if record is not None:
            record.append((g, cand, n))
        g = g2
    if kernel_dispatch:
        from .kernel_dispatch import dispatch_graph

        g = dispatch_graph(g, mask_mode=mask_mode, target=target)
    return emit(g), g, estimate_memory(g)


def graph_to_fn(g: Graph) -> Callable[..., Tuple[Any, ...]]:
    """Plain interpreter for a Graph: the identity emit (chunk-loop aware)."""
    return graph_callable(g)
