"""Plan replay over the lowering backend.

* :func:`build_fn_from_plan` replays a saved :class:`~repro_torch.core.plan.ChunkPlan`
  onto a freshly traced graph: its stages as successive rewrites
  (:func:`~repro_torch.core.lowering.apply_chunk`), kernel dispatch, one
  emit, and a re-estimate of the rewritten graph.  No search, no selection
  and no re-trace: the caller's trace of the function is the only one.
* :func:`graph_to_fn` is the identity emit.

The JAX package's one-shot ``build_chunked_fn`` (a per-stage closure
codegen kept there for its property tests) is not ported: nothing of the
port calls it.  A port of ``repro/core/codegen.py``.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

from . import stats
from .estimation import estimate_memory
from .graph import Graph
from .lowering import apply_chunk, emit, graph_callable
from .plan import PlanApplyError


def build_fn_from_plan(baseline_graph: Graph, plan, *, rescale: bool = False,
                       record: List = None, kernel_dispatch: bool = False,
                       mask_mode: str = "auto"):
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

        g = dispatch_graph(g, mask_mode=mask_mode)
    return emit(g), g, estimate_memory(g)


def graph_to_fn(g: Graph) -> Callable[..., Tuple[Any, ...]]:
    """Plain interpreter for a Graph: the identity emit (chunk-loop aware)."""
    return graph_callable(g)
