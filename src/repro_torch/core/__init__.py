"""The AutoChunk compiler, ported: graph capture, estimation, chunk search
and selection, lowering to chunk loops, kernel dispatch and the staged API.

    from repro_torch.core import ChunkConfig, autochunk
    cf = autochunk(fn, ChunkConfig(budget_ratio=0.2))
    y = cf(params, batch)
"""
from . import stats
from .api import (
    AutoChunkResult,
    ChunkConfig,
    ChunkedFunction,
    CompiledFunction,
    Planned,
    ShapeBucketer,
    StageRecord,
    Traced,
    autochunk,
    build_autochunk,
)
from .codegen import build_chunked_fn, build_fn_from_plan, graph_to_fn
from .estimation import MemoryProfile, estimate_memory
from .graph import Graph, trace
from .lowering import apply_chunk, emit, emit_padded_call
from .plan import (
    ChunkPlan,
    PlanApplyError,
    PlanCache,
    PlanStage,
    as_plan_cache,
    graph_fingerprint,
    plan_cache_key,
)
from .search import ChunkCandidate, search_chunks
from .selection import CostHyper, rank_candidates

__all__ = [
    "AutoChunkResult", "ChunkCandidate", "ChunkConfig", "ChunkPlan", "ChunkedFunction",
    "CompiledFunction", "CostHyper", "Graph", "MemoryProfile", "PlanApplyError", "PlanCache",
    "PlanStage", "Planned", "ShapeBucketer", "StageRecord", "Traced", "apply_chunk",
    "as_plan_cache", "autochunk", "build_autochunk", "build_chunked_fn", "build_fn_from_plan",
    "emit", "emit_padded_call", "estimate_memory", "graph_fingerprint", "graph_to_fn",
    "plan_cache_key", "rank_candidates", "search_chunks", "stats", "trace",
]
