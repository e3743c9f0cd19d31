"""Pipeline counters: observable evidence of which passes and events ran.

A thin compat shim over the typed registry in
:mod:`repro_torch.obs.metrics`: every counter below is a ``Counter`` in the
process-wide registry, updates are thread-safe (``bump`` takes the
registry's lock, so concurrent serving and compile threads lose no
increment), and the same registry carries the serving histograms and
gauges that ``serve --metrics-out`` exports.  The dict API —
``bump`` / ``snapshot`` / ``reset`` / ``delta`` returning plain
``{name: int}`` dicts — is the JAX package's, with its names.
"""
from __future__ import annotations

from typing import Dict

from ..obs import metrics as _metrics

_REGISTRY = _metrics.default_registry()

# Pre-registered so snapshots always carry the full key set.
COUNTERS = (
    "trace_calls",          # graph captures (core.graph.trace)
    "estimate_calls",       # estimation passes (core.estimation.estimate_memory)
    # chunk search / selection: one "pass" per invocation of the paper's
    # chunk-search / chunk-selection stage (a bucket replay runs none)
    "search_calls",
    "rank_calls",
    "search_passes",
    "selection_passes",
    "codegen_calls",        # one-shot per-stage closures (codegen.build_chunked_fn)
    # lowering: every apply_chunk rewrite (beam candidates included), and
    # one emit per compiled plan
    "lowering_rewrites",
    "lowering_emits",
    # kernel dispatch: chunk-loop bodies swapped for fused kernels, bodies
    # examined and left as loops, and attention dispatches whose mask was a
    # band computed from positions (no mask array read)
    "kernel_dispatch_hits",
    "kernel_dispatch_misses",
    "kernel_dispatch_computed_mask",
    # the plan cache (core.plan.PlanCache): exact-key lookups that replayed
    # (a hit always means zero search passes) or searched, and plan records
    # removed by PlanCache.evict (a plan with its bucket aliases)
    "plan_cache_hits",
    "plan_cache_misses",
    "plan_evictions",
    # shape-bucketed plan reuse (core.config.ShapeBucketer)
    "plan_replays",
    "plan_replay_failures",
    "plan_bucket_hits",
    "plan_bucket_misses",
    "plan_bucket_rejects",
    # canonical bucket executables (ChunkConfig.canonical_bucket_exec): calls
    # served by a bucket's executable (zero traces, zero searches), the one
    # compile each bucket pays at its boundary, and calls padded up to it
    "bucket_exec_hits",
    "bucket_exec_misses",
    "bucket_exec_compiles",
    "padded_calls",
    # paged serving: physical pages leaving / re-entering the free list,
    # planner-sized prompt chunks run, steps that carried prefill and decode
    # rows in one ragged batch, and admissions refused for lack of pages
    "pages_allocated",
    "pages_freed",
    "mixed_steps",
    "prefill_chunks",
    "admission_refusals",
    # the prefix-sharing radix cache (serving.prefix_cache): admissions that
    # matched a cached prompt prefix, the prompt tokens whose prefill they
    # skipped, boundary pages copy-on-written, and ref-free cached pages
    # moved to the host arena under pool pressure and brought back on
    # re-match
    "prefix_hits",
    "prefix_tokens_reused",
    "cow_copies",
    "pages_spilled",
    "pages_restored",
)

for _name in COUNTERS:
    _REGISTRY.counter(_name)


def bump(name: str, by: int = 1) -> None:
    """Thread-safe counter increment (creates the counter on first use)."""
    _REGISTRY.counter(name).inc(by)


def snapshot() -> Dict[str, int]:
    """Copy of all counters (safe to diff against a later snapshot)."""
    return _REGISTRY.counter_values()


def reset() -> None:
    _REGISTRY.reset(counters_only=True)


def delta(before: Dict[str, int]) -> Dict[str, int]:
    """Counter increments since ``before`` (a prior :func:`snapshot`)."""
    cur = _REGISTRY.counter_values()
    return {k: cur[k] - before.get(k, 0) for k in cur}
