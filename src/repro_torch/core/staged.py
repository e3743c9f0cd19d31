"""Staged compilation: ``ChunkedFunction`` -> Traced -> Planned -> Compiled.

Each compiler pass of the paper (estimate -> chunk search -> chunk
selection -> codegen) is a stage object:

    cf = autochunk(fn, ChunkConfig(budget_ratio=0.4))
    traced   = cf.trace(*args)      # aten graph + memory profile (on meta)
    planned  = traced.search()      # chunk search + selection -> ChunkPlan
    compiled = planned.compile()    # the emitted callable
    y = compiled(*args)

Calling a ``ChunkedFunction`` directly compiles lazily per input shape.
With a :class:`~repro_torch.core.config.ShapeBucketer` (the default), a
plan searched at one shape is replayed (chunk extents rescaled, zero search
and selection passes) for every other shape in the same bucket; the
``core.stats`` counters ``search_passes`` and ``plan_bucket_hits`` make that
observable.  With ``cache=`` (a :class:`~repro_torch.core.plan.PlanCache` or
a directory) a search first looks up the exact structural key, then the
shape bucket, and only then searches; plans persist across processes.  With
``ChunkConfig(canonical_bucket_exec=True)`` one executable per shape bucket,
compiled at the bucket's boundary, serves every length in the bucket by
padding (zero traces, zero searches).  Each pass runs inside a host span
of the JAX package's name (``compile.trace``, ``compile.estimate``,
``compile.search``, ``compile.select``, ``compile.lower``, ``compile.emit``,
``compile.replay``), and every compile attaches and publishes its
predicted-against-measured peak (``AutoChunkResult.accuracy``).  A port of
``repro/core/staged.py``.
"""
from __future__ import annotations

import functools
import hashlib
import json
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils import _pytree as pytree

from ..obs import accuracy as obs_accuracy
from ..obs.tracing import span
from . import stats
from .codegen import build_fn_from_plan
from .config import ChunkConfig, ShapeBucketer
from .estimation import MemoryProfile, estimate_memory
from .graph import Graph, trace
from .kernel_dispatch import dispatch_graph
from .lowering import apply_chunk, emit, emit_padded_call, validate_pending
from .plan import ChunkPlan, PlanApplyError, PlanStage, as_plan_cache, plan_cache_key
from .search import search_chunks
from .selection import rank_candidates

_DEFAULT_BUCKETER = object()  # sentinel: "use a fresh default ShapeBucketer"


# ---------------------------------------------------------------------------
# Result records
# ---------------------------------------------------------------------------

@dataclass
class StageRecord:
    stage: int
    region: Tuple[int, int]
    n_chunks: int
    chunk_extent: int
    n_loop_eqns: int
    n_hoisted: int
    cost: float
    peak_before: int
    peak_after: int


@dataclass
class AutoChunkResult:
    """A chunked callable plus the full compilation report."""

    fn: Callable                      # original signature
    flat_fn: Callable                 # flat leaves -> flat leaves
    plan: List[StageRecord]
    baseline_peak: int
    final_peak: int
    budget_bytes: int
    io_bytes: int
    weight_bytes: int
    elapsed_s: float = 0.0
    trace_s: float = 0.0              # host seconds of the trace (estimate) pass
    search_s: float = 0.0             # of search and selection (0 on a replay)
    plan_stages: List[PlanStage] = field(default_factory=list)
    from_cache: bool = False
    cache_key: Optional[str] = None
    # predicted-against-measured activation peak (repro_torch.obs.accuracy),
    # attached by Planned.compile(): the search's prediction beside the
    # emitted graph's live-set watermark
    accuracy: Optional[obs_accuracy.PlanAccuracy] = None

    def to_chunk_plan(self) -> ChunkPlan:
        """Detach the compilation into a serializable :class:`ChunkPlan`."""
        return ChunkPlan(cache_key=self.cache_key or "", budget_bytes=self.budget_bytes,
                         baseline_peak=self.baseline_peak, final_peak=self.final_peak,
                         stages=list(self.plan_stages),
                         meta={"io_bytes": self.io_bytes, "weight_bytes": self.weight_bytes,
                               "compile_s": round(self.elapsed_s, 3)})

    @property
    def reduction(self) -> float:
        if self.baseline_peak == 0:
            return 0.0
        return 1.0 - self.final_peak / self.baseline_peak

    def report(self) -> str:
        lines = [
            "AutoChunk plan:",
            f"  baseline peak activation: {self.baseline_peak / 2**20:.2f} MiB",
            f"  budget:                   {self.budget_bytes / 2**20:.2f} MiB",
            f"  final peak activation:    {self.final_peak / 2**20:.2f} MiB"
            f"  ({self.reduction * 100:.1f}% reduction)",
            f"  io bytes: {self.io_bytes / 2**20:.2f} MiB,"
            f" weights: {self.weight_bytes / 2**20:.2f} MiB",
            f"  compile time: {self.elapsed_s:.2f}s, stages: {len(self.plan)}"
            + (" [from cache]" if self.from_cache else ""),
        ]
        for r in self.plan:
            lines.append(
                f"    stage {r.stage}: region [{r.region[0]},{r.region[1]}]"
                f" n={r.n_chunks} (extent {r.chunk_extent})"
                f" loop_nodes={r.n_loop_eqns} hoisted={r.n_hoisted}"
                f" peak {r.peak_before / 2**20:.1f} -> {r.peak_after / 2**20:.1f} MiB"
                f" cost={r.cost:.3f}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Shared plumbing
# ---------------------------------------------------------------------------

def _progress_metric(prof: MemoryProfile):
    """Lexicographic progress: peak, #nodes at >=99% of peak, then the mass
    of the top-8 live sets.  Repeated layer stacks tie on raw peak, so a
    stage that flattens one of several equal peaks still counts."""
    peak = prof.peak_bytes
    near = sum(1 for b in prof.per_node_bytes if b >= 0.99 * peak)
    top = sum(sorted(prof.per_node_bytes)[-8:])
    return (peak, near, top)


def _flatten_spec(example_args: Sequence[Any], weight_argnums: Sequence[int]):
    flat, in_spec = pytree.tree_flatten(tuple(example_args))
    for leaf in flat:
        if not isinstance(leaf, torch.Tensor):
            raise TypeError(f"autochunk arguments must be tensors, got {type(leaf).__name__}")
    weight_flat: List[int] = []
    pos = 0
    for i, a in enumerate(example_args):
        c = len(pytree.tree_leaves(a))
        if i in weight_argnums:
            weight_flat.extend(range(pos, pos + c))
        pos += c
    return flat, in_spec, weight_flat


def _leaf_sig(x: torch.Tensor) -> Tuple[Tuple[int, ...], str]:
    return tuple(int(s) for s in x.shape), str(x.dtype)


def _leaf_key(x: torch.Tensor) -> Tuple[Tuple[int, ...], str, str]:
    """Shape, dtype and device type: a compile's plan can depend on all three."""
    return _leaf_sig(x) + (x.device.type,)


def needs_grad(leaves: Sequence[torch.Tensor]) -> bool:
    """Whether a call on ``leaves`` needs gradients: grad mode is on and a
    floating input or weight requires grad.  Such a compile dispatches no
    kernel (``ChunkConfig.resolve_kernel_dispatch``), so it never shares a
    plan with an inference compile of the same shapes."""
    return torch.is_grad_enabled() and any(
        x.requires_grad and x.is_floating_point() for x in leaves)


def _package_result(*, fn: Callable, out_spec_box: List[Any], plan: List[StageRecord],
                    plan_stages: List[PlanStage], baseline_peak: int, final_peak: int,
                    budget_bytes: int, io_bytes: int, weight_bytes: int, elapsed_s: float,
                    trace_s: float = 0.0, search_s: float = 0.0,
                    from_cache: bool = False, cache_key: Optional[str] = None) -> AutoChunkResult:
    """Wrap a flat callable back into the original pytree signature."""
    flat_fn = fn

    def wrapped(*args):
        leaves = pytree.tree_leaves(tuple(args))
        return pytree.tree_unflatten(list(flat_fn(*leaves)), out_spec_box[0])

    return AutoChunkResult(fn=wrapped, flat_fn=flat_fn, plan=plan, baseline_peak=baseline_peak,
                           final_peak=final_peak, budget_bytes=budget_bytes, io_bytes=io_bytes,
                           weight_bytes=weight_bytes, elapsed_s=elapsed_s, trace_s=trace_s,
                           search_s=search_s, plan_stages=plan_stages, from_cache=from_cache,
                           cache_key=cache_key)


# ---------------------------------------------------------------------------
# The search pipeline (the paper's chunk-search + chunk-selection passes)
# ---------------------------------------------------------------------------

def _search_loop(g: Graph, prof: MemoryProfile, budget_bytes: int, config: ChunkConfig,
                 target: str, grad: bool):
    """Greedy staged search with beam verification (paper Alg. 1).

    Each accepted stage is a pure graph rewrite verified by re-estimating
    the rewritten graph; nothing is traced during the search.
    """
    kd = config.resolve_kernel_dispatch(grad)
    records: List[StageRecord] = []
    pstages: List[PlanStage] = []
    for stage in range(config.max_stages):
        if prof.peak_bytes <= budget_bytes:
            break
        cands = search_chunks(g, prof, window=config.window, allow_hoist=config.allow_hoist,
                              dim_blocklist=frozenset(config.dim_blocklist))
        with span("compile.select", stage=stage, candidates=len(cands)):
            ranked = rank_candidates(g, prof, cands, budget_bytes, config.hyper,
                                     kernel_dispatch=kd, mask_mode=config.mask_mode,
                                     target=target)
        if config.verbose:
            print(f"[autochunk] stage {stage}: peak={prof.peak_bytes / 2**20:.1f}MiB"
                  f" budget={budget_bytes / 2**20:.1f}MiB candidates={len(ranked)}")
        # DP-with-beam: rewrite the top-`beam` candidates, re-estimate, keep
        # the best (meets budget, lowest cost, lowest estimated peak).  Only
        # the winner pays the body validation; a failure falls through.
        cur_metric = _progress_metric(prof)
        verified = []
        for cand, n, est, cost in ranked[:config.beam]:
            g2 = apply_chunk(g, cand, n, validate=False)
            prof2 = estimate_memory(g2)
            big_gain = prof2.peak_bytes < prof.peak_bytes * (1.0 - config.min_gain)
            if not big_gain and _progress_metric(prof2) >= cur_metric:
                continue  # no peak gain and no structural progress
            over = prof2.peak_bytes > budget_bytes
            key = ((over, cost, prof2.peak_bytes) if not over
                   else (over,) + _progress_metric(prof2) + (cost,))
            verified.append((key, cand, n, cost, g2, prof2))
        applied = None
        for key, cand, n, cost, g2, prof2 in sorted(verified, key=lambda t: t[0]):
            try:
                validate_pending(g2)
            except RuntimeError:
                continue
            applied = (cand, n, cost, g2, prof2)
            break
        if applied is None:
            break
        cand, n, cost, g2, prof2 = applied
        records.append(StageRecord(stage=stage, region=(cand.s, cand.e), n_chunks=n,
                                   chunk_extent=cand.chunk_extent, n_loop_eqns=len(cand.in_loop),
                                   n_hoisted=len(cand.hoisted), cost=cost,
                                   peak_before=prof.peak_bytes, peak_after=prof2.peak_bytes))
        pstages.append(PlanStage.from_candidate(g, cand, n, cost=cost,
                                                peak_before=prof.peak_bytes,
                                                peak_after=prof2.peak_bytes))
        g, prof = g2, prof2
    return g, prof, records, pstages


def _search_with_anneal(g0, prof0, budget_bytes, config, target, grad):
    """Search, then budget-anneal: a missed target retries the whole
    pipeline against a tighter internal budget and keeps whichever plan
    estimates lower."""
    g, prof, records, pstages = _search_loop(g0, prof0, budget_bytes, config, target, grad)
    if prof.peak_bytes > budget_bytes and config.anneal > 0 and pstages:
        retry = _search_with_anneal(g0, prof0, max(budget_bytes // 2, 1),
                                    config.with_(anneal=config.anneal - 1), target, grad)
        if retry[1].peak_bytes < prof.peak_bytes:
            return retry
    return g, prof, records, pstages


# ---------------------------------------------------------------------------
# Stage objects
# ---------------------------------------------------------------------------

def _to_meta(x: torch.Tensor) -> torch.Tensor:
    return torch.empty(x.shape, dtype=x.dtype, device="meta")


class Traced:
    """Stage 1: traced graph + baseline memory profile (the estimate pass).

    The example arguments may be real tensors or ``meta`` tensors; the
    function is traced on ``meta`` copies, so nothing runs and nothing is
    allocated on the card.  The trace runs under ``torch.no_grad`` whatever
    the caller's grad mode, so a training compile and an inference compile
    see the same aten graph; ``grad`` (the arguments need gradients, see
    :func:`needs_grad`) joins the plan's keys and turns kernel dispatch off.
    """

    def __init__(self, cf: "ChunkedFunction", example_args: Sequence[Any]):
        self.cf = cf
        config = cf.config
        self._t0 = time.perf_counter()
        self.flat_args, self.in_spec, self.weight_flat = _flatten_spec(
            example_args, config.weight_argnums)
        self.out_spec_box: List[Any] = [None]
        in_spec, out_spec_box, fn = self.in_spec, self.out_spec_box, cf.fn

        def flat_fn(*leaves):
            out = fn(*pytree.tree_unflatten(list(leaves), in_spec))
            out_leaves, out_spec = pytree.tree_flatten(out)
            out_spec_box[0] = out_spec
            return tuple(out_leaves)

        self.flat_fn = flat_fn
        self.grad: bool = needs_grad(self.flat_args)
        config.resolve_kernel_dispatch(self.grad)   # 'on' with gradients raises here
        meta_args = [_to_meta(x) for x in self.flat_args]
        with span("compile.trace", leaves=len(self.flat_args)), torch.no_grad():
            self.graph, _ = trace(flat_fn, meta_args, weight_argnums=())
        self.graph.weight_invars = {self.graph.invars[i] for i in self.weight_flat}
        with span("compile.estimate"):
            self.profile: MemoryProfile = estimate_memory(self.graph)
        self.trace_s = time.perf_counter() - self._t0
        self.search_s = 0.0               # set by search(); stays 0 on a replay
        self.baseline_peak: int = self.profile.peak_bytes
        self.budget_bytes: int = config.resolve_budget(self.baseline_peak)
        # the device whose kernels dispatch must fit: the inputs' own unless
        # the config names one
        devices = {x.device.type for x in self.flat_args if x.device.type != "meta"}
        self.device: Optional[str] = devices.pop() if len(devices) == 1 else None
        self.target: str = config.resolve_kernel_target(self.device)
        self._cache_key: Optional[str] = None

    @property
    def memory_profile(self) -> MemoryProfile:
        return self.profile

    def cache_key(self) -> str:
        """Exact structural plan-cache key of this trace and config.  The
        search knobs carry the kernel target this trace resolved: a plan
        searched for the CPU's plain versions never replays for the card's
        kernels, which refuse more sites; and whether the compile needs
        gradients, so a training plan and an inference plan never share a
        key."""
        if self._cache_key is None:
            config = self.cf.config
            knobs = dict(config.search_knobs(self.grad), kernel_target=self.target)
            if self.grad:   # as in cache_token: inference keys stay as they were
                knobs["grad"] = True
            self._cache_key = plan_cache_key(self.graph, self.budget_bytes, config.hyper, knobs)
        return self._cache_key

    def bucket_key(self) -> Optional[str]:
        """Shape-bucket key (None when bucketing is disabled)."""
        bucketer = self.cf.bucketer
        if bucketer is None:
            return None
        fn = self.cf.fn
        doc = {
            "fn": f"{getattr(fn, '__module__', '?')}.{getattr(fn, '__qualname__', repr(fn))}",
            "tree": str(self.in_spec),
            "weights": list(self.weight_flat),
            "sig": [[list(bucketer.bucket_shape(shape)), dtype]
                    for shape, dtype in map(_leaf_sig, self.flat_args)],
            "config": self.cf.config.cache_token(self.device, self.grad),
        }
        blob = json.dumps(doc, sort_keys=True, separators=(",", ":"))
        return hashlib.sha256(blob.encode()).hexdigest()

    def search(self) -> "Planned":
        """Run chunk search + selection, or replay a stored plan.

        Lookup order: the exact structural key in the plan cache, then the
        shape bucket (in memory, then the cache's aliases).  A hit replays
        with zero search and selection passes; a replay that fails or is
        rejected counts a miss and falls through to the search.
        """
        cf, config = self.cf, self.cf.config
        cache, ckey = cf.cache, self.cache_key()
        if cache is not None:
            saved = cache.get(ckey)
            planned = self._replay(saved, rescale=False) if saved is not None else None
            if planned is not None:
                stats.bump("plan_cache_hits")
                return planned
            stats.bump("plan_cache_misses")

        bkey = self.bucket_key()
        if bkey is not None:
            saved = cf._bucket_plans.get(bkey)
            if saved is None and cache is not None:
                saved = cache.get_bucket(bkey)
            planned = self._replay(saved, rescale=True) if saved is not None else None
            if planned is not None:
                stats.bump("plan_bucket_hits")
                cf.counters["bucket_hits"] += 1
                if cache is not None:     # an exact hit next time at this shape
                    cache.put(ckey, planned.plan)
                return planned
            stats.bump("plan_bucket_misses")
            cf.counters["bucket_misses"] += 1

        t0 = time.perf_counter()
        with span("compile.search", budget_bytes=self.budget_bytes):
            lowered, prof, records, pstages = _search_with_anneal(
                self.graph, self.profile, self.budget_bytes, config, self.target, self.grad)
        self.search_s = time.perf_counter() - t0
        if pstages:
            if config.resolve_kernel_dispatch(self.grad):
                with span("compile.lower", stages=len(pstages)):
                    lowered = dispatch_graph(lowered, mask_mode=config.mask_mode,
                                             target=self.target)
                    prof = estimate_memory(lowered)
            with span("compile.emit", stages=len(pstages)):
                cur = emit(lowered)
        else:  # nothing chunked: the function itself is the program
            cur = self.flat_fn
        plan = ChunkPlan(cache_key=ckey, budget_bytes=self.budget_bytes,
                         baseline_peak=self.baseline_peak, final_peak=prof.peak_bytes,
                         stages=pstages,
                         meta={"io_bytes": prof.io_bytes, "weight_bytes": prof.weight_bytes,
                               "compile_s": round(time.perf_counter() - self._t0, 3)})
        if cache is not None:
            cache.put(ckey, plan)
        if bkey is not None:
            cf._bucket_plans[bkey] = plan
            if cache is not None:
                cache.put_bucket(bkey, plan)
        return Planned(traced=self, plan=plan, records=records, flat_fn=cur,
                       graph=lowered, profile=prof, from_cache=False, bucket_hit=False)

    def _replay(self, saved: ChunkPlan, *, rescale: bool) -> Optional["Planned"]:
        """Apply a stored plan to this trace; None means search.

        ``rescale`` marks a bucket sibling's plan: its chunk extents follow
        the traced shapes, and it must pass the quality guard."""
        config = self.cf.config
        rec: List[Tuple[Graph, Any, int]] = []
        try:
            with span("compile.replay", stages=len(saved.stages), rescale=rescale):
                fn, g, prof = build_fn_from_plan(
                    self.graph, saved, rescale=rescale, record=rec,
                    kernel_dispatch=config.resolve_kernel_dispatch(self.grad),
                    mask_mode=config.mask_mode, target=self.target)
        except PlanApplyError:
            stats.bump("plan_replay_failures")
            return None
        if rescale:
            # quality guard, shape-invariant: accept the rescaled replay if it
            # fits this shape's budget, or reaches about the relative
            # reduction the plan reached at its home shape
            ok = prof.peak_bytes <= self.budget_bytes
            if not ok and saved.baseline_peak > 0:
                home_ratio = saved.final_peak / saved.baseline_peak
                ok = prof.peak_bytes <= self.baseline_peak * home_ratio * 1.05
            if not ok:
                stats.bump("plan_bucket_rejects")
                return None
            peaks = [estimate_memory(gi).peak_bytes for gi, _, _ in rec] + [prof.peak_bytes]
            pstages = [PlanStage.from_candidate(gi, cand, n, cost=saved.stages[i].cost,
                                                peak_before=peaks[i], peak_after=peaks[i + 1])
                       for i, (gi, cand, n) in enumerate(rec)]
            plan = ChunkPlan(cache_key=self.cache_key(), budget_bytes=self.budget_bytes,
                             baseline_peak=self.baseline_peak, final_peak=prof.peak_bytes,
                             stages=pstages,
                             meta=dict(saved.meta, rescaled_from=saved.cache_key))
        else:
            plan = saved
        records = [StageRecord(stage=i, region=(st.s, st.e), n_chunks=st.n_chunks,
                               chunk_extent=st.chunk_extent, n_loop_eqns=len(st.in_loop),
                               n_hoisted=len(st.hoisted), cost=st.cost,
                               peak_before=st.peak_before, peak_after=st.peak_after)
                   for i, st in enumerate(plan.stages)]
        return Planned(traced=self, plan=plan, records=records, flat_fn=fn, graph=g,
                       profile=prof, from_cache=True, bucket_hit=rescale)


@dataclass
class Planned:
    """Stage 2: a finished chunk search: the :class:`ChunkPlan` plus the
    emitted callable and the rewritten graph it evaluates."""

    traced: Traced
    plan: ChunkPlan
    records: List[StageRecord]
    flat_fn: Callable
    graph: Graph
    profile: MemoryProfile
    from_cache: bool = False
    bucket_hit: bool = False

    @property
    def final_peak(self) -> int:
        return self.profile.peak_bytes

    @property
    def baseline_peak(self) -> int:
        return self.traced.baseline_peak

    @property
    def budget_bytes(self) -> int:
        return self.traced.budget_bytes

    def save(self, path) -> None:
        self.plan.save(path)

    def compile(self) -> "CompiledFunction":
        """Stage 3: package the plan's callable in the original signature."""
        t = self.traced
        result = _package_result(
            fn=self.flat_fn, out_spec_box=t.out_spec_box, plan=self.records,
            plan_stages=list(self.plan.stages), baseline_peak=t.baseline_peak,
            final_peak=self.profile.peak_bytes, budget_bytes=t.budget_bytes,
            io_bytes=self.profile.io_bytes, weight_bytes=self.profile.weight_bytes,
            elapsed_s=time.perf_counter() - t._t0, trace_s=t.trace_s,
            search_s=t.search_s, from_cache=self.from_cache,
            cache_key=self.plan.cache_key)
        result.accuracy = obs_accuracy.publish(self.plan_accuracy())
        return CompiledFunction(result, bucket_hit=self.bucket_hit)

    def plan_accuracy(self) -> obs_accuracy.PlanAccuracy:
        """Predicted-against-measured activation peak of this plan.

        *Predicted* is the search-time number: the last stage's
        ``peak_after`` (the chunk loops' modeled body peaks, before kernel
        dispatch), or the baseline peak of a plan with no stage.
        *Measured* is the live-set watermark of the graph the plan runs
        (after dispatch), so the error is the search model's drift.  The
        serving layer upgrades the measurement to the card's allocator peak
        over one run of the plan (``obs.accuracy.with_device_measurement``).
        """
        predicted = (self.plan.stages[-1].peak_after if self.plan.stages
                     else self.plan.baseline_peak)
        return obs_accuracy.compare(
            predicted, obs_accuracy.watermark_graph(self.graph), "interpret",
            cache_key=self.plan.cache_key, final_peak_estimate=self.profile.peak_bytes)


class CompiledFunction:
    """Stage 3 product: the chunked callable with its compilation report.

    Calling it runs the emitted Python program eagerly under the caller's
    grad mode: the chunk loops are aten ops into ``torch.empty`` buffers
    (``narrow(...).copy_()``), which autograd differentiates.  A compile
    that needs gradients holds no kernel node (no kernel has a backward)."""

    def __init__(self, result: AutoChunkResult, *, bucket_hit: bool = False):
        self.result = result
        self.fn = result.fn
        self.bucket_hit = bucket_hit

    @property
    def from_cache(self) -> bool:
        return self.result.from_cache

    @property
    def final_peak(self) -> int:
        return self.result.final_peak

    def report(self) -> str:
        return self.result.report()

    def __call__(self, *args):
        return self.fn(*args)


# ---------------------------------------------------------------------------
# The transform
# ---------------------------------------------------------------------------

class ChunkedFunction:
    """``autochunk(fn, config)``: a function transformed for chunked execution.

    * Direct call: ``cf(*args)`` compiles lazily for the input shapes (one
      search per shape bucket, replayed for sibling shapes) and runs.
    * Staged: ``cf.trace(*args).search().compile()`` exposes each pass.
    * Decorator: ``@autochunk(ChunkConfig(...))``.
    """

    def __init__(self, fn: Callable, config: Optional[ChunkConfig] = None, *, cache=None,
                 bucketer=_DEFAULT_BUCKETER):
        if not callable(fn):
            raise TypeError(f"autochunk target must be callable, got {fn!r}")
        self.fn = fn
        self.config = config if config is not None else ChunkConfig()
        if not isinstance(self.config, ChunkConfig):
            raise TypeError(f"config must be a ChunkConfig, got {type(self.config).__name__}")
        self.cache = as_plan_cache(cache)
        self.bucketer: Optional[ShapeBucketer] = (
            ShapeBucketer() if bucketer is _DEFAULT_BUCKETER else bucketer)
        self._bucket_plans: Dict[str, ChunkPlan] = {}
        self._compiled: Dict[Any, CompiledFunction] = {}
        # canonical bucket executables: one CompiledFunction per bucket
        # signature, compiled at the boundary; `_padded` memoizes the
        # pad / slice wrapper per exact (non-canonical) input signature
        self._bucket_execs: Dict[Any, CompiledFunction] = {}
        self._padded: Dict[Any, Callable] = {}
        self.counters: Dict[str, int] = {"calls": 0, "compiles": 0, "shape_hits": 0,
                                         "bucket_hits": 0, "bucket_misses": 0,
                                         "bucket_exec_hits": 0, "bucket_exec_compiles": 0}
        functools.update_wrapper(self, fn, updated=())

    def trace(self, *example_args) -> Traced:
        """Stage 1: trace + memory estimate at the given arguments' shapes."""
        if not example_args:
            raise ValueError("trace() needs at least one example argument")
        return Traced(self, example_args)

    def compile(self, *example_args) -> CompiledFunction:
        """One-shot: ``trace -> search -> compile`` for these arguments."""
        compiled = self.trace(*example_args).search().compile()
        self._maybe_evict()
        return compiled

    def _maybe_evict(self) -> int:
        """Honour the config's eviction knobs after a compile (the only point
        where this transform grows the plan cache)."""
        cfg = self.config
        if self.cache is None or cfg.cache_max_entries is None:
            return 0
        return self.cache.evict(policy=cfg.cache_policy, max_entries=cfg.cache_max_entries)

    def _shape_key(self, args) -> Any:
        leaves, spec = pytree.tree_flatten(tuple(args))
        return (str(spec), tuple(_leaf_key(x) for x in leaves), needs_grad(leaves))

    def __call__(self, *args):
        self.counters["calls"] += 1
        key = self._shape_key(args)
        compiled = self._compiled.get(key)
        if compiled is not None:
            self.counters["shape_hits"] += 1
            return compiled(*args)
        padded_fn = self._padded.get(key)
        if padded_fn is not None:
            # a length already wrapped: pad -> the bucket's executable -> slice
            self.counters["shape_hits"] += 1
            self.counters["bucket_exec_hits"] += 1
            stats.bump("bucket_exec_hits")
            return padded_fn(*args)
        if self.config.canonical_bucket_exec and self.bucketer is not None:
            return self._canonical_call(key, args)
        self.counters["compiles"] += 1
        compiled = self.compile(*args)
        self._compiled[key] = compiled
        return compiled(*args)

    # -- canonical bucket executables -----------------------------------
    def _canonical_specs(self, args):
        """The bucket signature of ``args`` and the arguments to compile its
        executable at: each activation leaf a ``meta`` tensor at the
        boundary shape, each weight leaf itself (padding parameters would
        change the program; the real weights carry the device the compile
        targets)."""
        flat, in_spec, weight_flat = _flatten_spec(args, self.config.weight_argnums)
        wset = frozenset(weight_flat)
        specs = [x if i in wset else
                 torch.empty(self.bucketer.canonical_shape(x.shape), dtype=x.dtype,
                             device="meta", requires_grad=x.requires_grad)
                 for i, x in enumerate(flat)]
        key = ((str(in_spec), needs_grad(flat)),
               tuple(_leaf_sig(c) + (x.device.type,) for c, x in zip(specs, flat)))
        needs_pad = any(c.shape != x.shape for c, x in zip(specs, flat))
        return key, pytree.tree_unflatten(specs, in_spec), needs_pad

    def _canonical_call(self, key, args):
        """Serve ``args`` through their bucket's canonical executable.

        The first call in a bucket compiles one CompiledFunction at the
        boundary shape; every other length in the bucket is padded up and
        its outputs sliced back: zero traces, zero searches.  The function
        must be length-masked (see ``ChunkConfig.canonical_bucket_exec``).
        """
        ckey, spec_args, needs_pad = self._canonical_specs(args)
        compiled = self._bucket_execs.get(ckey)
        if compiled is None:
            stats.bump("bucket_exec_misses")
            stats.bump("bucket_exec_compiles")
            self.counters["compiles"] += 1
            self.counters["bucket_exec_compiles"] += 1
            compiled = self.compile(*spec_args)
            self._bucket_execs[ckey] = compiled
        else:
            stats.bump("bucket_exec_hits")
            self.counters["bucket_exec_hits"] += 1
        if not needs_pad:
            self._compiled[key] = compiled      # the canonical shape itself
            return compiled(*args)
        # the true output shapes from running the function on meta tensors at
        # the true shapes (no graph capture, no search): the counterpart of
        # jax.eval_shape
        with torch.no_grad():
            out_specs = self.fn(*pytree.tree_map(_to_meta, tuple(args)))
        padded_fn = emit_padded_call(compiled, pytree.tree_map(_to_meta, spec_args), out_specs)
        self._padded[key] = padded_fn
        return padded_fn(*args)

    @property
    def autochunk_result(self) -> Optional[AutoChunkResult]:
        """Report of the most recent compile."""
        if not self._compiled:
            return None
        return next(reversed(self._compiled.values())).result

    def stats(self) -> Dict[str, Any]:
        out = dict(self.counters)
        out["compiled_shapes"] = len(self._compiled)
        out["bucket_plans"] = len(self._bucket_plans)
        out["bucket_execs"] = len(self._bucket_execs)
        out["padded_shapes"] = len(self._padded)
        if self.cache is not None:
            out["plan_cache"] = self.cache.stats()
        return out

    def __repr__(self) -> str:
        name = getattr(self.fn, "__name__", repr(self.fn))
        return (f"ChunkedFunction({name}, budget={self.config.budget_bytes or self.config.budget_ratio},"
                f" shapes={len(self._compiled)})")
