"""Serving engines: fixed slots over ring KV caches, and continuous
batching over a paged KV pool.

A port of the JAX package's ``ServeEngine`` and ``PagedServeEngine``.

``ServeEngine`` holds ``max_batch`` slots, each one request's cache: K/V
rings of ``cache_width`` positions (a sliding-window model keeps only its
window, so it serves past it), and for the SSM and hybrid families each
recurrent layer's f32 state and conv window; for MLA each layer's latent
ring (``ckv`` and ``kr``).  It serves the dense, vlm, MoE (MLA included),
SSM and hybrid families.  A request is prefilled
alone into a free slot; one decode wave then advances every slot by one token, each at its
own position (one batched step with a ``pos`` of shape (B,), where the JAX
package vmaps a one-row step).  With ``cfg.autochunk_budget`` the prefill
runs the per-block compiled forward (attention and SwiGLU on their
kernels); with ``autochunk_budget`` the decode wave is compiled through the
AutoChunk pipeline, on the engine's plan cache and shape bucketer, at the
bucket boundary of ``max_len`` (``exec_len``), so ``reconfigure()`` inside
a warm bucket reuses the wave object-identically.

``PagedServeEngine`` assembles, at each step, one ragged batch holding a
single token for every decoding sequence plus a planner-sized chunk of
prompt for sequences still prefilling, and runs it through the model with
the hand-written paged attention kernel at every layer:

* admission is bounded by free pages, not slots: a request is admitted iff
  the pool can reserve ``prompt + max_new_tokens`` worth of pages, so an
  admitted sequence can never run out of pages mid-decode;
* the prefill chunk comes from the AutoChunk estimator
  (:func:`~repro_torch.core.estimation.plan_prefill_chunk`): the largest
  power of two whose one-block activation peak fits the budget;
* KV memory has no padding: a sequence holds ``ceil(len / page_size)``
  pages;
* with ``prefix_cache=True`` admission matches the prompt against the
  radix cache of earlier prompts (:mod:`~repro_torch.serving.prefix_cache`),
  shares the matched pages and starts prefill at the divergence point;
  ``spill_pages`` adds the host spill tier, so an admission short of pages
  spills cached pages and retries.

Both engines record, unless built with ``obs=False``, the JAX package's
serving telemetry (:class:`_EngineObs`): host spans ``serve.step``,
``serve.admit``, ``serve.prefill_chunk`` and ``serve.decode_wave`` (the
slot engine's wave compile under ``serve.compile``), the TTFT, queue-wait,
step-latency and decode-throughput histograms, and the pages-in-use and
cache-hit-ratio gauges, all at step boundaries.  The spans measure host
time: a span around a launch ends when the work is enqueued, and the
step's sampling (``.tolist()``) is where the host waits for the card
(``repro_torch.obs.tracing``).  The JAX paged engine's
``serve.step_compile`` (one ``jax.jit`` per query width) has no
counterpart: the port's ragged step runs eagerly and compiles nothing.
Each engine's ``plan_accuracy()`` holds its plan's predicted activation
peak against the graph's watermark and, on the card, against the
allocator's peak over the plan's first run.

Not in this slice, for either engine (each raises ``NotImplementedError``
naming its ROADMAP item): kernel autotuning and the device mesh.
"""
from __future__ import annotations

import time
from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..configs.base import ModelConfig
from ..core import stats
from ..device import resolve_device
from ..kernels.paged_attention import cuda_refusal, paged_attention_blocked
from ..models import layers as L
from ..models import model as M
from ..models.model import Model
from ..obs import accuracy as obs_accuracy
from ..obs import metrics as obs_metrics
from ..obs.tracing import span as _span


@dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    # opt-out of the prefix cache: the request may still match cached
    # prefixes, but its own prompt is never inserted
    cache_prefix: bool = True
    generated: List[int] = field(default_factory=list)
    done: bool = False
    # monotonic timestamps (time.perf_counter); ttft_s/latency_s are durations
    submitted_at: float = field(default_factory=time.perf_counter)
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_at is None:
            return None
        return self.first_token_at - self.submitted_at

    @property
    def latency_s(self) -> Optional[float]:
        if self.finished_at is None:
            return None
        return self.finished_at - self.submitted_at


def _sample(logits, greedy: bool, generator) -> List[int]:
    """One token per row of ``logits`` (rows, V): greedy argmax, else a draw
    with the engine's generator."""
    if greedy:
        return torch.argmax(logits, dim=-1).tolist()
    probs = torch.softmax(logits.float(), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].tolist()


def _refuse_unported(autotune: bool, mesh) -> None:
    for name, asked, item in (
        ("autotune", autotune, "ROADMAP queue A item 7 (autotune)"),
        ("mesh", mesh is not None, "ROADMAP queue A item 11 (mesh)"),
    ):
        if asked:
            raise NotImplementedError(f"{name} is not in the port yet: {item}")


class _EngineObs:
    """Step-boundary serving instruments shared by both engines (the JAX
    package's names, buckets and help strings).

    All recording happens at step boundaries with values the scheduler
    already holds on the host (no device syncs, nothing per token).
    ``enabled=False`` turns every record and span into a no-op.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        reg = obs_metrics.default_registry()
        self.ttft = reg.histogram(
            "serve_ttft_seconds", obs_metrics.LATENCY_BUCKETS_S,
            "submit -> first token, per finished prefill")
        self.queue_wait = reg.histogram(
            "serve_queue_wait_seconds", obs_metrics.LATENCY_BUCKETS_S,
            "submit -> admission, per admitted request")
        self.step_latency = reg.histogram(
            "serve_step_latency_seconds", obs_metrics.LATENCY_BUCKETS_S,
            "one engine step (admit + ragged batch + sample + retire)")
        self.decode_tps = reg.histogram(
            "serve_decode_tok_per_s", obs_metrics.THROUGHPUT_BUCKETS,
            "decode tokens per second, per step carrying decode rows")
        self.pages_in_use = reg.gauge(
            "serve_pages_in_use", "KV-pool pages currently allocated")
        self.cache_hit_ratio = reg.gauge(
            "serve_cache_hit_ratio",
            "plan-cache (slot engine) or prefix-cache (paged) hit ratio")

    def span(self, name: str, **args):
        return _span(name, **args) if self.enabled else nullcontext()

    def record_admit(self, req: Request, now: float) -> None:
        if self.enabled:
            self.queue_wait.observe(max(now - req.submitted_at, 0.0))

    def record_first_token(self, req: Request) -> None:
        if self.enabled and req.ttft_s is not None:
            self.ttft.observe(req.ttft_s)

    def record_step(self, dt_s: float, decode_tokens: int) -> None:
        if not self.enabled:
            return
        self.step_latency.observe(dt_s)
        if decode_tokens > 0 and dt_s > 0:
            self.decode_tps.observe(decode_tokens / dt_s)

    def peak_run(self, device, fn, *args):
        """``fn(*args)`` with the card's allocator peak taken around it:
        returns ``(out, (baseline_bytes, peak_bytes))``, or ``(out, None)``
        when disabled or off the card.  Resets the process's
        ``max_memory_allocated`` mark (``obs.accuracy.reset_device_peak``);
        no device sync: the allocator counts as the host issues work."""
        base = (obs_accuracy.device_bytes_in_use(device)
                if self.enabled and device.type == "cuda" else None)
        if base is None:
            return fn(*args), None
        obs_accuracy.reset_device_peak(device)
        out = fn(*args)
        return out, (base, obs_accuracy.device_peak_bytes(device))


class ServeEngine:
    """Fixed-slot batched serving over ring KV caches, MLA latent rings and
    recurrent states (the dense, vlm, MoE, SSM and hybrid families).  A MoE
    decode wave routes one token a row, each row a routing group of its
    own, so no expert overflows.

    The engine holds no bound method of itself (the plain wave is a
    function of the config and weights, a compiled wave's closure holds its
    graph and the weights), so a dropped engine and its cache are freed at
    once, without a garbage collection.

    With ``obs`` (the default) and a compiled wave on the card, the first
    wave the engine runs after each compile is also its device measurement
    (:meth:`plan_accuracy`): the allocator's peak over that one wave, the
    cache and weights already allocated, the process's high-water mark
    reset just before it.
    """

    def __init__(
        self,
        cfg: ModelConfig,
        params: Model,
        *,
        max_batch: int = 4,
        max_len: int = 256,
        autochunk_budget: Optional[float] = None,
        autotune: bool = False,
        plan_cache=None,
        bucket_lens=None,
        canonical_bucket_exec: bool = True,
        cache_policy: str = "lru",
        cache_max_entries: Optional[int] = None,
        greedy: bool = True,
        seed: int = 0,
        obs: bool = True,
        mesh=None,
        device="cuda",
    ):
        from ..core import ShapeBucketer
        from ..core.plan import PlanCache, as_plan_cache

        _refuse_unported(autotune, mesh)
        M._check_decode_family(cfg)
        self._obs = _EngineObs(obs)
        # (baseline, peak) allocator bytes around the current wave's first
        # run on the card; None until then, and on the CPU
        self._dev_peak = None
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params.to(self.device)
        self.max_batch = max_batch
        self.max_len = max_len
        self.greedy = greedy
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.autochunk_budget = autochunk_budget
        # with a budget, an in-memory cache is always made, so reconfigure()
        # back to a shape seen before replays its plan
        self.plan_cache = as_plan_cache(plan_cache)
        if self.plan_cache is None and autochunk_budget is not None:
            self.plan_cache = PlanCache()
        if cache_policy not in PlanCache.POLICIES:
            raise ValueError(f"cache_policy must be one of {PlanCache.POLICIES},"
                             f" got {cache_policy!r}")
        self.cache_policy = cache_policy
        self.cache_max_entries = cache_max_entries
        self.bucketer = ShapeBucketer(buckets=tuple(bucket_lens) if bucket_lens else None)
        # slots and the decode wave are built at the bucket boundary of
        # max_len: one wave serves the whole bucket (max_len stays the
        # logical cap)
        self.canonical_bucket_exec = canonical_bucket_exec
        self.autochunk_result = None
        self._chunked_fn = None
        # (max_batch, exec_len) -> (decode wave, autochunk result): a
        # reconfigure inside a warm bucket restores them object-identically
        self._wave_cache: Dict[tuple, tuple] = {}
        self.exec_stats = {"wave_compiles": 0, "wave_reuses": 0, "evicted": 0}
        self.waiting: List[Request] = []
        self.finished: List[Request] = []
        self.n_decode_steps = 0
        self._init_slots()
        self._compile()

    @property
    def exec_len(self) -> int:
        """Cache and wave length: the bucket boundary of ``max_len``."""
        if not self.canonical_bucket_exec:
            return self.max_len
        return max(self.max_len, self.bucketer.canonical_dim(self.max_len))

    # ------------------------------------------------------------------
    def _init_slots(self):
        # one batched cache, slot b in row b of every leaf; decode masking
        # is position-driven, so a tail past max_len is never attended to
        self.cache = M.init_cache(self.cfg, self.max_batch, self.exec_len, device=self.device)
        self.slot_req: List[Optional[Request]] = [None] * self.max_batch
        self.slot_pos = [0] * self.max_batch

    def _compile(self):
        from ..core import ChunkConfig, ChunkedFunction

        ev0 = self.plan_cache.evictions if self.plan_cache is not None else 0
        wave_key = (self.max_batch, self.exec_len)
        cached = self._wave_cache.get(wave_key)
        if cached is not None:
            # warm bucket: zero traces, zero searches
            self._decode_wave, self.autochunk_result = cached
            self._dev_peak = None
            self.exec_stats["wave_reuses"] += 1
            if self.canonical_bucket_exec:
                stats.bump("bucket_exec_hits")
            self._record_telemetry(hit=True)
            self._maybe_evict(ev0)
            return
        if self.canonical_bucket_exec:
            # this compile is the bucket's one boundary build (plain waves
            # count too, so the ratios stay meaningful per engine)
            stats.bump("bucket_exec_misses")
            stats.bump("bucket_exec_compiles")
        wave = _plain_wave(self.cfg, self.params)
        if self.autochunk_budget is not None:
            if self._chunked_fn is None:
                # one transform for the engine's lifetime: reconfigure()
                # compiles through it, reusing exact or bucketed plans.  The
                # weights are argument 0 (graph inputs, not constants)
                self._chunked_fn = ChunkedFunction(
                    M.decode_fn(self.params),
                    ChunkConfig.from_scalar(
                        self.autochunk_budget, weight_argnums=(0,),
                        canonical_bucket_exec=self.canonical_bucket_exec,
                        cache_policy=self.cache_policy,
                        cache_max_entries=self.cache_max_entries),
                    cache=self.plan_cache, bucketer=self.bucketer)
            B = self.max_batch
            specs = (pytree.tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                                           device="meta"), self.cache),
                     torch.empty((B,), dtype=torch.int64, device="meta"),
                     torch.empty((B,), dtype=torch.int64, device="meta"))
            # the cache specs are already at the bucket boundary: this is
            # the bucket's compile
            weights = dict(self.params.named_parameters())
            with self._obs.span("serve.compile", exec_len=self.exec_len):
                compiled = self._chunked_fn.compile(weights, *specs)
            self.autochunk_result = res = compiled.result
            if res.accuracy is not None and res.cache_key and self.plan_cache is not None:
                self.plan_cache.record_accuracy(res.cache_key, res.accuracy)

            def wave(cache, toks, pos, _fn=compiled.fn, _w=weights):
                return _fn(_w, cache, toks, pos)

        self._decode_wave = wave
        self._dev_peak = None
        self.exec_stats["wave_compiles"] += 1
        self._wave_cache[wave_key] = (self._decode_wave, self.autochunk_result)
        self._record_telemetry(hit=False)
        self._maybe_evict(ev0)

    # ------------------------------------------------------------------
    def _record_telemetry(self, *, hit: bool) -> None:
        """Serving telemetry into the plan-cache entry's metadata."""
        res = self.autochunk_result
        if self.plan_cache is None or res is None or not res.cache_key:
            return
        self.plan_cache.record_use(res.cache_key, hit=hit, compile_s=res.elapsed_s,
                                   bucket=self.exec_len)

    def _maybe_evict(self, evictions_before: int = 0) -> int:
        """Plan-cache eviction, only at idle points (construction and
        ``reconfigure``); evictions the compile made count too."""
        if self.plan_cache is None:
            return 0
        if self.cache_max_entries is not None:
            self.plan_cache.evict(policy=self.cache_policy,
                                  max_entries=self.cache_max_entries)
        n = self.plan_cache.evictions - evictions_before
        self.exec_stats["evicted"] += n
        return n

    def reconfigure(self, *, max_batch: Optional[int] = None,
                    max_len: Optional[int] = None) -> None:
        """Re-shape the slots (and the wave), only while idle.  Inside a
        warm bucket the bucket's wave is reused outright; otherwise a warm
        plan cache replays the stored plan instead of searching."""
        if any(r is not None for r in self.slot_req) or self.waiting:
            raise RuntimeError("reconfigure() requires an idle engine")
        if max_batch is not None:
            self.max_batch = max_batch
        if max_len is not None:
            self.max_len = max_len
        self._init_slots()
        self._compile()

    # ------------------------------------------------------------------
    def submit(self, req: Request):
        self.waiting.append(req)

    def _free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slot_req) if r is None]

    def _admit(self):
        for slot in self._free_slots():
            if not self.waiting:
                break
            req = self.waiting.pop(0)
            self._obs.record_admit(req, time.perf_counter())
            toks = torch.tensor([req.prompt], dtype=torch.int64, device=self.device)
            with self._obs.span("serve.prefill_chunk", rid=req.rid, tokens=len(req.prompt)):
                logits, cache1 = M.prefill(self.cfg, self.params, {"tokens": toks},
                                           self.exec_len)
            # the request's cache into its slot: row `slot` of every leaf
            M.write_cache_row(self.cache, slot, cache1)
            req.generated.append(_sample(logits[0, -1:], self.greedy, self.generator)[0])
            req.first_token_at = time.perf_counter()
            self._obs.record_first_token(req)
            self.slot_req[slot] = req
            self.slot_pos[slot] = len(req.prompt)

    def _retire(self):
        for i, req in enumerate(self.slot_req):
            if req is None:
                continue
            hit_eos = (req.eos_id is not None and req.generated
                       and req.generated[-1] == req.eos_id)
            if len(req.generated) >= req.max_new_tokens or hit_eos:
                req.done = True
                req.finished_at = time.perf_counter()
                self.finished.append(req)
                self.slot_req[i] = None

    # ------------------------------------------------------------------
    @torch.no_grad()
    def step(self) -> int:
        """Admit -> decode one wave -> retire; returns the rows decoded."""
        if not self._obs.enabled:
            return self._step_inner()
        t0 = time.perf_counter()
        with self._obs.span("serve.step"):
            rows = self._step_inner()
        if rows:
            self._obs.record_step(time.perf_counter() - t0, rows)
            if self.plan_cache is not None:
                seen = self.plan_cache.hits + self.plan_cache.misses
                if seen:
                    self._obs.cache_hit_ratio.set(self.plan_cache.hits / seen)
        return rows

    def _step_inner(self) -> int:
        with self._obs.span("serve.admit"):
            self._admit()
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return 0
        toks = torch.tensor([r.generated[-1] if r is not None else 0 for r in self.slot_req],
                            dtype=torch.int64, device=self.device)
        pos = torch.tensor(self.slot_pos, dtype=torch.int64, device=self.device)
        with self._obs.span("serve.decode_wave", rows=len(active)):
            if self._dev_peak is None and self.autochunk_result is not None:
                logits, self._dev_peak = self._obs.peak_run(
                    self.device, self._decode_wave, self.cache, toks, pos)
            else:
                logits = self._decode_wave(self.cache, toks, pos)
        self.n_decode_steps += 1
        nxt = _sample(logits, self.greedy, self.generator)
        for i in active:
            self.slot_req[i].generated.append(int(nxt[i]))
            self.slot_pos[i] += 1
        self._retire()
        return len(active)

    def run(self, max_steps: int = 10_000) -> List[Request]:
        for _ in range(max_steps):
            if not self.waiting and all(r is None for r in self.slot_req):
                break
            self.step()
        return self.finished

    def metrics(self) -> dict:
        """Aggregate serving metrics over finished requests."""
        done = self.finished
        toks = sum(len(r.generated) for r in done)
        ttfts = [r.ttft_s for r in done if r.ttft_s is not None]
        lats = [r.latency_s for r in done if r.latency_s is not None]
        span = max((r.finished_at for r in done), default=0.0) - min(
            (r.submitted_at for r in done), default=0.0)
        out = {
            "requests": len(done),
            "tokens": toks,
            "decode_waves": self.n_decode_steps,
            "throughput_tok_s": toks / span if span > 0 else 0.0,
            "mean_ttft_s": sum(ttfts) / len(ttfts) if ttfts else 0.0,
            "mean_latency_s": sum(lats) / len(lats) if lats else 0.0,
            "exec_len": self.exec_len,
            "bucket_exec": dict(self.exec_stats),
        }
        if self.plan_cache is not None:
            out["plan_cache"] = self.plan_cache.stats()
            res = self.autochunk_result
            if res is not None and res.cache_key:
                out["plan_telemetry"] = self.plan_cache.entry_meta(res.cache_key)
        acc = self.plan_accuracy()
        if acc is not None:
            out["plan_accuracy"] = acc.to_dict()
        return out

    def plan_accuracy(self) -> Optional[obs_accuracy.PlanAccuracy]:
        """Predicted-against-measured activation peak of the compiled wave
        (None for the plain wave).

        The interpret record comes from the compile (the search's predicted
        peak against the emitted graph's watermark).  On the card, once the
        wave has run, the measurement is upgraded to the allocator's peak
        over its first run, and the upgraded record goes into the plan
        cache's telemetry.
        """
        res = self.autochunk_result
        if res is None or res.accuracy is None:
            return None
        acc = obs_accuracy.with_device_measurement(res.accuracy, *(self._dev_peak or (None, None)))
        if acc is not res.accuracy and self.plan_cache is not None and res.cache_key:
            self.plan_cache.record_accuracy(res.cache_key, acc)
        return acc


def _plain_wave(cfg: ModelConfig, params: Model):
    """The eager decode wave ``(cache, toks, pos) -> logits (B, V)``, the
    cache written in place.  A function of the config and weights, not a
    method: stored on the engine, a bound method would hold the engine in
    a reference cycle."""

    def wave(cache, toks, pos):
        logits, _ = M.decode_step(cfg, params, cache, toks[:, None], pos)
        return logits[:, 0]

    return wave


@dataclass
class _SeqState:
    """A running sequence: scheduler-side view of one admitted request."""

    req: Request
    seq_id: int
    prefilled: int = 0        # prompt tokens already written into the pool
    kv_len: int = 0           # total tokens written (prompt part + generated)

    @property
    def in_prefill(self) -> bool:
        return self.prefilled < len(self.req.prompt)


class PagedServeEngine:
    """Continuous batching over a paged KV pool, causal dense/GQA decoders.

    With ``obs`` (the default) on the card, the first step that carries
    prefill rows is also the device measurement of :meth:`plan_accuracy`:
    the allocator's peak over that step's ragged batch.
    """

    def __init__(
        self,
        cfg: ModelConfig,
        params: Model,
        *,
        max_seqs: int = 4,
        max_len: int = 256,
        page_size: int = 16,
        num_pages: Optional[int] = None,
        autochunk_budget: Optional[float] = None,
        autotune: bool = False,
        prefill_chunk="auto",
        prefix_cache: bool = False,
        spill_pages: int = 0,
        greedy: bool = True,
        seed: int = 0,
        obs: bool = True,
        mesh=None,
        device="cuda",
    ):
        from ..core.estimation import plan_prefill_chunk
        from .kv_pool import KVPool
        from .prefix_cache import PrefixCache

        _refuse_unported(autotune, mesh)
        if spill_pages and not prefix_cache:
            raise ValueError("spill_pages requires prefix_cache=True")
        if cfg.family not in ("dense", "vlm") or cfg.mla or not cfg.causal:
            # SSM and hybrid states keep the slot engine, as in the JAX package
            raise ValueError(
                "PagedServeEngine serves causal dense/GQA decoders;"
                f" got family={cfg.family!r} mla={cfg.mla} causal={cfg.causal}"
            )
        if cfg.sliding_window is not None and cfg.sliding_window < max_len:
            raise ValueError("paged serving keeps the full context; a sliding-window"
                             " arch past its window is served by ServeEngine (ring"
                             " caches of the window's width)")
        self.device = resolve_device(device)
        why = cuda_refusal(cfg.hd) if self.device.type == "cuda" else None
        if why is not None:
            raise NotImplementedError(f"{why}: this head dim's paged kernel instance is"
                                      " ROADMAP queue B2 (the CPU serves it)")
        self.cfg = cfg
        self.params = params.to(self.device)
        self.max_seqs = max_seqs
        self.max_len = max_len
        self.page_size = page_size
        self.greedy = greedy
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.autochunk_budget = autochunk_budget
        self._obs = _EngineObs(obs)
        self._accuracy: Optional[obs_accuracy.PlanAccuracy] = None
        # (baseline, peak) allocator bytes around the first prefill step on
        # the card; None until then, and on the CPU
        self._dev_peak = None

        if num_pages is None:
            # every row of the step batch can hold a max_len sequence
            num_pages = max_seqs * (-(-max_len // page_size))
        self.pool = KVPool.for_config(cfg, num_pages=num_pages,
                                      page_size=page_size, device=self.device)
        self.max_pages_per_seq = self.pool.pages_for(max_len)
        # the radix cache of prompt prefixes over the pool's pages; with
        # spill_pages > 0 the pool gets its host arena
        self.prefix_cache = (PrefixCache(self.pool, spill_pages=spill_pages)
                             if prefix_cache else None)

        if prefill_chunk == "auto":
            self.prefill_plan = plan_prefill_chunk(
                cfg, budget=autochunk_budget if autochunk_budget else 0.5,
                max_len=max_len)
            self.prefill_chunk = min(self.prefill_plan.chunk, max_len)
        else:
            self.prefill_plan = None
            self.prefill_chunk = int(prefill_chunk)
        if self.prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")

        self.waiting: List[Request] = []
        self.running: List[_SeqState] = []
        self.finished: List[Request] = []
        self._next_seq_id = 0
        self.sched_stats = {
            "steps": 0,
            "mixed_steps": 0,
            "prefill_steps": 0,
            "decode_steps": 0,
            "prefill_chunks": 0,
            "decode_tokens": 0,
            "admission_refusals": 0,
            "prefix_hits": 0,
            "prefix_tokens_reused": 0,
            "spill_retries": 0,
        }

    # ------------------------------------------------------------------
    @torch.no_grad()
    def run_ragged(self, tokens, q_lens, kv_lens, page_table):
        """One ragged step through every layer; returns (S, vocab) logits at
        each row's last real query position.

        ``tokens``: (S, q_max) int; ``q_lens``/``kv_lens``: (S,) int32 with
        ``kv_lens`` counting context including this step's new tokens;
        ``page_table``: (S, max_pages) int32; all on the engine's device.
        Each layer writes its new K/V rows into the pool, then attends.
        """
        cfg, params = self.cfg, self.params
        S, q_max = tokens.shape
        ps = self.page_size
        ar = torch.arange(q_max, dtype=torch.int32, device=self.device)
        positions = (kv_lens - q_lens)[:, None] + ar[None, :]
        valid = ar[None, :] < q_lens[:, None]
        logical = (positions // ps).clamp(0, self.max_pages_per_seq - 1)
        phys = torch.gather(page_table, 1, logical.long())
        slots = phys * ps + positions % ps
        slots = torch.where(valid, slots, self.pool.trash_page * ps).reshape(-1).long()

        h = L.embed(cfg, params["embed"], tokens)            # (S, q_max, d)
        for i in range(cfg.n_layers):
            p = params.layer_params(i)
            hn = L.apply_norm(cfg, h, p["ln1"])
            q, k, v = L.attn_project_qkv(cfg, p["attn"], hn, positions)
            self.pool.write(i, slots, k.reshape(S * q_max, cfg.n_kv_heads, cfg.hd),
                            v.reshape(S * q_max, cfg.n_kv_heads, cfg.hd))
            o = paged_attention_blocked(q, self.pool.pages[i], page_table,
                                        q_lens, kv_lens)
            h = h + o.reshape(S, q_max, -1) @ p["attn"]["wo"]
            hn = L.apply_norm(cfg, h, p["ln2"])
            h = h + L.mlp(cfg, p["mlp"], hn)

        # the final norm is row-wise, so it runs on the gathered rows only
        rows = torch.arange(S, device=self.device)
        last = h[rows, (q_lens.long() - 1).clamp(0, q_max - 1)]
        last = L.apply_norm(cfg, last, params["final_norm"])
        return L.unembed(cfg, params["embed"], last)           # (S, V)

    # ------------------------------------------------------------------
    def submit(self, req: Request):
        total = len(req.prompt) + req.max_new_tokens
        if total > self.max_len:
            raise ValueError(
                f"request {req.rid}: prompt+max_new = {total} exceeds"
                f" max_len={self.max_len}"
            )
        self.waiting.append(req)

    def _reserve(self, sid: int, need: int, match) -> None:
        """One pool reservation, seeded by the prefix match when present.

        On :class:`OutOfPagesError` with the prefix cache on, asks the cache
        to release the shortfall (spill to the host arena, else drop LRU
        leaves; the matched pages are protected) and retries once.
        """
        from .kv_pool import OutOfPagesError

        kwargs = {}
        if match is not None and match.matched_tokens > 0:
            kwargs = dict(shared_pages=match.full_pages, shared_tokens=match.matched_tokens,
                          boundary_page=match.boundary_page)
        try:
            self.pool.reserve(sid, need, **kwargs)
            return
        except OutOfPagesError as e:
            if self.prefix_cache is None:
                raise
            shortfall = e.need - e.free
            protect = match.pages if match is not None else frozenset()
            self.sched_stats["spill_retries"] += 1
            if self.prefix_cache.release_pages(shortfall, protect=protect) < shortfall:
                raise
        self.pool.reserve(sid, need, **kwargs)

    def _admit(self):
        """FIFO admission bounded by pool pages, not batch slots."""
        from .kv_pool import OutOfPagesError

        while self.waiting and len(self.running) < self.max_seqs:
            req = self.waiting[0]
            sid = self._next_seq_id
            match = (self.prefix_cache.lock_prefix(req.prompt)
                     if self.prefix_cache is not None else None)
            try:
                self._reserve(sid, len(req.prompt) + req.max_new_tokens, match)
            except OutOfPagesError:
                # head-of-line blocking: wait for pages_freed, keep FIFO
                # order (pages lock_prefix restored stay cached and evictable)
                self.sched_stats["admission_refusals"] += 1
                stats.bump("admission_refusals")
                break
            matched = match.matched_tokens if match is not None else 0
            if matched > 0:
                stats.bump("prefix_hits")
                stats.bump("prefix_tokens_reused", matched)
                self.sched_stats["prefix_hits"] += 1
                self.sched_stats["prefix_tokens_reused"] += matched
            self._next_seq_id += 1
            self.waiting.pop(0)
            self._obs.record_admit(req, time.perf_counter())
            # matched tokens are already in the pool: prefill resumes at the
            # divergence point
            self.running.append(_SeqState(req=req, seq_id=sid, prefilled=matched,
                                          kv_len=matched))

    def _retire(self):
        still = []
        for st in self.running:
            req = st.req
            hit_eos = (req.eos_id is not None and req.generated
                       and req.generated[-1] == req.eos_id)
            if not st.in_prefill and (
                len(req.generated) >= req.max_new_tokens or hit_eos
            ):
                req.done = True
                req.finished_at = time.perf_counter()
                self.finished.append(req)
                self.pool.free(st.seq_id)
            else:
                still.append(st)
        self.running = still

    # ------------------------------------------------------------------
    def step(self):
        """Admit -> one mixed ragged step -> sample -> retire."""
        if not self._obs.enabled:
            return self._step_inner()
        t0 = time.perf_counter()
        decoded0 = self.sched_stats["decode_tokens"]
        stepped0 = self.sched_stats["steps"]
        with self._obs.span("serve.step"):
            self._step_inner()
        if self.sched_stats["steps"] > stepped0:
            self._obs.record_step(time.perf_counter() - t0,
                                  self.sched_stats["decode_tokens"] - decoded0)
            self._obs.pages_in_use.set(self.pool.pages_in_use)
            if self.prefix_cache is not None and self._next_seq_id:
                self._obs.cache_hit_ratio.set(self.sched_stats["prefix_hits"] / self._next_seq_id)

    def _step_inner(self):
        with self._obs.span("serve.admit"):
            self._admit()
        if not self.running:
            return

        # schedule: every decode row rides along; prefill rows consume a
        # shared per-step chunk budget (the planner's activation bound)
        chunk_budget = self.prefill_chunk
        sched: List[tuple] = []                  # (state, n_new, tokens)
        n_prefill_rows = n_decode_rows = 0
        for st in self.running[: self.max_seqs]:
            prompt = st.req.prompt
            if st.in_prefill:
                if chunk_budget <= 0:
                    continue                      # waits for the next step
                take = min(chunk_budget, len(prompt) - st.prefilled)
                toks = prompt[st.prefilled: st.prefilled + take]
                chunk_budget -= take
                n_prefill_rows += 1
                sched.append((st, take, toks))
            else:
                n_decode_rows += 1
                sched.append((st, 1, [st.req.generated[-1]]))
        if not sched:
            return

        q_max = self.prefill_chunk if n_prefill_rows else 1
        S = self.max_seqs
        tokens = np.zeros((S, q_max), np.int64)
        q_lens = np.zeros((S,), np.int32)
        kv_lens = np.zeros((S,), np.int32)
        seq_ids: List[Optional[int]] = [None] * S
        for row, (st, take, toks) in enumerate(sched):
            tokens[row, :take] = toks
            q_lens[row] = take
            kv_lens[row] = st.kv_len + take
            seq_ids[row] = st.seq_id
            self.pool.ensure(st.seq_id, st.kv_len + take)
        page_table = self.pool.table_array(seq_ids, self.max_pages_per_seq)

        batch = (torch.from_numpy(tokens).to(self.device),
                 torch.from_numpy(q_lens).to(self.device),
                 torch.from_numpy(kv_lens).to(self.device), page_table)
        batch_span = "serve.prefill_chunk" if n_prefill_rows else "serve.decode_wave"
        with self._obs.span(batch_span, prefill_rows=n_prefill_rows,
                            decode_rows=n_decode_rows, q_max=q_max):
            if n_prefill_rows and self._dev_peak is None and self.prefill_plan is not None:
                logits, self._dev_peak = self._obs.peak_run(self.device, self.run_ragged,
                                                            *batch)
            else:
                logits = self.run_ragged(*batch)

        # sample one token for every row that finished its context work
        need_rows = []
        for row, (st, take, _toks) in enumerate(sched):
            if st.in_prefill:
                st.prefilled += take
                st.kv_len += take
                if not st.in_prefill:
                    if self.prefix_cache is not None and st.req.cache_prefix:
                        # the prompt's KV is complete in the pool: cache it
                        # so the next admission can share it
                        n_pages = self.pool.pages_for(len(st.req.prompt))
                        self.prefix_cache.insert(st.req.prompt,
                                                 self.pool.table(st.seq_id)[:n_pages])
                    need_rows.append((row, st, True))
                else:
                    stats.bump("prefill_chunks")
                    self.sched_stats["prefill_chunks"] += 1
            else:
                st.kv_len += take
                need_rows.append((row, st, False))
        if need_rows:
            nxt = _sample(logits, self.greedy, self.generator)
            now = time.perf_counter()
            for row, st, finished_prefill in need_rows:
                st.req.generated.append(int(nxt[row]))
                if finished_prefill:
                    stats.bump("prefill_chunks")
                    self.sched_stats["prefill_chunks"] += 1
                    st.req.first_token_at = now
                    self._obs.record_first_token(st.req)
                else:
                    self.sched_stats["decode_tokens"] += 1

        self.sched_stats["steps"] += 1
        if n_prefill_rows and n_decode_rows:
            stats.bump("mixed_steps")
            self.sched_stats["mixed_steps"] += 1
        elif n_prefill_rows:
            self.sched_stats["prefill_steps"] += 1
        else:
            self.sched_stats["decode_steps"] += 1
        self._retire()

    def run(self, max_steps: int = 100_000) -> List[Request]:
        for _ in range(max_steps):
            if not self.waiting and not self.running:
                break
            self.step()
        return self.finished

    # ------------------------------------------------------------------
    def metrics(self) -> dict:
        done = self.finished
        toks = sum(len(r.generated) for r in done)
        ttfts = [r.ttft_s for r in done if r.ttft_s is not None]
        lats = [r.latency_s for r in done if r.latency_s is not None]
        span = max((r.finished_at for r in done), default=0.0) - min(
            (r.submitted_at for r in done), default=0.0
        )
        out = {
            "requests": len(done),
            "tokens": toks,
            "throughput_tok_s": toks / span if span > 0 else 0.0,
            "mean_ttft_s": sum(ttfts) / len(ttfts) if ttfts else 0.0,
            "mean_latency_s": sum(lats) / len(lats) if lats else 0.0,
            "prefill_chunk": self.prefill_chunk,
            "scheduler": dict(self.sched_stats),
            "kv_pool": self.pool.stats(),
        }
        if self.prefix_cache is not None:
            out["prefix_cache"] = self.prefix_cache.stats()
        if self.prefill_plan is not None:
            out["prefill_plan"] = {
                "chunk": self.prefill_plan.chunk,
                "budget_bytes": self.prefill_plan.budget_bytes,
                "peak_bytes": self.prefill_plan.peak_bytes,
                "fits": self.prefill_plan.fits,
            }
        acc = self.plan_accuracy()
        if acc is not None:
            out["plan_accuracy"] = acc.to_dict()
        return out

    def plan_accuracy(self) -> Optional[obs_accuracy.PlanAccuracy]:
        """Predicted-against-measured peak of the prefill-chunk plan.

        *Predicted* is the planner's estimate for the chosen chunk: one
        block step against a ``max_len`` context.  *Measured* (interpret) is
        the watermark of the same block step traced at the shapes the
        engine executes, the context rounded up to whole pool pages.  On
        the card, once a step with prefill rows has run, the measurement is
        the allocator's peak over that step's whole ragged batch: every
        layer, ``max_seqs`` rows padded to the chunk, and the logits, where
        the planner models one row's block.
        """
        if self.prefill_plan is None:
            return None
        if self._accuracy is None:
            from ..core.estimation import _prefill_step_graph

            kv_exec = self.max_pages_per_seq * self.page_size
            g = _prefill_step_graph(self.cfg, self.prefill_chunk, kv_exec)
            self._accuracy = obs_accuracy.publish(obs_accuracy.compare(
                self.prefill_plan.peak_bytes, obs_accuracy.watermark_graph(g), "interpret",
                chunk=self.prefill_chunk, kv_exec_len=kv_exec,
                budget_bytes=self.prefill_plan.budget_bytes))
        return obs_accuracy.with_device_measurement(self._accuracy,
                                                    *(self._dev_peak or (None, None)))
