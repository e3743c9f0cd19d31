"""Continuous batching over a paged KV pool.

A port of the JAX package's ``PagedServeEngine``.  Each engine step
assembles one ragged batch holding a single token for every decoding
sequence plus a planner-sized chunk of prompt for sequences still
prefilling, and runs it through the model with the hand-written paged
attention kernel at every layer:

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

Not in this slice (each raises ``NotImplementedError`` naming its ROADMAP
item): kernel autotuning, the device mesh, and the telemetry spans and
histograms.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core import stats
from ..device import resolve_device
from ..kernels.paged_attention import cuda_refusal, paged_attention_blocked
from ..models import layers as L
from ..models.model import Model


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
    """Continuous batching over a paged KV pool, causal dense/GQA decoders."""

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
        obs: bool = False,
        mesh=None,
        device="cuda",
    ):
        from ..core.estimation import plan_prefill_chunk
        from .kv_pool import KVPool
        from .prefix_cache import PrefixCache

        for name, asked, item in (
            ("autotune", autotune, "ROADMAP queue A item 7 (autotune)"),
            ("mesh", mesh is not None, "ROADMAP queue A item 11 (mesh)"),
            ("obs", obs, "ROADMAP queue A item 9 (observability)"),
        ):
            if asked:
                raise NotImplementedError(f"{name} is not in the port yet: {item}")
        if spill_pages and not prefix_cache:
            raise ValueError("spill_pages requires prefix_cache=True")
        if cfg.family not in ("dense", "vlm") or cfg.mla or not cfg.causal:
            raise ValueError(
                "PagedServeEngine serves causal dense/GQA decoders;"
                f" got family={cfg.family!r} mla={cfg.mla} causal={cfg.causal}"
            )
        if cfg.sliding_window is not None and cfg.sliding_window < max_len:
            raise ValueError("paged serving keeps the full context; sliding-window"
                             " archs need the slot engine (ROADMAP queue A item 8b)")
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

        logits = self.run_ragged(
            torch.from_numpy(tokens).to(self.device),
            torch.from_numpy(q_lens).to(self.device),
            torch.from_numpy(kv_lens).to(self.device),
            page_table,
        )

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
            if self.greedy:
                nxt = torch.argmax(logits, dim=-1)
            else:
                probs = torch.softmax(logits.float(), dim=-1)
                nxt = torch.multinomial(probs, 1, generator=self.generator)[:, 0]
            nxt = nxt.tolist()
            now = time.perf_counter()
            for row, st, finished_prefill in need_rows:
                st.req.generated.append(int(nxt[row]))
                if finished_prefill:
                    stats.bump("prefill_chunks")
                    self.sched_stats["prefill_chunks"] += 1
                    st.req.first_token_at = now
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
        return out
