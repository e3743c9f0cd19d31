"""Serving CLI: batched requests through the fixed-slot engine, or the
paged engine with ``--paged``.

  python -m repro_torch.launch.serve --arch gpt-paper --max-batch 4 \
      --requests 8 --prompt-len 256 --max-len 2048 --max-new 32

runs on the CUDA device by default (``--device cpu`` runs the plain PyTorch
kernels).  ``--local`` serves ``reduced()`` of the config in float32.

Without ``--paged``, ``ServeEngine`` serves the requests from
``--max-batch`` slots over ring KV caches (a sliding-window model keeps its
window).  ``--autochunk B`` compiles the decode wave under the activation
budget B at the bucket boundary of ``--max-len`` (``--bucket-lens`` sets
the boundaries, ``--no-canonical-exec`` compiles at ``--max-len`` itself),
with plans in ``--plan-cache DIR`` (evicted by ``--cache-policy`` beyond
``--cache-max-entries``).  ``--second-max-len L`` serves the batch again
after ``reconfigure(max_len=L)``; inside the same bucket the ``[serve]
second run:`` line shows the wave reused (``bucket_exec_hits=1
new_traces=0 new_searches=0 new_wave_compiles=0``).

``--paged`` serves on the paged KV pool.  ``--stagger`` gives request ``i``
a different prompt length, so short and long requests overlap and steps
mix prefill and decode rows; the ``[serve] paged:`` line reports the
continuous-batching counters.  ``--prefix-cache`` turns on the
prefix-sharing radix cache and ``--spill-pages N`` its host spill tier of N
pages.  ``--shared-prefix L`` serves the shared-system-prompt scenario:
every request's prompt starts with the same L tokens, requests drain one by
one, and every third one is an uncached filler (``cache_prefix=False``)
whose admission presses the pool, so cached pages spill and the next shared
request restores them.  The ``[serve] prefix:`` line reports the cache's
counters.

``--metrics-out FILE`` dumps the metrics registry (counters, gauges,
TTFT / step-latency histograms) plus the ``plan_accuracy`` block
(predicted against measured activation peak) as JSON; ``--trace-out FILE``
exports every compile and serving span as Chrome-trace JSON (Perfetto,
``chrome://tracing``, ``python -m repro_torch.tools.trace_export``);
``--prom-out FILE`` writes the Prometheus text exposition.  ``--no-obs``
turns engine recording and the tracer off.  Both paths print the
``[serve] plan_accuracy: ...`` line when the engine has a plan.

``--autotune`` and ``--mesh`` are refused with their ROADMAP items (queue
A items 7 and 11).
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from ..configs import get_config
from ..core import stats
from ..models import model as M
from ..core.plan import PlanCache
from ..obs import metrics as obs_metrics
from ..obs.tracing import TRACER
from ..serving import PagedServeEngine, Request, ServeEngine


def write_obs_outputs(args, engine) -> None:
    """Print the plan-accuracy status line and write ``--metrics-out`` /
    ``--trace-out`` / ``--prom-out``.  Shared by the slot and paged paths;
    all exports happen after serving, off the hot path."""
    acc = engine.plan_accuracy()
    if acc is not None:
        print(f"[serve] {acc.status_line()}")
    if args.metrics_out:
        doc = {"counters": stats.snapshot(),
               "metrics": obs_metrics.default_registry().snapshot()}
        if acc is not None:
            doc["plan_accuracy"] = acc.to_dict()
        with open(args.metrics_out, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"[serve] metrics snapshot -> {args.metrics_out}")
    if args.prom_out:
        with open(args.prom_out, "w") as f:
            f.write(obs_metrics.default_registry().to_prometheus())
        print(f"[serve] prometheus exposition -> {args.prom_out}")
    if args.trace_out:
        TRACER.export_chrome(args.trace_out)
        print(f"[serve] chrome trace ({len(TRACER.spans())} spans) -> {args.trace_out}")


def serve_paged(cfg, params, rng, args):
    """Drive the paged continuous-batching engine (``--paged``)."""
    chunk = "auto" if args.prefill_chunk == "auto" else int(args.prefill_chunk)
    before = stats.snapshot()
    t0 = time.perf_counter()
    engine = PagedServeEngine(
        cfg, params,
        max_seqs=args.max_seqs, max_len=args.max_len,
        page_size=args.page_size, num_pages=args.num_pages,
        autochunk_budget=args.autochunk, prefill_chunk=chunk,
        prefix_cache=args.prefix_cache, spill_pages=args.spill_pages,
        greedy=not args.sample, seed=args.seed, obs=not args.no_obs, device=args.device,
    )
    plan = engine.prefill_plan
    plan_note = (
        f" (planned: budget {plan.budget_bytes/2**20:.2f} MiB ->"
        f" peak {plan.peak_bytes/2**20:.2f} MiB)" if plan else " (fixed)"
    )
    print(f"[serve] paged engine built in {time.perf_counter()-t0:.2f}s;"
          f" pool {engine.pool.num_pages} pages x {engine.page_size} tokens,"
          f" prefill_chunk={engine.prefill_chunk}{plan_note}")

    t0 = time.perf_counter()
    if args.shared_prefix > 0:
        # the shared-system-prompt scenario, drained one request at a time
        # so each sees the cache insert of the one before; every third
        # request is an uncached filler that presses the pool
        n_shared = min(args.shared_prefix, args.prompt_len)
        shared = rng.integers(0, cfg.vocab_size, n_shared).tolist()
        lens = [args.prompt_len] * args.requests
        for i in range(args.requests):
            if i % 3 == 2:
                prompt = rng.integers(0, cfg.vocab_size, args.prompt_len).tolist()
                req = Request(rid=i, prompt=prompt, max_new_tokens=args.max_new,
                              cache_prefix=False)
            else:
                tail = rng.integers(0, cfg.vocab_size, args.prompt_len - n_shared).tolist()
                req = Request(rid=i, prompt=shared + tail, max_new_tokens=args.max_new)
            engine.submit(req)
            engine.run()
        done = engine.finished
    else:
        # staggered-length prompts: short decode-bound requests overlap with
        # long prefill-bound ones, which is what forces mixed steps
        if args.stagger:
            cap = max(1, args.max_len - args.max_new)
            lens = [max(1, min(cap, args.prompt_len * (1 + 3 * (i % 3)) // 2))
                    for i in range(args.requests)]
        else:
            lens = [args.prompt_len] * args.requests
        for i, n in enumerate(lens):
            prompt = rng.integers(0, cfg.vocab_size, n).tolist()
            engine.submit(Request(rid=i, prompt=prompt, max_new_tokens=args.max_new))
        done = engine.run()
    dt = time.perf_counter() - t0
    toks = sum(len(r.generated) for r in done)
    m = engine.metrics()
    d = stats.delta(before)
    print(f"[serve] {len(done)} requests (lens {min(lens)}..{max(lens)}),"
          f" {toks} tokens in {dt:.2f}s ({toks/dt:.1f} tok/s,"
          f" {engine.sched_stats['steps']} steps)")
    print(
        "[serve] paged:"
        f" mixed_steps={d['mixed_steps']}"
        f" prefill_chunks={d['prefill_chunks']}"
        f" pages_allocated={d['pages_allocated']}"
        f" pages_freed={d['pages_freed']}"
        f" peak_pages={engine.pool.peak_pages_in_use}"
        f" admission_refusals={d['admission_refusals']}"
        f" padded_kv_waste_bytes={m['kv_pool']['padded_kv_waste_bytes']}"
    )
    if engine.prefix_cache is not None:
        pc = m["prefix_cache"]
        print(
            "[serve] prefix:"
            f" prefix_hits={d['prefix_hits']}"
            f" prefix_tokens_reused={d['prefix_tokens_reused']}"
            f" cow_copies={d['cow_copies']}"
            f" pages_spilled={d['pages_spilled']}"
            f" pages_restored={d['pages_restored']}"
            f" cached_nodes={pc['nodes']}"
            f" resident_pages={pc['resident_pages']}"
            f" spilled_nodes={pc['spilled_nodes']}"
        )
    print(f"[serve] kv pool: {m['kv_pool']}")
    write_obs_outputs(args, engine)
    for r in done[:3]:
        print(f"  req {r.rid}: {r.generated[:8]}...")
    return engine


def serve_slots(cfg, params, rng, args):
    """Drive the fixed-slot engine (the default)."""
    bucket_lens = ([int(s) for s in args.bucket_lens.split(",") if s]
                   if args.bucket_lens else None)
    t0 = time.perf_counter()
    engine = ServeEngine(
        cfg, params,
        max_batch=args.max_batch, max_len=args.max_len,
        autochunk_budget=args.autochunk, plan_cache=args.plan_cache,
        bucket_lens=bucket_lens, canonical_bucket_exec=not args.no_canonical_exec,
        cache_policy=args.cache_policy, cache_max_entries=args.cache_max_entries,
        greedy=not args.sample, seed=args.seed, obs=not args.no_obs, device=args.device,
    )
    t_build = time.perf_counter() - t0
    if args.autochunk is not None:
        res = engine.autochunk_result
        state = "warm" if res.from_cache else "cold"
        print(f"[serve] engine built in {t_build:.2f}s; plan cache: {state}"
              f" (stages={len(res.plan)}, exec_len={engine.exec_len},"
              f" peak {res.baseline_peak/2**20:.1f} -> {res.final_peak/2**20:.1f} MiB)")

    def serve_batch(tag: str):
        t0 = time.perf_counter()
        n0 = len(engine.finished)
        for i in range(args.requests):
            prompt = rng.integers(0, cfg.vocab_size, args.prompt_len).tolist()
            engine.submit(Request(rid=i, prompt=prompt, max_new_tokens=args.max_new))
        done = engine.run()[n0:]
        dt = time.perf_counter() - t0
        toks = sum(len(r.generated) for r in done)
        print(f"[serve]{tag} {len(done)} requests, {toks} tokens in {dt:.2f}s"
              f" ({toks/dt:.1f} tok/s, {engine.n_decode_steps} decode waves)")
        return done

    done = serve_batch("")
    if args.second_max_len is not None:
        before = stats.snapshot()
        compiles = engine.exec_stats["wave_compiles"]
        engine.reconfigure(max_len=args.second_max_len)
        serve_batch(f" second run @ max_len={args.second_max_len}:")
        d = stats.delta(before)
        print("[serve] second run:"
              f" bucket_exec_hits={d['bucket_exec_hits']}"
              f" new_traces={d['trace_calls']}"
              f" new_searches={d['search_passes']}"
              f" new_wave_compiles={engine.exec_stats['wave_compiles'] - compiles}")
    if engine.plan_cache is not None:
        print(f"[serve] plan cache stats: {engine.plan_cache.stats()}")
        if args.cache_max_entries is not None:
            print(f"[serve] cache eviction: policy={args.cache_policy}"
                  f" max_entries={args.cache_max_entries}"
                  f" evicted={engine.exec_stats['evicted']}")
    snap = stats.snapshot()
    print("[serve] codegen stats:"
          f" lowering_emits={snap['lowering_emits']}"
          f" trace_calls={snap['trace_calls']}"
          f" kernel_dispatch_hits={snap['kernel_dispatch_hits']}"
          f" kernel_dispatch_misses={snap['kernel_dispatch_misses']}")
    write_obs_outputs(args, engine)
    for r in done[:3]:
        print(f"  req {r.rid}: {r.generated[:8]}...")
    return engine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--local", action="store_true",
                    help="serve reduced() of the config in float32")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain PyTorch kernels")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4,
                    help="slots of the fixed-slot engine")
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--autochunk", type=float, default=None,
                    help="activation budget (<= 1.0 a ratio of the unchunked"
                         " peak, > 1.0 bytes): the decode wave's, or with"
                         " --paged the prefill planner's (default 0.5)")
    ap.add_argument("--autotune", action="store_true",
                    help="refused: the kernel autotuner is ROADMAP queue A item 7")
    ap.add_argument("--plan-cache", type=str, default=None,
                    help="on-disk plan cache directory (shared across runs)")
    ap.add_argument("--bucket-lens", type=str, default=None,
                    help="comma-separated seq-len bucket boundaries for plan"
                         " reuse across max-len reconfigurations")
    ap.add_argument("--second-max-len", type=int, default=None,
                    help="serve the batch again after reconfiguring to this"
                         " max-len; inside the same bucket this reuses the"
                         " bucket's wave (0 traces, 0 compiles)")
    ap.add_argument("--no-canonical-exec", action="store_true",
                    help="compile per exact max-len instead of at the bucket"
                         " boundary")
    ap.add_argument("--cache-policy", choices=list(PlanCache.POLICIES), default="lru",
                    help="plan-cache eviction policy (see PlanCache.evict)")
    ap.add_argument("--cache-max-entries", type=int, default=None,
                    help="evict plans beyond this count at engine idle points")
    ap.add_argument("--mesh", type=str, default=None,
                    help="refused: device meshes are ROADMAP queue A item 11")
    ap.add_argument("--metrics-out", type=str, default=None,
                    help="write a JSON metrics snapshot (counters, gauges,"
                         " TTFT/latency histograms, plan_accuracy block)"
                         " after serving")
    ap.add_argument("--trace-out", type=str, default=None,
                    help="write compile+serve spans as Chrome-trace JSON"
                         " (Perfetto / chrome://tracing loadable)")
    ap.add_argument("--prom-out", type=str, default=None,
                    help="write the Prometheus text exposition of the"
                         " metrics registry")
    ap.add_argument("--no-obs", action="store_true",
                    help="turn engine metric/span recording and the tracer off")
    ap.add_argument("--sample", action="store_true",
                    help="sample from the logits instead of greedy argmax")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--paged", action="store_true",
                    help="serve on the paged KV pool (continuous batching,"
                         " mixed prefill+decode steps, admission bounded by"
                         " pages)")
    ap.add_argument("--page-size", type=int, default=16,
                    help="KV tokens per pool page")
    ap.add_argument("--num-pages", type=int, default=None,
                    help="pool capacity in pages (default: max_seqs *"
                         " pages(max_len))")
    ap.add_argument("--max-seqs", type=int, default=4,
                    help="step-batch rows for the paged engine")
    ap.add_argument("--prefill-chunk", type=str, default="auto",
                    help="'auto' = plan the chunk from the activation budget"
                         " via the AutoChunk estimator, or an integer")
    ap.add_argument("--stagger", action="store_true",
                    help="staggered prompt lengths (request i gets a varied"
                         " length) so prefill and decode overlap")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="enable the prefix-sharing radix cache: matched prompt"
                         " prefixes share ref-counted pool pages and skip prefill")
    ap.add_argument("--spill-pages", type=int, default=0,
                    help="host spill arena capacity in pages; >0 turns"
                         " out-of-pages admission into retry-after-spill")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="serve the shared-system-prompt scenario with a prefix"
                         " of this many tokens (requests drain one by one;"
                         " every third is an uncached filler)")
    args = ap.parse_args(argv)
    for asked, item in ((args.autotune, "--autotune: ROADMAP queue A item 7 (autotune)"),
                        (args.mesh, "--mesh: ROADMAP queue A item 11 (mesh)")):
        if asked:
            sys.exit(f"not in the port yet: {item}")
    if args.no_obs:
        TRACER.enabled = False

    cfg = get_config(args.arch)
    if args.local:
        cfg = cfg.reduced().with_(dtype="float32")
    params = M.init_params(cfg, args.seed, device=args.device)
    rng = np.random.default_rng(args.seed)
    if args.paged:
        return serve_paged(cfg, params, rng, args)
    return serve_slots(cfg, params, rng, args)


if __name__ == "__main__":
    main()
