"""Serving CLI: batched requests through the paged engine.

  python -m repro_torch.launch.serve --arch gpt-paper --paged --stagger \
      --requests 8 --prompt-len 256 --max-len 2048 --max-new 32

runs on the CUDA device by default (``--device cpu`` runs the plain PyTorch
kernels).  ``--local`` serves ``reduced()`` of the config in float32.
``--stagger`` gives request ``i`` a different prompt length, so short and
long requests overlap and steps mix prefill and decode rows; the
``[serve] paged:`` line reports the continuous-batching counters.

The fixed-slot engine (serving without ``--paged``) is not in the port yet.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from ..configs import get_config
from ..core import stats
from ..models import model as M
from ..serving import PagedServeEngine, Request


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
        greedy=not args.sample, seed=args.seed, device=args.device,
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
    print(f"[serve] kv pool: {m['kv_pool']}")
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
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--autochunk", type=float, default=None,
                    help="activation budget of the prefill planner: <= 1.0 is"
                         " a ratio of the unchunked peak, > 1.0 bytes"
                         " (default 0.5)")
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
    args = ap.parse_args(argv)
    if not args.paged:
        sys.exit("the fixed-slot engine is not in the port yet (ROADMAP queue A"
                 " item 8); pass --paged")

    cfg = get_config(args.arch)
    if args.local:
        cfg = cfg.reduced().with_(dtype="float32")
    params = M.init_params(cfg, args.seed, device=args.device)
    rng = np.random.default_rng(args.seed)
    return serve_paged(cfg, params, rng, args)


if __name__ == "__main__":
    main()
