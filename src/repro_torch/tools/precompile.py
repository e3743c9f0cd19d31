"""Build chunk plans ahead of deployment.

Runs the AutoChunk trace and search for a matrix of (config, sequence
length, budget) cells and writes each :class:`~repro_torch.core.plan.ChunkPlan`
into an on-disk :class:`~repro_torch.core.plan.PlanCache` directory.  A
process pointed at the same directory (``autochunk(..., cache=dir)``) then
replays the plans with zero search passes.

Everything is traced on the ``meta`` device: no weights or activations are
materialized, so full-size configs precompile on a small host.  The model
is compiled in its list form (``scan_layers=False``), the form the port's
whole-forward compile takes; tokens are int64.

Lengths map onto their shape-bucket boundaries first (the shapes a
``canonical_bucket_exec`` function executes at), so ``--seq-lens 100,120,500``
builds the two plans the buckets need (128 and 512); ``--exact-lens`` keeps
per-length plans, ``--bucket-lens`` gives explicit boundaries.

A plan is keyed by the kernel target it was searched for.  By default that
is this host's (the card when there is one); ``--kernel-target`` names the
host that will read the plans: ``cuda`` (kernel dispatch on, CUDA kernel
shapes) or ``cpu`` (dispatch off, the default on a host without a card).

    python -m repro_torch.tools.precompile --configs gpt-paper \\
        --seq-lens 64 --budgets 0.4 --cache-dir plans/
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Any, Dict, Optional

import torch

from ..configs import REGISTRY, get_config
from ..core import ChunkConfig, ChunkedFunction, ShapeBucketer
from ..core.plan import PlanCache
from ..models import model as M


def _batch_specs(cfg, batch: int, seq: int) -> Dict[str, Any]:
    """``meta`` input batch of one forward trace."""
    meta = torch.device("meta")
    if cfg.family == "audio":
        return {"frames": torch.empty((batch, seq, cfg.d_model), device=meta)}
    specs = {"tokens": torch.empty((batch, seq), dtype=torch.int64, device=meta)}
    if cfg.family == "vlm":
        specs["patches"] = torch.empty((batch, cfg.n_frontend_tokens, cfg.d_model),
                                       device=meta)
    return specs


def precompile_one(cache: PlanCache, name: str, seq: int, budget: float, *, batch: int = 1,
                   reduced: bool = True, max_stages: int = 12,
                   kernel_target: Optional[str] = None,
                   verbose: bool = False) -> Dict[str, Any]:
    """Build (or find) the plan of one (config, seq, budget) cell."""
    cfg = get_config(name)
    cfg = (cfg.reduced().with_(dtype="float32") if reduced else cfg).with_(scan_layers=False)
    model = M.init_params(cfg, device="meta")
    params = dict(model.named_parameters())
    knobs: Dict[str, Any] = {}
    if kernel_target is not None:
        knobs = dict(kernel_target=kernel_target,
                     kernel_dispatch="on" if kernel_target == "cuda" else "off")
    t0 = time.perf_counter()
    # trace -> search is the whole artifact: the reading process pays the
    # emit (cheap) at start-up, never the search
    cf = ChunkedFunction(M.logits_fn(model),
                         ChunkConfig(budget_ratio=budget, max_stages=max_stages,
                                     verbose=verbose, **knobs),
                         cache=cache)
    planned = cf.trace(params, _batch_specs(cfg, batch, seq)).search()
    return {"config": name, "seq": seq, "budget": budget, "cached": planned.from_cache,
            "stages": len(planned.plan.stages), "baseline_mib": planned.baseline_peak / 2**20,
            "final_mib": planned.final_peak / 2**20, "key": planned.plan.cache_key,
            "target": planned.traced.target, "elapsed_s": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.tools.precompile",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--configs", default="gpt-paper",
                    help="comma-separated config names (or 'all'); known: "
                    + ",".join(sorted(REGISTRY)))
    ap.add_argument("--seq-lens", default="128", help="comma-separated ints")
    ap.add_argument("--budgets", default="0.4", help="comma-separated ratios")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--cache-dir", required=True)
    ap.add_argument("--bucket-lens", default=None,
                    help="comma-separated explicit bucket boundaries; default power-of-two")
    ap.add_argument("--exact-lens", action="store_true",
                    help="precompile at the given lengths, not their bucket boundaries")
    ap.add_argument("--full", action="store_true",
                    help="the full-size config instead of the reduced float32 variant")
    ap.add_argument("--max-stages", type=int, default=ChunkConfig().max_stages,
                    help="ChunkConfig.max_stages of the reading process (part of the key)")
    ap.add_argument("--kernel-target", choices=("cuda", "cpu"), default=None,
                    help="the reading host's kernel target (default: this host's)")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)

    names = sorted(REGISTRY) if args.configs == "all" else [
        n for n in args.configs.split(",") if n]
    seqs = [int(s) for s in args.seq_lens.split(",") if s]
    budgets = [float(b) for b in args.budgets.split(",") if b]
    if not args.exact_lens:
        bucketer = ShapeBucketer(buckets=tuple(int(s) for s in args.bucket_lens.split(",") if s)
                                 if args.bucket_lens else None)
        canonical = list(dict.fromkeys(bucketer.canonical_dim(s) for s in seqs))
        if canonical != seqs:
            print(f"# canonical bucket boundaries: {seqs} -> {canonical}", file=sys.stderr)
        seqs = canonical

    cache = PlanCache(args.cache_dir)
    failures = 0
    print("config,seq,budget,cached,stages,baseline_mib,final_mib,target,elapsed_s")
    for name in names:
        for seq in seqs:
            for budget in budgets:
                try:
                    row = precompile_one(cache, name, seq, budget, batch=args.batch,
                                         reduced=not args.full, max_stages=args.max_stages,
                                         kernel_target=args.kernel_target,
                                         verbose=args.verbose)
                except Exception as e:      # keep going; report at the end
                    failures += 1
                    print(f"# FAILED {name} seq={seq} budget={budget}: {e!r}", file=sys.stderr)
                    continue
                print(f"{row['config']},{row['seq']},{row['budget']},{int(row['cached'])}"
                      f",{row['stages']},{row['baseline_mib']:.2f},{row['final_mib']:.2f}"
                      f",{row['target']},{row['elapsed_s']:.2f}")
    print(f"# cache dir {args.cache_dir}: {len(cache)} plan(s) on disk, {failures} failure(s)",
          file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
