"""Chunk selection pass (paper section 3.4): cost model + beam ranking.

The paper's two-level cost

    L = L_macro + L_micro
      = alpha*N_node + beta*N_flop  +  gamma*f(N_density) + lam*g(N_stride)

with each term normalized into [0, 1] over the candidate set.  Density and
stride enter inversely: high-compute-density regions tolerate chunking, and
large-stride (outer) dims chunk cheaply; a minor-most chunk dim means
strided slices on any device.  The staged search (``core.staged``) rewrites the
top-beam survivors, re-estimates them, and keeps the best, stage after
stage, until the peak fits the budget.  A port of ``repro/core/selection.py``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

from . import stats
from .estimation import MemoryProfile
from .graph import Graph, atom_bytes, graph_flops, node_outs
from .search import ChunkCandidate, live_into_bytes


@dataclass
class CostHyper:
    alpha: float = 1.5   # macro: number of nodes chunked
    beta: float = 1.0    # macro: flops chunked
    gamma: float = 2.0   # micro: (inverse) compute density
    lam: float = 4.0     # micro: (inverse) chunk-dim stride
    # term switches for the Table-1 ablation
    use_nodes: bool = True
    use_flops: bool = True
    use_density: bool = True
    use_stride: bool = True


def chunk_cost(g: Graph, cand: ChunkCandidate, hyper: CostHyper, *,
               total_flops: float, max_density: float) -> float:
    node_term = cand.n_nodes / max(len(g.nodes), 1)
    flop_term = cand.flops / max(total_flops, 1.0)
    density_term = 1.0 - cand.density / max(max_density, 1.0)
    stride_term = 1.0 - cand.stride_score
    cost = 0.0
    if hyper.use_nodes:
        cost += hyper.alpha * node_term
    if hyper.use_flops:
        cost += hyper.beta * flop_term
    if hyper.use_density:
        cost += hyper.gamma * density_term
    if hyper.use_stride:
        cost += hyper.lam * stride_term
    if cand.kernel_bytes is not None:
        # the body runs as one fused kernel: prefer the kernelizable region
        cost *= 0.5
    return cost


def _selection_env(g: Graph, prof: MemoryProfile):
    """Region-invariant precomputation shared by every candidate: prefix and
    suffix maxima of the per-node profile and the live-into-region sums."""
    per = prof.per_node_bytes
    n = len(per)
    pre = [0] * (n + 1)   # pre[s] = max per[0:s]
    for i in range(n):
        pre[i + 1] = max(pre[i], per[i])
    suf = [0] * (n + 2)   # suf[e] = max per[e:]
    for i in range(n - 1, -1, -1):
        suf[i] = max(suf[i + 1], per[i])
    return pre, suf, live_into_bytes(g)


def _region_terms(g: Graph, prof: MemoryProfile, cand: ChunkCandidate,
                  env=None) -> Tuple[int, int]:
    """(outside_peak, static_region_bytes): the chunk-count-invariant parts
    of the post-chunk estimate for one candidate."""
    if env is None:
        env = _selection_env(g, prof)
    pre, suf, live_in = env
    outside = max(pre[cand.s], suf[cand.e + 1])
    static = live_in[cand.s]
    static += sum(g.node_bytes(ov) for i in cand.hoisted for ov in node_outs(g.nodes[i]))
    static += sum(atom_bytes(v) for v in cand.loop_out)
    static += sum(g.node_bytes(v) for v in cand.full_out)
    return outside, static


def estimate_new_peak(g: Graph, prof: MemoryProfile, cand: ChunkCandidate, n: int, *,
                      _terms=None) -> Tuple[int, int]:
    """Analytic post-chunk (global_peak, region_contribution) for n chunks.

    The global estimate is verified later by re-estimating the rewritten
    graph; the region contribution is what the chunked loop itself occupies
    and must fit the budget on its own (a loop is opaque to later stages).
    """
    outside, static = _terms if _terms is not None else _region_terms(g, prof, cand)
    region = static + cand.chunked_body_peak(n)
    return max(outside, region), region


def choose_n(g: Graph, prof: MemoryProfile, cand: ChunkCandidate, budget_bytes: int, *,
             align: int = 128, margin: float = 0.95, _env=None) -> Tuple[int, int, int]:
    """The smallest chunk count whose region contribution fits
    ``margin * budget``, preferring slice extents that are multiples of (or
    at least) ``align`` rows.  Returns (n, estimated_global_peak, region).
    Falls back to the largest divisor when nothing fits."""
    target = int(budget_bytes * margin)
    terms = _region_terms(g, prof, cand, _env)
    best: Optional[Tuple[int, int, int]] = None
    divisors = cand.divisors()
    for n in divisors:
        est, region = estimate_new_peak(g, prof, cand, n, _terms=terms)
        if region <= target:
            slice_ext = cand.chunk_extent // n
            if slice_ext % align == 0 or slice_ext >= align:
                return n, est, region
            if best is None:
                best = (n, est, region)
    if best is not None:
        return best
    # Nothing fits: the loop's static tensors dominate.  Pick the smallest n
    # whose per-chunk body is negligible next to the static floor.
    _, static = estimate_new_peak(g, prof, cand, max(divisors or [2]), _terms=terms)
    for n in divisors:
        if cand.chunked_body_peak(n) <= max(static // 8, 1):
            est, region = estimate_new_peak(g, prof, cand, n, _terms=terms)
            return n, est, region
    n = divisors[-1] if divisors else 1
    est, region = estimate_new_peak(g, prof, cand, n, _terms=terms)
    return n, est, region


def rank_candidates(g: Graph, prof: MemoryProfile, cands: List[ChunkCandidate],
                    budget_bytes: int, hyper: CostHyper, *, kernel_dispatch: bool = False,
                    mask_mode: str = "auto",
                    target: Optional[str] = None) -> List[Tuple[ChunkCandidate, int, int, float]]:
    """Score every candidate; return [(cand, n, est_peak, cost)] best-first.

    With ``kernel_dispatch=True`` selection is dispatch-aware: candidates
    whose body matches a fused kernel on ``target`` get their kernel bytes
    set, so they are charged the kernel's own bytes instead of the
    chunk-slice intermediates it never materializes.
    """
    stats.bump("rank_calls")
    stats.bump("selection_passes")
    if not cands:
        return []
    if kernel_dispatch:
        from .kernel_dispatch import annotate_candidates

        annotate_candidates(g, cands, mask_mode, target)
    total_flops = graph_flops(g)
    max_density = max(c.density for c in cands)
    env = _selection_env(g, prof)
    scored = []
    for c in cands:
        n, est, region = choose_n(g, prof, c, budget_bytes, _env=env)
        if n < 2:
            continue
        if est > prof.peak_bytes:
            continue  # strictly worse than doing nothing
        cost = chunk_cost(g, c, hyper, total_flops=total_flops, max_density=max_density)
        meets = est <= budget_bytes
        scored.append((c, n, est, region, cost, meets))
    # Budget-constrained ordering (Eq. 11): among candidates that meet the
    # budget, minimize L; when none can, maximize memory progress so later
    # stages can finish the job.
    scored.sort(key=lambda t: (not t[5],) + ((t[4], t[2]) if t[5] else (t[2], t[3], t[4])))
    return [(c, n, est, cost) for c, n, est, region, cost, _ in scored]
