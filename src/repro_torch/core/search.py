"""Chunk search pass (paper section 3.3, Algorithm 1).

Given a Graph and its memory profile, enumerate candidate chunk regions
``[s, e]`` containing the peak node, and for each candidate output dim run
a bottom-up (outputs -> inputs) flow trace with the dimflow rules.  A
region survives when it satisfies the four legality rules:

  1/2. Basic-chunk + output-alignment: every node on the flow has a dimflow
       rule mapping (slice-then-compute == compute-then-slice).
  3.   Flow traceability: at least one region input is reached with an
       assigned chunk dim.
  4.   Unique setting: every value is assigned at most one chunk dim; the
       chunk extent is invariant along the flow.

Nodes the flow cannot pass (``arange``, broken reshapes, earlier chunk
loops...) are hoisted: computed once before the loop, full, and sliced per
chunk where needed; legal only when the hoisted node does not consume a
loop-computed value.  A local window of ``window`` nodes around the peak
bounds the region enumeration, and a cheap prefilter rejects regions before
the full flow trace.  A port of ``repro/core/search.py`` over FX nodes.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

from torch.fx import Node

from . import stats
from .dimflow import FULL, propagate
from .estimation import MemoryProfile
from .graph import Graph, atom_bytes, dim_stride, eqn_flops, is_tensor_value, vshape


@dataclass
class ChunkCandidate:
    """One legal chunk: a region plus a consistent dim assignment."""

    s: int
    e: int
    var_dim: Dict[Node, int]
    in_loop: List[int]
    hoisted: List[int]
    loop_out: List[Node]
    full_out: List[Node]
    sliced_in: List[Tuple[Node, int]]
    full_in: List[Node]
    chunk_extent: int

    # --- features for the selection cost ---------------------------------
    n_nodes: int = 0
    flops: float = 0.0
    density: float = 0.0
    stride_score: float = 0.0  # 1.0 == leading-dim chunk, ->0 minor dims
    body_peak_bytes: int = 0   # per-chunk intermediate bytes at n=1
    static_bytes: int = 0      # full tensors alive while the loop runs
    # set by the kernel-dispatch pass (core.kernel_dispatch) when this
    # candidate's body matches a fused kernel: the body peak the dispatched
    # loop occupies instead of the full chunk-slice intermediates
    kernel_tile_bytes: int = 0

    def divisors(self) -> List[int]:
        """Candidate chunk counts: exact divisors plus powers of two (the
        clamped last chunk handles counts that do not divide the extent)."""
        ext = self.chunk_extent
        small = [d for d in range(1, int(ext ** 0.5) + 1) if ext % d == 0]
        counts = set(small) | {ext // d for d in small}
        p = 2
        while p <= ext:
            counts.add(p)
            p *= 2
        counts.discard(1)
        return sorted(counts)

    def chunked_body_peak(self, n: int) -> int:
        c = -(-self.chunk_extent // n)  # ceil slice extent
        scaled = int(self.body_peak_bytes * c / max(self.chunk_extent, 1))
        if self.kernel_tile_bytes:
            # dispatch-aware cost: the fused kernel never materializes the
            # body's chunk-sized intermediates; charge its own bytes, never
            # more than the generic body estimate
            return min(scaled, self.kernel_tile_bytes)
        return scaled

    def key(self) -> Tuple:
        return (self.s, self.e, tuple(sorted((v.name, d) for v, d in self.var_dim.items())))


def live_into_bytes(g: Graph) -> List[int]:
    """``out[s]`` = bytes of storage allocated before node ``s`` and still
    live at ``s``: one difference-array sweep over (producer, last use)."""
    n = len(g.nodes)
    delta = [0] * (n + 2)
    for v, prod in g.producer.items():
        b = g.node_bytes(v)
        last = g.last_use.get(v, -1)
        if b and last > prod:
            delta[prod + 1] += b
            delta[min(last, n) + 1] -= b
    out = [0] * (n + 1)
    acc = 0
    for s in range(n + 1):
        acc += delta[s]
        out[s] = acc
    return out


def region_io(g: Graph, s: int, e: int) -> Tuple[List[Node], List[Node]]:
    """(inputs, outputs) of the node range [s, e]."""
    produced: Set[Node] = set()
    used: Dict[Node, None] = {}
    for i in range(s, e + 1):
        for iv in g.ins[i]:
            used[iv] = None
        produced.update(g.outs[i])
    inputs = [v for v in used if v not in produced]
    outputs = [v for i in range(s, e + 1) for v in g.outs[i] if g.last_ref.get(v, -1) > e]
    return inputs, outputs


def _analyze(g: Graph, s: int, e: int, seed: Node, seed_dim: int,
             allow_hoist: bool = True, io=None) -> Optional[ChunkCandidate]:
    """Backward flow trace for one (region, seed output dim).  None = illegal.
    ``io`` is the region's :func:`region_io`, when the caller has it."""
    inputs, outputs = io if io is not None else region_io(g, s, e)
    input_set = set(inputs)
    var_dim: Dict[Node, int] = {seed: seed_dim}
    needs_full: Set[Node] = set()
    hoist_needed: Set[int] = set()

    for i in range(e, s - 1, -1):
        node = g.nodes[i]
        assigned = [var_dim[ov] for ov in g.outs[i] if ov in var_dim]
        if not assigned:
            continue  # not on the flow (hoist or dead): classified later
        if len(assigned) > 1:
            hoist_needed.add(i)  # only chunk loops define several values
            continue
        req = propagate(node, assigned[0])
        if req is None:
            hoist_needed.add(i)
            continue
        for inp, d in req.items():
            if d == FULL:
                needs_full.add(inp)
            else:
                prev = var_dim.get(inp)
                if prev is not None and prev != d:
                    return None  # Rule 4 violation
                var_dim[inp] = d

    # ---- classify nodes ------------------------------------------------------
    # "Graph optimization" (paper section 3.3): irrelevant / flow-breaking
    # nodes move out of the loop.  allow_hoist=False is the Table-1 'no graph
    # optimization' ablation: any region needing a hoist is rejected.
    if not allow_hoist and hoist_needed:
        return None
    in_loop: List[int] = []
    hoisted: List[int] = []
    loop_defined: Set[Node] = set()
    for i in range(s, e + 1):
        outs = g.outs[i]
        on_flow = any(ov in var_dim for ov in outs)
        if on_flow and i not in hoist_needed:
            for iv in g.ins[i]:
                if iv not in var_dim and iv in loop_defined:
                    return None  # a whole value that the loop computes
            in_loop.append(i)
            loop_defined.update(outs)
        else:
            if any(iv in loop_defined for iv in g.ins[i]):
                return None  # hoisting would read a loop-computed value
            hoisted.append(i)

    for v in needs_full:
        if v in loop_defined:
            return None
        if v in var_dim:
            # one consumer needs the whole tensor, another a slice of it
            return None
    if not allow_hoist and hoisted:
        return None
    if not in_loop:
        return None

    # ---- region outputs ------------------------------------------------------
    loop_out: List[Node] = []
    full_out: List[Node] = []
    for v in outputs:
        if v in loop_defined:
            if v not in var_dim or not is_tensor_value(v):
                return None  # loop output we cannot reassemble
            loop_out.append(v)
        else:
            full_out.append(v)
    if not loop_out:
        return None

    # ---- loop inputs ---------------------------------------------------------
    sliced_in: List[Tuple[Node, int]] = []
    full_in: List[Node] = []
    seen: Set[Node] = set()
    for i in in_loop:
        for iv in g.ins[i]:
            if iv in loop_defined or iv in seen:
                continue
            seen.add(iv)
            if iv in var_dim:
                sliced_in.append((iv, var_dim[iv]))
            else:
                full_in.append(iv)

    # Rule 3: the flow must reach at least one true region input
    if not any(v in input_set for v, _ in sliced_in):
        return None

    # Rule 4 (extent invariance): every assigned dim shares one extent
    extents = {vshape(v)[d] for v, d in sliced_in}
    extents |= {vshape(v)[var_dim[v]] for v in loop_out}
    if len(extents) != 1:
        return None
    (extent,) = extents
    if extent < 2:
        return None

    cand = ChunkCandidate(s=s, e=e, var_dim=dict(var_dim), in_loop=in_loop,
                          hoisted=hoisted, loop_out=loop_out, full_out=full_out,
                          sliced_in=sliced_in, full_in=full_in, chunk_extent=extent)
    _featurize(g, cand)
    return cand


def _featurize(g: Graph, c: ChunkCandidate) -> None:
    """Fill the cost-model features (paper Eq. 8/9 inputs)."""
    c.n_nodes = len(c.in_loop)
    c.flops = sum(eqn_flops(g.nodes[i]) for i in c.in_loop)
    c.density = c.flops / max(c.n_nodes, 1)

    # stride score in (0, 1]: log-relative stride of the chunk dim vs the
    # leading dim (1.0 = outermost chunk, ->0 = minor-most)
    scores = []
    for v, d in list(c.sliced_in) + [(v, c.var_dim[v]) for v in c.loop_out]:
        shp = vshape(v)
        lead = dim_stride(shp, 0)
        scores.append(math.log1p(dim_stride(shp, d)) / max(math.log1p(lead), 1e-9))
    c.stride_score = sum(scores) / max(len(scores), 1)

    # per-chunk body peak at n=1 (storage that scales with 1/n); a view
    # allocates nothing and keeps its root alive
    root = g.root
    last_local: Dict[Node, int] = {}
    for i in c.in_loop:
        for iv in g.ins[i]:
            last_local[root.get(iv, iv)] = i
    out_roots = {root.get(v, v) for v in c.loop_out}
    live = peak = 0
    live_set: Set[Node] = set()
    for i in c.in_loop:
        for ov in g.outs[i]:
            if ov in c.var_dim and root.get(ov) is ov and ov not in live_set:
                live_set.add(ov)
                live += atom_bytes(ov)
        peak = max(peak, live)
        for v in [v for v in live_set if last_local.get(v, -1) <= i and v not in out_roots]:
            live_set.remove(v)
            live -= atom_bytes(v)
    c.body_peak_bytes = peak

    # full tensors co-resident with the loop
    static = sum(atom_bytes(v) for v, _ in c.sliced_in)
    static += sum(atom_bytes(v) for v in c.full_in if v not in g.weight_invars)
    static += sum(atom_bytes(v) for v in c.loop_out)
    static += sum(atom_bytes(v) for v in c.full_out)
    c.static_bytes = static


def search_chunks(g: Graph, prof: MemoryProfile, *, window: int = 48,
                  max_region_outputs: int = 6, max_candidates: int = 4096,
                  peak_node: Optional[int] = None, allow_hoist: bool = True,
                  dim_blocklist: frozenset = frozenset()) -> List[ChunkCandidate]:
    """Enumerate legal chunks for regions containing the peak node.

    Regions are visited smallest-first, and a prefilter rejects regions
    whose unavoidable full-size tensors (crossing outputs + storage live into
    the region) already reach the current peak.
    """
    stats.bump("search_calls")
    stats.bump("search_passes")
    p = prof.peak_node if peak_node is None else peak_node
    n = len(g.nodes)
    lo = max(0, p - window)
    hi = min(n - 1, p + window)
    live_in = live_into_bytes(g)

    pairs = [(s, e) for s in range(lo, p + 1) for e in range(p, hi + 1) if e - s < window]
    pairs.sort(key=lambda se: (se[1] - se[0], abs(se[0] - p)))

    out: List[ChunkCandidate] = []
    seen: Set[Tuple] = set()
    for s, e in pairs:
        io = region_io(g, s, e)
        outputs = io[1]
        if not outputs or len(outputs) > max_region_outputs:
            continue
        if any(len(vshape(v)) == 0 for v in outputs):
            continue
        floor = live_in[s] + sum(atom_bytes(v) for v in outputs)
        if floor >= prof.peak_bytes:
            continue  # cannot possibly beat the current peak
        # the seed output: produced latest, ties broken by size
        seed = max(outputs, key=lambda v: (g.producer[v], atom_bytes(v)))
        for d, size in enumerate(vshape(seed)):
            if size < 2 or d in dim_blocklist:
                continue
            cand = _analyze(g, s, e, seed, d, allow_hoist=allow_hoist, io=io)
            if cand is None:
                continue
            k = cand.key()
            if k in seen:
                continue
            seen.add(k)
            out.append(cand)
            if len(out) >= max_candidates:
                return out
    return out
