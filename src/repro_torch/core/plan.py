"""Serializable chunk plans.

:class:`ChunkPlan` is everything needed to re-apply a finished compilation
to a fresh trace of the same function: per stage the region ``[s, e]``, the
value -> chunk-dim assignment, chunk extents and counts, and the
hoisted / in-loop partition.  Values are named positionally (``in:i`` /
``const:i`` / ``node:i:j``), which is stable because tracing is
deterministic for a fixed function and fixed input shapes; stage ``i``'s
names resolve against the graph rewritten by stages ``< i``.

The plan cache, structural fingerprints and persistence across processes
wait for ROADMAP queue A item 6; :meth:`ChunkPlan.save` / ``load`` write and
read one plan file.
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

from torch.fx import Node

from .graph import Graph, node_outs, vshape
from .search import ChunkCandidate

PLAN_FORMAT_VERSION = 1


class PlanApplyError(RuntimeError):
    """A saved plan does not fit the graph it is being applied to."""


def var_keys(g: Graph) -> Dict[Node, str]:
    """Stable positional name for every value a plan may reference."""
    keys: Dict[Node, str] = {}
    for i, v in enumerate(g.invars):
        keys[v] = f"in:{i}"
    for i, v in enumerate(g.consts):
        keys.setdefault(v, f"const:{i}")
    for ni, node in enumerate(g.nodes):
        for oi, v in enumerate(node_outs(node)):
            keys.setdefault(v, f"node:{ni}:{oi}")
    return keys


def resolve_var_keys(g: Graph) -> Dict[str, Node]:
    return {k: v for v, k in var_keys(g).items()}


@dataclass
class PlanStage:
    """One applied chunk stage, in terms of the graph it was found on."""

    s: int
    e: int
    n_chunks: int
    chunk_extent: int
    var_dim: Dict[str, int]
    in_loop: List[int]
    hoisted: List[int]
    loop_out: List[str]
    full_out: List[str]
    sliced_in: List[Tuple[str, int]]
    full_in: List[str]
    cost: float = 0.0
    peak_before: int = 0
    peak_after: int = 0

    @classmethod
    def from_candidate(cls, g: Graph, cand: ChunkCandidate, n_chunks: int, *,
                       cost: float = 0.0, peak_before: int = 0,
                       peak_after: int = 0) -> "PlanStage":
        keys = var_keys(g)
        return cls(
            s=cand.s, e=cand.e, n_chunks=int(n_chunks), chunk_extent=cand.chunk_extent,
            var_dim={keys[v]: d for v, d in cand.var_dim.items()},
            in_loop=list(cand.in_loop), hoisted=list(cand.hoisted),
            loop_out=[keys[v] for v in cand.loop_out],
            full_out=[keys[v] for v in cand.full_out],
            sliced_in=[(keys[v], d) for v, d in cand.sliced_in],
            full_in=[keys[v] for v in cand.full_in],
            cost=cost, peak_before=peak_before, peak_after=peak_after)

    def to_candidate(self, g: Graph, *, rescale: bool = False) -> ChunkCandidate:
        """Rebind this stage's positional names to ``g``'s values.

        Raises :class:`PlanApplyError` when a name or index does not
        resolve.  With ``rescale=True`` the stored ``chunk_extent`` may
        disagree with the traced shapes: if every sliced input agrees on
        another extent (the function traced at another length in the same
        shape bucket), the candidate takes the traced extent and keeps the
        chunk count.
        """
        rev = resolve_var_keys(g)

        def lookup(key: str) -> Node:
            v = rev.get(key)
            if v is None:
                raise PlanApplyError(f"plan references unknown value {key!r}")
            return v

        n = len(g.nodes)
        for i in self.in_loop + self.hoisted + [self.s, self.e]:
            if not 0 <= i < n:
                raise PlanApplyError(f"plan node index {i} out of range for {n} nodes")
        cand = ChunkCandidate(
            s=self.s, e=self.e,
            var_dim={lookup(k): d for k, d in self.var_dim.items()},
            in_loop=list(self.in_loop), hoisted=list(self.hoisted),
            loop_out=[lookup(k) for k in self.loop_out],
            full_out=[lookup(k) for k in self.full_out],
            sliced_in=[(lookup(k), d) for k, d in self.sliced_in],
            full_in=[lookup(k) for k in self.full_in],
            chunk_extent=self.chunk_extent)
        for v, d in cand.var_dim.items():
            if d >= len(vshape(v)):
                raise PlanApplyError(f"plan assigns dim {d} to a rank-{len(vshape(v))} value")
        extents = {vshape(v)[d] for v, d in cand.sliced_in}
        if extents and extents != {cand.chunk_extent}:
            if not rescale or len(extents) != 1:
                raise PlanApplyError("plan chunk extent no longer matches the traced shapes"
                                     f" (stored {cand.chunk_extent}, traced {sorted(extents)})")
            cand.chunk_extent = extents.pop()
        return cand


@dataclass
class ChunkPlan:
    """A finished AutoChunk compilation, detached from any live trace."""

    cache_key: str
    budget_bytes: int
    baseline_peak: int
    final_peak: int
    stages: List[PlanStage] = field(default_factory=list)
    meta: Dict[str, Any] = field(default_factory=dict)
    version: int = PLAN_FORMAT_VERSION

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)

    def to_json(self, indent: Optional[int] = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ChunkPlan":
        if d.get("version", 1) != PLAN_FORMAT_VERSION:
            raise PlanApplyError(f"plan format v{d.get('version')} does not match"
                                 f" supported v{PLAN_FORMAT_VERSION}")
        stages = [PlanStage(**{**st, "sliced_in": [tuple(p) for p in st["sliced_in"]]})
                  for st in d.get("stages", [])]
        return cls(cache_key=d["cache_key"], budget_bytes=int(d["budget_bytes"]),
                   baseline_peak=int(d["baseline_peak"]), final_peak=int(d["final_peak"]),
                   stages=stages, meta=dict(d.get("meta", {})),
                   version=int(d.get("version", 1)))

    @classmethod
    def from_json(cls, s: str) -> "ChunkPlan":
        return cls.from_dict(json.loads(s))

    def save(self, path) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(self.to_json())

    @classmethod
    def load(cls, path) -> "ChunkPlan":
        return cls.from_json(Path(path).read_text())
