"""Chunk-plan persistence: serializable plans, structural cache keys, PlanCache.

* :class:`ChunkPlan` is everything needed to re-apply a finished compilation
  to a fresh trace of the same function: per stage the region ``[s, e]``,
  the value -> chunk-dim assignment, chunk extents and counts, and the
  hoisted / in-loop partition.  Values are named positionally (``in:i`` /
  ``const:i`` / ``node:i:j``), which is stable because tracing is
  deterministic for a fixed function and fixed input shapes; stage ``i``'s
  names resolve against the graph rewritten by stages ``< i``.
* :func:`plan_cache_key` is a sha256 over the aten graph's structure (op
  overloads, arguments, shapes, dtypes, topology), the budget, the cost
  hypers, the search knobs with the resolved kernel target, and the
  framework tag ``"torch"``.  Devices never enter it: a graph traced on
  ``meta`` (the precompile CLI) and one traced from tensors on the card key
  alike.
* :class:`PlanCache` is an in-memory map over an optional directory (one
  ``<key>.json`` per plan, written atomically; bucket aliases under
  ``buckets/``), shared by ``autochunk(..., cache=...)`` and
  ``python -m repro_torch.tools.precompile``.  A plan file of the JAX
  package is a miss here, never an error, and a port plan file is a miss
  for the JAX package's cache.

A port of ``repro/core/plan.py``.
"""
from __future__ import annotations

import hashlib
import json
import os
import tempfile
import time
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.fx import Node

from . import stats
from .graph import Graph, node_outs, vshape
from .search import ChunkCandidate

# v2: plans carry the framework tag and are rejected without it.
PLAN_FORMAT_VERSION = 2
FRAMEWORK = "torch"


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
    framework: str = FRAMEWORK
    version: int = PLAN_FORMAT_VERSION

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)

    def to_json(self, indent: Optional[int] = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ChunkPlan":
        # any other version or framework (a JAX package plan) is a miss for
        # the caller, which searches and rewrites the entry
        if d.get("framework") != FRAMEWORK:
            raise PlanApplyError(f"plan of framework {d.get('framework')!r}, not"
                                 f" {FRAMEWORK!r}")
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
        _atomic_write(path, self.to_json())

    @classmethod
    def load(cls, path) -> "ChunkPlan":
        return cls.from_json(Path(path).read_text())


# ---------------------------------------------------------------------------
# Structural cache key
# ---------------------------------------------------------------------------

def _canon(obj, ids: Optional[Dict[Node, int]] = None) -> Any:
    """Canonicalize an op argument (or nested value) into JSON-able data.

    Values are named by position (``ids``); devices canonicalize to one
    token, so where a graph was traced never reaches the key."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, Node):
        return ["v", ids.setdefault(obj, len(ids))]
    if isinstance(obj, (tuple, list)):
        return [_canon(x, ids) for x in obj]
    if isinstance(obj, dict):
        return {str(k): _canon(obj[k], ids) for k in sorted(obj, key=str)}
    if isinstance(obj, torch.device):
        return ["device"]
    if isinstance(obj, (torch.dtype, torch.layout, torch.memory_format)):
        return str(obj)
    if isinstance(obj, torch.Tensor):
        return ["tensor", list(obj.shape), str(obj.dtype)]
    if callable(obj):
        return ["fn", getattr(obj, "__qualname__", getattr(obj, "__name__", "?"))]
    return ["repr", repr(obj)]


def _val_sig(val) -> Any:
    """Shape and dtype of a node's value (a tensor or a tuple of them)."""
    if isinstance(val, torch.Tensor):
        return [list(val.shape), str(val.dtype)]
    if isinstance(val, (tuple, list)):
        return [_val_sig(v) for v in val]
    return ["repr", repr(val)] if val is not None else None


def _node_sig(node: Node, ids: Dict[Node, int]) -> Any:
    kwargs = {k: v for k, v in node.kwargs.items() if k != "device"}
    sig = [str(node.target), _canon(list(node.args), ids), _canon(kwargs, ids),
           _val_sig(node.meta.get("val"))]
    ids.setdefault(node, len(ids))
    return sig


def graph_fingerprint(g: Graph) -> str:
    """Deterministic structural hash of a traced (not chunk-rewritten) graph.

    Covers topology (positional value ids), op overloads (``str`` of the
    target) and their arguments, every value's shape and dtype, which inputs
    are weights, and each ``get_attr`` constant's shape and dtype (never its
    value or identity): everything the search and selection passes observe.
    ``device=`` arguments are dropped, so a ``meta`` trace and a fake trace
    on the CPU or the card share the fingerprint.
    """
    ids: Dict[Node, int] = {}
    doc: List[Any] = []
    for v in g.invars:
        doc.append(["in", _val_sig(v.meta.get("val")), v in g.weight_invars])
        ids.setdefault(v, len(ids))
    for v, t in g.consts.items():
        doc.append(["const", list(t.shape), str(t.dtype)])
        ids.setdefault(v, len(ids))
    for node in g.nodes:
        doc.append(_node_sig(node, ids))
    doc.append(["out", [_canon(v, ids) for v in g.outvars]])
    blob = json.dumps(doc, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


def plan_cache_key(g: Graph, budget_bytes: int, hyper=None,
                   knobs: Optional[Dict[str, Any]] = None) -> str:
    """Cache key: graph structure + budget + cost hypers + search knobs (the
    resolved kernel target among them) + the framework tag."""
    doc = {
        "framework": FRAMEWORK,
        "graph": graph_fingerprint(g),
        "budget_bytes": int(budget_bytes),
        "hyper": _canon(asdict(hyper)) if hyper is not None else None,
        "knobs": _canon(dict(knobs or {})),
        "format": PLAN_FORMAT_VERSION,
    }
    blob = json.dumps(doc, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


# ---------------------------------------------------------------------------
# Plan cache
# ---------------------------------------------------------------------------

def _atomic_write(path: Path, text: str) -> None:
    fd, tmp = tempfile.mkstemp(dir=str(path.parent), prefix=path.name, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _touch(p: Optional[Path], now: Optional[float] = None) -> None:
    if p is not None and p.exists():
        try:
            os.utime(p, None if now is None else (now, now))
        except OSError:
            pass


class PlanCache:
    """Two-level plan store: a process-local dict over an optional directory.

    On disk, one ``<cache_key>.json`` per plan, so a cache can be built ahead
    by ``repro_torch.tools.precompile``, shipped with a deployment and shared
    between processes (writes are atomic renames).  Shape-bucket aliases
    (plans keyed by the bucketed input signature, see
    :class:`~repro_torch.core.config.ShapeBucketer`) live in ``buckets/`` and
    are not counted as entries.

    Telemetry (hits, last use, compile cost, buckets, accuracy reports) stays
    in the process; a plan file's mtime is the recency that processes sharing
    the directory see.  ``clock`` supplies timestamps (wall time by default,
    which the mtimes are compared against).
    """

    BUCKET_SUBDIR = "buckets"
    POLICIES = ("lru", "cost_lfu")

    def __init__(self, path: Optional[Any] = None, *, clock: Optional[Any] = None):
        self._mem: Dict[str, ChunkPlan] = {}
        self._mem_buckets: Dict[str, ChunkPlan] = {}
        self.path: Optional[Path] = Path(path) if path is not None else None
        if self.path is not None:
            self.path.mkdir(parents=True, exist_ok=True)
        self.hits = 0
        self.misses = 0
        self.bucket_hits = 0
        self.bucket_misses = 0
        self.evictions = 0
        self._clock = clock if clock is not None else time.time
        self._telemetry: Dict[str, Dict[str, Any]] = {}

    # ------------------------------------------------------------------
    def _disk_path(self, key: str) -> Optional[Path]:
        return None if self.path is None else self.path / f"{key}.json"

    def _bucket_disk_path(self, key: str) -> Optional[Path]:
        return None if self.path is None else self.path / self.BUCKET_SUBDIR / f"{key}.json"

    @staticmethod
    def _load_or_none(p: Optional[Path]) -> Optional[ChunkPlan]:
        if p is None or not p.exists():
            return None
        try:
            return ChunkPlan.load(p)
        except (OSError, ValueError, KeyError, TypeError, PlanApplyError):
            # unreadable, foreign (another version or framework) or
            # wrong-schema file: a miss, which the cold compile rewrites
            return None

    def get(self, key: str) -> Optional[ChunkPlan]:
        plan = self._mem.get(key)
        if plan is None:
            plan = self._load_or_none(self._disk_path(key))
            if plan is not None:
                self._mem[key] = plan
        if plan is None:
            self.misses += 1
        else:
            self.hits += 1
            # the persisted compile cost: a warm process scores the plan by
            # the search it saves, not by its own cheap replay
            self.record_use(key, compile_s=plan.meta.get("compile_s"))
        return plan

    def put(self, key: str, plan: ChunkPlan) -> None:
        self._mem[key] = plan
        p = self._disk_path(key)
        if p is not None:
            plan.save(p)
        self.record_use(key, hit=False, compile_s=plan.meta.get("compile_s"))

    # -- telemetry ------------------------------------------------------
    def _entry(self, key: str, now: float) -> Dict[str, Any]:
        return self._telemetry.setdefault(
            key, {"hits": 0, "last_used": now, "compile_s": 0.0, "buckets": {}})

    def record_use(self, key: str, *, hit: bool = True, compile_s: Optional[float] = None,
                   bucket: Optional[Any] = None, now: Optional[float] = None) -> Dict[str, Any]:
        """Record one use of plan ``key``: hit count, last use, the compile
        cost it saves, the shape bucket that used it.  A disk entry's mtime
        is refreshed as the recency other processes see."""
        now = self._clock() if now is None else now
        m = self._entry(key, now)
        if hit:
            m["hits"] += 1
        m["last_used"] = now
        if compile_s is not None:
            m["compile_s"] = max(m["compile_s"], float(compile_s))
        if bucket is not None:
            b = str(bucket)
            m["buckets"][b] = m["buckets"].get(b, 0) + 1
        _touch(self._disk_path(key), now)
        return m

    def entry_meta(self, key: str) -> Dict[str, Any]:
        """Telemetry record of one plan (empty when never seen)."""
        return dict(self._telemetry.get(key, {}))

    def record_accuracy(self, key: str, accuracy: Any) -> None:
        """Attach a predicted-against-measured peak report (an object with
        ``to_dict`` or a dict) to the plan's telemetry."""
        doc = accuracy.to_dict() if hasattr(accuracy, "to_dict") else dict(accuracy)
        self._entry(key, self._clock())["accuracy"] = doc

    # -- bucket aliases -------------------------------------------------
    def get_bucket(self, key: str) -> Optional[ChunkPlan]:
        """Look up a plan by shape-bucket key (aliases are never entries)."""
        plan = self._mem_buckets.get(key)
        if plan is None:
            plan = self._load_or_none(self._bucket_disk_path(key))
            if plan is not None:
                self._mem_buckets[key] = plan
        if plan is None:
            self.bucket_misses += 1
        else:
            self.bucket_hits += 1
            # a use of the home plan: its recency, and the alias file's
            self.record_use(plan.cache_key or f"alias:{key}",
                            compile_s=plan.meta.get("compile_s"))
            _touch(self._bucket_disk_path(key))
        return plan

    def put_bucket(self, key: str, plan: ChunkPlan) -> None:
        self._mem_buckets[key] = plan
        p = self._bucket_disk_path(key)
        if p is not None:
            plan.save(p)

    def __contains__(self, key: str) -> bool:
        if key in self._mem:
            return True
        p = self._disk_path(key)
        return p is not None and p.exists()

    def __len__(self) -> int:
        return len(self.keys())

    def keys(self) -> List[str]:
        ks = set(self._mem)
        if self.path is not None:
            ks.update(p.stem for p in self.path.glob("*.json"))
        return sorted(ks)

    def _bucket_files(self) -> List[Path]:
        return [] if self.path is None else list(self.path.glob(f"{self.BUCKET_SUBDIR}/*.json"))

    def clear(self, *, disk: bool = False) -> None:
        self._mem.clear()
        self._mem_buckets.clear()
        self._telemetry.clear()
        if disk and self.path is not None:
            for p in list(self.path.glob("*.json")) + self._bucket_files():
                try:
                    p.unlink()
                except OSError:
                    pass

    # -- eviction -------------------------------------------------------
    def _records(self) -> List[Dict[str, Any]]:
        """One record per plan, its bucket aliases attached.

        Every eviction policy counts these: aliases (in memory, or files in
        ``buckets/`` whose ``cache_key`` names the plan) ride with their
        plan and go with it.  An orphaned alias forms its own record.
        """
        recs: Dict[str, Dict[str, Any]] = {}

        def rec(key: str) -> Dict[str, Any]:
            return recs.setdefault(key, {"key": key, "mem_keys": [], "paths": [],
                                         "alias_mem_keys": [], "alias_paths": [],
                                         "mtime": None})

        def mtime(r, p):
            try:
                r["mtime"] = max(r["mtime"] or 0.0, p.stat().st_mtime)
            except OSError:
                pass

        for key in self._mem:                 # insertion order breaks ties
            rec(key)["mem_keys"].append(key)
        if self.path is not None:
            for p in self.path.glob("*.json"):
                r = rec(p.stem)
                r["paths"].append(p)
                mtime(r, p)
        for bkey, plan in self._mem_buckets.items():
            rec(plan.cache_key or f"alias:{bkey}")["alias_mem_keys"].append(bkey)
        for p in self._bucket_files():
            try:
                target = json.loads(p.read_text()).get("cache_key")
            except (OSError, ValueError, AttributeError):
                target = None
            r = rec(target or f"alias:{p.stem}")
            r["alias_paths"].append(p)
            if not r["paths"] and not r["mem_keys"]:
                mtime(r, p)
        return list(recs.values())

    def _recency(self, r: Dict[str, Any], now: float) -> float:
        # a disk record's mtime is the shared signal; a memory-only record
        # falls back to this process's telemetry
        if (r["paths"] or (r["alias_paths"] and not r["mem_keys"])) and r["mtime"] is not None:
            return r["mtime"]
        t = self._telemetry.get(r["key"], {}).get("last_used")
        return t if t is not None else now

    def _remove_record(self, r: Dict[str, Any]) -> None:
        for k in r["mem_keys"]:
            self._mem.pop(k, None)
        for k in r["alias_mem_keys"]:
            self._mem_buckets.pop(k, None)
        for p in r["paths"] + r["alias_paths"]:
            try:
                p.unlink()
            except OSError:
                pass
        self._telemetry.pop(r["key"], None)

    def _compile_cost(self, r: Dict[str, Any]) -> float:
        cost = float(self._telemetry.get(r["key"], {}).get("compile_s", 0.0))
        if cost <= 0.0 and r["paths"]:
            # a disk plan this process never loaded carries its search cost
            try:
                cost = float(json.loads(r["paths"][0].read_text())
                             .get("meta", {}).get("compile_s", 0.0))
            except (OSError, ValueError, TypeError, AttributeError):
                cost = 0.0
        return cost

    def evict(self, *, policy: str = "lru", max_entries: Optional[int] = None,
              max_age_s: Optional[float] = None, now: Optional[float] = None) -> int:
        """Remove plans; returns how many.

        ``max_age_s`` first drops plans not used within that window, then
        ``max_entries`` trims the rest by ``policy``: ``'lru'`` drops the
        least recently used, ``'cost_lfu'`` keeps the highest
        ``(hits + 1) * compile cost`` (recency breaks ties), so a rarely hit
        but costly plan outlives a cheap one of equal traffic.  Counting is
        per plan; bucket aliases go with their plan.
        """
        if policy not in self.POLICIES:
            raise ValueError(f"policy must be one of {self.POLICIES}, got {policy!r}")
        if max_entries is not None and max_entries < 0:
            raise ValueError(f"max_entries must be >= 0, got {max_entries}")
        now = self._clock() if now is None else now
        if max_age_s is None and (max_entries is None or len(self) <= max_entries):
            return 0
        recs = self._records()
        for r in recs:
            r["recency"] = self._recency(r, now)
        drop: List[Dict[str, Any]] = []
        keep: List[Dict[str, Any]] = []
        for r in recs:
            stale = max_age_s is not None and now - r["recency"] > max_age_s
            (drop if stale else keep).append(r)
        if max_entries is not None and len(keep) > max_entries:
            if policy == "lru":
                keep.sort(key=lambda r: r["recency"])
            else:
                def score(r):
                    hits = self._telemetry.get(r["key"], {}).get("hits", 0)
                    return ((hits + 1) * max(self._compile_cost(r), 1e-3), r["recency"])

                keep.sort(key=score)
            drop.extend(keep[:len(keep) - max_entries])
        for r in drop:
            self._remove_record(r)
        self.evictions += len(drop)
        if drop:
            stats.bump("plan_evictions", len(drop))
        return len(drop)

    def prune(self, *, max_entries: Optional[int] = None, max_age_s: Optional[float] = None,
              now: Optional[float] = None) -> int:
        """:meth:`evict` under the LRU policy."""
        return self.evict(policy="lru", max_entries=max_entries, max_age_s=max_age_s, now=now)

    def stats(self) -> Dict[str, int]:
        return {"hits": self.hits, "misses": self.misses, "bucket_hits": self.bucket_hits,
                "bucket_misses": self.bucket_misses, "entries": len(self),
                "evictions": self.evictions}


def as_plan_cache(cache) -> Optional[PlanCache]:
    """Accept a :class:`PlanCache`, a directory path, or None."""
    if cache is None or isinstance(cache, PlanCache):
        return cache
    return PlanCache(cache)
