"""Predicted-against-measured activation-peak accounting.

AutoChunk's contract is a *bounded activation peak* chosen by the cost
model at search time.  This module closes the loop: after a plan is
compiled (and, on the card, after it runs), the search-time *prediction*
is recorded next to a *measurement* and the relative error becomes a
number of its own (:class:`PlanAccuracy`: ``predicted_bytes`` /
``measured_bytes`` / ``error_pct``).  Records, the error formula and the
published gauges are the JAX package's (``repro.obs.accuracy``).

Two measurement sources:

* ``interpret`` — the exact live-set watermark of the final emitted graph
  (:func:`watermark_graph`), on any device.  The prediction came from the
  search (the selected stage's ``peak_after``), while the watermark walks
  the graph the plan runs after kernel dispatch, so the error is the
  drift between the two, not a tautology.
* ``device`` — the CUDA caching allocator's peak over the plan's own run
  (:func:`with_device_measurement`).  The CPU has none.

The device measurement departs from the JAX package's.  There the
baseline is the allocator's ``bytes_in_use`` when the engine is built and
the measurement its ``peak_bytes_in_use`` whenever the record is read, so
it also counts the engine's own cache (allocated after the baseline) and
any earlier peak of the process.  ``torch.cuda.max_memory_allocated`` is
such a process-wide high-water mark too.  So the port measures what the
prediction counts, the plan's activation peak: the caller takes the
baseline (:func:`device_bytes_in_use`) after the weights and the cache
exist, resets the high-water mark (:func:`reset_device_peak`), runs the
plan once, and reads the peak (:func:`device_peak_bytes`) right after.
The allocator counts allocations as the host issues them, so none of
this waits for the device.

``watermark_graph`` re-implements the liveness walk of
``core.estimation`` instead of importing it: ``repro_torch.obs`` must stay
importable without ``repro_torch.core`` (core.stats imports obs.metrics).
It duck-types the port's ``core.graph.Graph``: the nodes in order,
``node_bytes`` (0 for a view or an in-place op, which allocate nothing,
and for inputs), ``last_use`` (per storage root, so an alias keeps its
root alive), and a chunk loop's ``params["body_peak"]`` (the modeled
per-iteration peak of its body, as the JAX walker takes a
``chunk_loop``'s).  It also supports *state exclusions*: buffer sizes
(e.g. the paged KV pool) that are persistent state rather than
activations.  Nothing here imports ``torch.cuda`` at import time.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, FrozenSet, Optional


# ---------------------------------------------------------------------------
# graph live-set watermark (interpret measurement)
# ---------------------------------------------------------------------------

def _inner_peak(node) -> int:
    """Per-iteration peak of a chunk loop's body (0 for an aten node)."""
    params = getattr(node, "params", None)
    if isinstance(params, dict) and "body_peak" in params:
        return int(params["body_peak"])
    return 0


def _outs(node):
    """Values a graph entry defines: a chunk loop's ``outvars``, else the
    node itself (an FX node is its value)."""
    outvars = getattr(node, "outvars", None)
    return list(outvars) if outvars is not None else [node]


def _walk(g, exclude: FrozenSet[int]) -> int:
    def counted(v) -> int:
        b = g.node_bytes(v)
        return 0 if b in exclude else b

    live = set()
    live_bytes = 0
    peak = 0
    for i, node in enumerate(g.nodes):
        outs = _outs(node)
        peak = max(peak, live_bytes + sum(counted(v) for v in outs) + _inner_peak(node))
        for v in outs:
            b = counted(v)
            if b and g.last_use.get(v, -1) > i and v not in live:
                live.add(v)
                live_bytes += b
        for v in [v for v in live if g.last_use.get(v, -1) <= i]:
            live.remove(v)
            live_bytes -= counted(v)
    return peak


def watermark_graph(g, exclude_nbytes=()) -> int:
    """Peak live *intermediate* bytes of a port graph (inputs, weights
    and aliases count nothing).

    ``exclude_nbytes``: buffer sizes to count as zero — persistent state
    (KV-pool pages) that the activation estimator never modeled.
    """
    return _walk(g, frozenset(int(b) for b in exclude_nbytes))


# ---------------------------------------------------------------------------
# the CUDA caching allocator (the measurement on the card)
# ---------------------------------------------------------------------------

def _cuda_device(device):
    """``device`` as a CUDA ``torch.device``, or None for anything else
    (the CPU, ``meta``, no CUDA build or no card)."""
    try:
        import torch

        d = torch.device(device) if device is not None else None
        if d is None or d.type != "cuda" or not torch.cuda.is_available():
            return None
        return d
    except (RuntimeError, TypeError, ValueError):
        return None


def device_bytes_in_use(device=None) -> Optional[int]:
    """``torch.cuda.memory_allocated`` of a CUDA ``device``, else None.
    Never raises."""
    d = _cuda_device(device)
    if d is None:
        return None
    import torch

    return int(torch.cuda.memory_allocated(d))


def device_peak_bytes(device=None) -> Optional[int]:
    """``torch.cuda.max_memory_allocated`` of a CUDA ``device`` (the
    high-water mark since the last :func:`reset_device_peak`), else None.
    Never raises."""
    d = _cuda_device(device)
    if d is None:
        return None
    import torch

    return int(torch.cuda.max_memory_allocated(d))


def reset_device_peak(device=None) -> bool:
    """Reset a CUDA ``device``'s high-water mark to what is allocated now;
    False (and nothing done) for any other device.  The mark is one per
    process: a caller that reads it across this call reads from here."""
    d = _cuda_device(device)
    if d is None:
        return False
    import torch

    torch.cuda.reset_peak_memory_stats(d)
    return True


# ---------------------------------------------------------------------------
# the accuracy record
# ---------------------------------------------------------------------------

@dataclass
class PlanAccuracy:
    """Per-plan predicted-against-measured activation peak."""

    predicted_bytes: int
    measured_bytes: int
    error_pct: float
    source: str                      # 'device' | 'interpret'
    cache_key: str = ""
    extra: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        d = {
            "predicted_bytes": int(self.predicted_bytes),
            "measured_bytes": int(self.measured_bytes),
            "error_pct": float(self.error_pct),
            "source": self.source,
        }
        if self.cache_key:
            d["cache_key"] = self.cache_key
        d.update(self.extra)
        return d

    def status_line(self) -> str:
        return (
            f"plan_accuracy: predicted_bytes={int(self.predicted_bytes)}"
            f" measured_bytes={int(self.measured_bytes)}"
            f" error_pct={self.error_pct:.2f} source={self.source}"
        )


def compare(predicted_bytes: int, measured_bytes: int, source: str,
            cache_key: str = "", **extra) -> PlanAccuracy:
    """Build a :class:`PlanAccuracy`; error is relative to the measurement
    (``|p - m| / m``), the convention of the paper's §4 peak tables."""
    p = int(predicted_bytes)
    m = int(measured_bytes)
    if m > 0:
        err = abs(p - m) / m * 100.0
    elif p == 0:
        err = 0.0
    else:
        err = math.inf
    return PlanAccuracy(p, m, err, source, cache_key, dict(extra))


def with_device_measurement(acc: PlanAccuracy, baseline_bytes: Optional[int],
                            peak_bytes: Optional[int]) -> PlanAccuracy:
    """Upgrade an interpret record with the allocator's peak over the
    plan's own run: ``peak_bytes`` (:func:`device_peak_bytes` right after
    the run, the mark reset just before it) less ``baseline_bytes``
    (:func:`device_bytes_in_use` just before it).  Returns ``acc``
    unchanged when either is None (the CPU, or no run measured yet) or
    the delta is degenerate; the interpret watermark rides along in
    ``extra`` so both measurements stay visible."""
    if baseline_bytes is None or peak_bytes is None:
        return acc
    measured = int(peak_bytes) - int(baseline_bytes)
    if measured <= 0:
        return acc
    new = compare(acc.predicted_bytes, measured, "device",
                  cache_key=acc.cache_key, **acc.extra)
    new.extra["interpret_measured_bytes"] = acc.measured_bytes
    return new


def publish(acc: PlanAccuracy, registry=None) -> PlanAccuracy:
    """Mirror an accuracy record into the metrics registry (gauges keep
    the latest plan; the counter counts reports)."""
    from . import metrics as _metrics

    reg = registry if registry is not None else _metrics.default_registry()
    reg.gauge("plan_predicted_bytes",
              "search-time predicted activation peak of the latest plan"
              ).set(acc.predicted_bytes)
    reg.gauge("plan_measured_bytes",
              "measured activation peak of the latest plan"
              ).set(acc.measured_bytes)
    reg.gauge("plan_error_pct",
              "relative predicted-vs-measured error of the latest plan"
              ).set(acc.error_pct if math.isfinite(acc.error_pct) else -1.0)
    reg.counter("plan_accuracy_reports",
                "plan accuracy records published").inc()
    return acc
