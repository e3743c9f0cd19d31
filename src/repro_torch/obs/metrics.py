"""Typed metrics registry: counters, gauges, fixed-bucket histograms.

``core.stats`` is a compat shim over this registry.  Three metric types,
one process-wide default registry, and two exporters:

* counters — monotonically increasing ints (the pipeline evidence the
  tests assert on);
* gauges — last-write-wins floats (pages in use, cache hit ratio,
  plan-accuracy bytes);
* histograms — fixed bucket boundaries chosen at registration (TTFT,
  queue wait, step latency, decode tok/s).  A value ``v`` lands in the
  first bucket with ``v <= le`` (Prometheus ``le`` semantics).

Exporters: :meth:`MetricsRegistry.to_prometheus` (text exposition,
deterministic ordering) and :meth:`MetricsRegistry.snapshot` (plain dicts,
JSON-ready: what ``serve --metrics-out`` writes).  Names, edges and the
rendering are the JAX package's (``repro.obs.metrics``), so the two
packages' expositions of the same operations are byte-equal.

Every mutation takes the registry lock, so ``stats.bump`` is safe to call
from concurrent threads.  The lock is uncontended in the common case and
all recording happens at step boundaries, never per token.

This module must stay importable without ``repro_torch.core`` (core.stats
imports it; a cycle would break the package).
"""
from __future__ import annotations

import json
import threading
from typing import Dict, List, Optional, Sequence, Tuple, Union

# Default boundaries, in seconds — spans 0.5ms .. 10s, which covers both
# CPU runs of reduced models (slow) and serving on the card (fast).
LATENCY_BUCKETS_S: Tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)
# Tokens/second — decode throughput per step.
THROUGHPUT_BUCKETS: Tuple[float, ...] = (
    1.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
    1000.0, 2500.0, 5000.0, 10000.0,
)


class Counter:
    """Monotonic integer counter."""

    __slots__ = ("name", "help", "_value", "_lock")

    def __init__(self, name: str, help: str, lock: threading.RLock):
        self.name = name
        self.help = help
        self._value = 0
        self._lock = lock

    def inc(self, by: int = 1) -> None:
        if by < 0:
            raise ValueError(f"counter {self.name}: negative inc {by}")
        with self._lock:
            self._value += by

    @property
    def value(self) -> int:
        with self._lock:
            return self._value

    def _reset(self) -> None:
        self._value = 0


class Gauge:
    """Last-write-wins float gauge."""

    __slots__ = ("name", "help", "_value", "_lock")

    def __init__(self, name: str, help: str, lock: threading.RLock):
        self.name = name
        self.help = help
        self._value = 0.0
        self._lock = lock

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def _reset(self) -> None:
        self._value = 0.0


class Histogram:
    """Fixed-boundary histogram.  ``observe(v)`` increments the first
    bucket whose upper edge satisfies ``v <= le`` (an implicit ``+Inf``
    bucket catches the rest), plus running sum and count."""

    __slots__ = ("name", "help", "buckets", "_counts", "_sum", "_count",
                 "_lock")

    def __init__(self, name: str, help: str,
                 buckets: Sequence[float], lock: threading.RLock):
        edges = tuple(float(b) for b in buckets)
        if not edges or any(b <= a for a, b in zip(edges, edges[1:])):
            raise ValueError(
                f"histogram {name}: boundaries must be strictly"
                f" increasing and non-empty, got {edges}"
            )
        self.name = name
        self.help = help
        self.buckets = edges
        self._counts = [0] * (len(edges) + 1)  # last slot = +Inf
        self._sum = 0.0
        self._count = 0
        self._lock = lock

    def observe(self, value: float) -> None:
        v = float(value)
        with self._lock:
            for i, le in enumerate(self.buckets):
                if v <= le:
                    self._counts[i] += 1
                    break
            else:
                self._counts[-1] += 1
            self._sum += v
            self._count += 1

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def bucket_counts(self) -> List[int]:
        """Raw (non-cumulative) per-bucket counts; last entry is +Inf."""
        with self._lock:
            return list(self._counts)

    def cumulative(self) -> List[Tuple[float, int]]:
        """Prometheus-style cumulative ``(le, count)`` pairs incl. +Inf."""
        with self._lock:
            out, acc = [], 0
            for le, c in zip(self.buckets, self._counts):
                acc += c
                out.append((le, acc))
            out.append((float("inf"), acc + self._counts[-1]))
            return out

    def _reset(self) -> None:
        self._counts = [0] * (len(self.buckets) + 1)
        self._sum = 0.0
        self._count = 0


Metric = Union[Counter, Gauge, Histogram]


def _fmt(v: float) -> str:
    """Prometheus float rendering: integral values without the trailing
    ``.0``, everything else via repr-shortest (``%g`` loses precision on
    e.g. 0.0005 -> keep full)."""
    if v == float("inf"):
        return "+Inf"
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


class MetricsRegistry:
    """Process-wide named metric store.  ``counter/gauge/histogram`` are
    get-or-create: repeat registration with the same name returns the
    existing instrument (mismatched type raises)."""

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics: Dict[str, Metric] = {}

    # -- registration ------------------------------------------------------
    def _get_or_create(self, name: str, cls, factory) -> Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls):
                    raise TypeError(
                        f"metric {name!r} already registered as"
                        f" {type(m).__name__}, requested {cls.__name__}"
                    )
                return m
            m = factory()
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(
            name, Counter, lambda: Counter(name, help, self._lock))

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(
            name, Gauge, lambda: Gauge(name, help, self._lock))

    def histogram(self, name: str,
                  buckets: Sequence[float] = LATENCY_BUCKETS_S,
                  help: str = "") -> Histogram:
        return self._get_or_create(
            name, Histogram,
            lambda: Histogram(name, help, buckets, self._lock))

    def get(self, name: str) -> Optional[Metric]:
        with self._lock:
            return self._metrics.get(name)

    # -- snapshots ---------------------------------------------------------
    def counter_values(self) -> Dict[str, int]:
        """Flat ``{name: int}`` over counters only — the shape the old
        ``stats._COUNTERS`` dict had (compat shim's snapshot)."""
        with self._lock:
            return {n: m._value for n, m in self._metrics.items()
                    if isinstance(m, Counter)}

    def snapshot(self) -> Dict[str, dict]:
        """JSON-ready nested snapshot of every registered metric."""
        with self._lock:
            out: Dict[str, dict] = {
                "counters": {}, "gauges": {}, "histograms": {},
            }
            for n, m in sorted(self._metrics.items()):
                if isinstance(m, Counter):
                    out["counters"][n] = m._value
                elif isinstance(m, Gauge):
                    out["gauges"][n] = m._value
                else:
                    out["histograms"][n] = {
                        "buckets": list(m.buckets),
                        "counts": list(m._counts),
                        "sum": m._sum,
                        "count": m._count,
                    }
            return out

    def to_json(self, **extra) -> str:
        snap = self.snapshot()
        snap.update(extra)
        return json.dumps(snap, indent=2, sort_keys=True)

    # -- Prometheus text exposition ---------------------------------------
    def to_prometheus(self) -> str:
        """Text exposition format, metrics sorted by name (deterministic —
        there is a golden test against this exact rendering)."""
        with self._lock:
            lines: List[str] = []
            for n, m in sorted(self._metrics.items()):
                if m.help:
                    lines.append(f"# HELP {n} {m.help}")
                if isinstance(m, Counter):
                    lines.append(f"# TYPE {n} counter")
                    lines.append(f"{n} {m._value}")
                elif isinstance(m, Gauge):
                    lines.append(f"# TYPE {n} gauge")
                    lines.append(f"{n} {_fmt(m._value)}")
                else:
                    lines.append(f"# TYPE {n} histogram")
                    for le, c in m.cumulative():
                        lines.append(f'{n}_bucket{{le="{_fmt(le)}"}} {c}')
                    lines.append(f"{n}_sum {_fmt(m._sum)}")
                    lines.append(f"{n}_count {m._count}")
            return "\n".join(lines) + "\n"

    # -- lifecycle ---------------------------------------------------------
    def reset(self, counters_only: bool = False) -> None:
        """Zero every metric in place (registrations are kept)."""
        with self._lock:
            for m in self._metrics.values():
                if counters_only and not isinstance(m, Counter):
                    continue
                m._reset()


REGISTRY = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    return REGISTRY
