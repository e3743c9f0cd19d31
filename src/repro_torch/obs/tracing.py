"""Low-overhead tracing spans with Chrome-trace/Perfetto export.

Usage::

    from repro_torch.obs import tracing

    with tracing.span("compile.search", stages=3):
        ...

    @tracing.traced("serve.admit")
    def _admit(self): ...

Spans nest through a per-thread stack; each completed span records
``(name, start, end, depth, parent, args)`` into a bounded ring buffer on
the process-wide :data:`TRACER`.  Recording is append-only under a lock —
no I/O, no device syncs — and a disabled tracer short-circuits to a
no-op, so instrumented hot paths pay one attribute read when tracing is
off.

Spans are host-side only: a span reads the host clock at its two ends and
nothing else.  CUDA launches are asynchronous, so a span around a kernel
launch (``serve.decode_wave``, ``serve.prefill_chunk``) measures the time
the host took to enqueue the work, not the device's time.  The host waits
for the card where it reads a result: the serving step's sampling
(``.tolist()`` of the sampled tokens), so a ``serve.step`` span ends after
the step's device work, and the part of it outside the enqueue spans is
mostly that wait.  No span synchronizes the device to look like device
time; device time comes from ``torch.profiler`` or CUDA events.

:meth:`Tracer.to_chrome` renders the buffer as Chrome-trace JSON
(``"X"`` complete events, microsecond timestamps), which Perfetto and
``chrome://tracing`` load directly; ``tools/trace_export`` and
``serve --trace-out`` wrap it.  Span names, the event layout and the
process name are the JAX package's (``repro.obs.tracing``).

The clock is injectable (see ``obs.clock``) so ordering/nesting tests run
on a :class:`~repro_torch.obs.clock.ManualClock` instead of sleeping.
"""
from __future__ import annotations

import json
import os
import threading
from collections import deque
from contextlib import contextmanager
from functools import wraps
from typing import Any, Dict, List, Optional

from .clock import Clock, perf_clock


class Span:
    __slots__ = ("name", "start", "end", "depth", "parent", "tid", "args")

    def __init__(self, name: str, start: float, end: float, depth: int,
                 parent: Optional[str], tid: int,
                 args: Optional[Dict[str, Any]]):
        self.name = name
        self.start = start
        self.end = end
        self.depth = depth
        self.parent = parent
        self.tid = tid
        self.args = args or {}

    @property
    def duration(self) -> float:
        return self.end - self.start

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name, "start": self.start, "end": self.end,
            "depth": self.depth, "parent": self.parent, "tid": self.tid,
            "args": self.args,
        }


class _OpenSpan:
    __slots__ = ("name", "start", "depth", "parent", "args")

    def __init__(self, name, start, depth, parent, args):
        self.name = name
        self.start = start
        self.depth = depth
        self.parent = parent
        self.args = args


class Tracer:
    """Bounded in-process span recorder."""

    def __init__(self, clock: Optional[Clock] = None,
                 max_spans: int = 200_000):
        self._clock: Clock = clock or perf_clock
        self._spans: deque = deque(maxlen=max_spans)
        self._local = threading.local()
        self._lock = threading.Lock()
        self.enabled = True
        self._origin = self._clock()

    # -- clock -------------------------------------------------------------
    def set_clock(self, clock: Clock) -> None:
        """Swap the timestamp source (tests: a ManualClock).  Resets the
        trace origin so exported ``ts`` values start near zero."""
        self._clock = clock
        self._origin = clock()

    # -- recording ---------------------------------------------------------
    def _stack(self) -> List[_OpenSpan]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    @contextmanager
    def span(self, name: str, **args):
        if not self.enabled:
            yield None
            return
        stack = self._stack()
        parent = stack[-1].name if stack else None
        open_span = _OpenSpan(name, self._clock(), len(stack), parent,
                              args or None)
        stack.append(open_span)
        try:
            yield open_span
        finally:
            stack.pop()
            self._record(open_span, self._clock())

    def _record(self, open_span: _OpenSpan, end: float) -> None:
        sp = Span(open_span.name, open_span.start, end, open_span.depth,
                  open_span.parent, threading.get_ident(), open_span.args)
        with self._lock:
            self._spans.append(sp)

    def instant(self, name: str, **args) -> None:
        """Zero-duration marker event."""
        if not self.enabled:
            return
        now = self._clock()
        stack = self._stack()
        parent = stack[-1].name if stack else None
        self._record(_OpenSpan(name, now, len(stack), parent,
                               args or None), now)

    # -- inspection / export ----------------------------------------------
    def spans(self, name: Optional[str] = None) -> List[Span]:
        with self._lock:
            out = list(self._spans)
        if name is not None:
            out = [s for s in out if s.name == name]
        return sorted(out, key=lambda s: (s.start, s.depth))

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
        self._origin = self._clock()

    def to_chrome(self) -> Dict[str, Any]:
        """Chrome-trace JSON object (Perfetto/chrome://tracing loadable):
        one ``"X"`` complete event per span, µs timestamps relative to the
        tracer origin."""
        pid = os.getpid()
        events: List[Dict[str, Any]] = [{
            "ph": "M", "pid": pid, "name": "process_name",
            "args": {"name": "autochunk"},
        }]
        for s in self.spans():
            events.append({
                "ph": "X",
                "name": s.name,
                "cat": s.name.split(".", 1)[0],
                "ts": (s.start - self._origin) * 1e6,
                "dur": max(s.duration, 0.0) * 1e6,
                "pid": pid,
                "tid": s.tid,
                "args": s.args,
            })
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def export_chrome(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f, indent=1)
            f.write("\n")


TRACER = Tracer()


def span(name: str, **args):
    """Context manager recording a span on the default tracer."""
    return TRACER.span(name, **args)


def traced(name: Optional[str] = None):
    """Decorator form of :func:`span`; defaults to the function name."""

    def deco(fn):
        span_name = name or fn.__name__

        @wraps(fn)
        def wrapper(*a, **kw):
            with TRACER.span(span_name):
                return fn(*a, **kw)

        return wrapper

    return deco


def set_enabled(on: bool) -> None:
    TRACER.enabled = bool(on)
