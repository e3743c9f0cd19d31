"""Injectable clocks for the observability layer.

Everything in ``repro_torch.obs`` times itself through a plain
``Callable[[], float]``, so tests substitute a :class:`ManualClock` and
assert exact timestamps instead of sleeping.

Two real clocks exist on purpose:

* :func:`perf_clock` — ``time.perf_counter``; monotonic, high resolution.
  Used for every *duration* (span timestamps, step latency, TTFT).
* :func:`wall_clock` — ``time.time``; wall time.  Used only where the
  value escapes the process and must mean "when" rather than "how long"
  (plan-cache disk recency is file mtimes).
"""
from __future__ import annotations

import time
from typing import Callable

Clock = Callable[[], float]

perf_clock: Clock = time.perf_counter
wall_clock: Clock = time.time


class ManualClock:
    """Deterministic test clock: starts at ``start``, advances only when
    told.  Instances are callable so they drop in wherever a ``Clock`` is
    accepted."""

    def __init__(self, start: float = 0.0):
        self.now = float(start)

    def __call__(self) -> float:
        return self.now

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"clocks do not run backwards (dt={dt})")
        self.now += dt
        return self.now
