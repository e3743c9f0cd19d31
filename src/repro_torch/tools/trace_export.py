"""Inspect / re-export Chrome-trace span dumps.

    python -m repro_torch.tools.trace_export serve-trace.json --summary
    python -m repro_torch.tools.trace_export serve-trace.json -o merged.json

Loads one or more trace files produced by ``serve --trace-out`` (or
:meth:`repro_torch.obs.tracing.Tracer.export_chrome`), prints a per-span-name
summary table (count, total/mean/max duration in ms), and can re-emit the
merged events as a single Perfetto-loadable Chrome-trace JSON — handy for
lining up a compile trace and a serving trace from two runs on one
timeline (events keep their ``pid`` so Perfetto shows them as separate
tracks).  A port of ``repro/tools/trace_export.py``: the same summary
lines and the same merged file.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List


def load_events(path: str) -> List[Dict[str, Any]]:
    """Read one trace file; accepts the ``{"traceEvents": [...]}`` object
    form or a bare JSON array of events."""
    with open(path) as f:
        doc = json.load(f)
    events = doc.get("traceEvents") if isinstance(doc, dict) else doc
    if not isinstance(events, list):
        raise ValueError(f"{path}: not a Chrome trace (no event list)")
    return events


def summarize(events: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Aggregate ``"X"`` complete events per name; durations in ms,
    sorted by total time descending."""
    agg: Dict[str, Dict[str, Any]] = {}
    for e in events:
        if e.get("ph") != "X":
            continue
        d = agg.setdefault(
            e["name"], {"name": e["name"], "count": 0,
                        "total_ms": 0.0, "max_ms": 0.0})
        dur_ms = float(e.get("dur", 0.0)) / 1e3
        d["count"] += 1
        d["total_ms"] += dur_ms
        d["max_ms"] = max(d["max_ms"], dur_ms)
    rows = sorted(agg.values(), key=lambda r: -r["total_ms"])
    for r in rows:
        r["mean_ms"] = r["total_ms"] / r["count"]
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="summarize / merge Chrome-trace span dumps")
    ap.add_argument("traces", nargs="+",
                    help="trace JSON files (serve --trace-out output)")
    ap.add_argument("--summary", action="store_true",
                    help="print a per-span-name duration table")
    ap.add_argument("-o", "--out", default=None,
                    help="write the merged events as one Chrome-trace JSON")
    args = ap.parse_args(argv)

    events: List[Dict[str, Any]] = []
    for path in args.traces:
        events.extend(load_events(path))

    n_spans = sum(1 for e in events if e.get("ph") == "X")
    print(f"[trace] {len(args.traces)} file(s), {n_spans} spans")

    if args.summary or not args.out:
        rows = summarize(events)
        if rows:
            w = max(len(r["name"]) for r in rows)
            print(f"{'name':<{w}}  {'count':>6}  {'total_ms':>10}"
                  f"  {'mean_ms':>9}  {'max_ms':>9}")
            for r in rows:
                print(f"{r['name']:<{w}}  {r['count']:>6}"
                      f"  {r['total_ms']:>10.3f}  {r['mean_ms']:>9.3f}"
                      f"  {r['max_ms']:>9.3f}")

    if args.out:
        with open(args.out, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"},
                      f, indent=1)
            f.write("\n")
        print(f"[trace] merged trace -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
