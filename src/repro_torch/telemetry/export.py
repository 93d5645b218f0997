"""Exporters: Chrome ``trace_event`` JSON and a JSONL metrics dump, as
``repro.telemetry.export`` (files either package writes pass the other's
validators).

The Chrome format is the `trace_event` "JSON Object Format": a top-level
``{"traceEvents": [...]}`` where each event is a complete ("ph": "X")
duration with microsecond ``ts``/``dur``. Files written here load
directly in Perfetto (https://ui.perfetto.dev) or chrome://tracing; span
nesting renders as stacked slices per thread track, and the span
id/parent id ride in ``args`` so a flame row can be joined back to the
``RequestStats.span_id`` a deadline-missed response carries.

The metrics dump is one JSON object per line (JSONL): stream-appendable,
greppable, and parsed back by :func:`read_metrics_jsonl`. Both formats
have validators (`validate_chrome_trace` / `validate_metrics_lines`)
used by the ``report --selftest`` round-trip: emit -> write -> parse ->
validate.
"""
from __future__ import annotations

import json

__all__ = ["chrome_trace_events", "write_chrome_trace",
           "validate_chrome_trace", "write_metrics_jsonl",
           "read_metrics_jsonl", "validate_metrics_lines",
           "summarize_spans"]

#: required keys of one Chrome trace event as we emit them
_EVENT_KEYS = ("name", "ph", "ts", "dur", "pid", "tid")


def chrome_trace_events(spans, *, epoch_ns: int | None = None) -> list:
    """Spans -> Chrome trace_event dicts (complete "X" events, ts/dur in
    microseconds relative to the tracer epoch). Thread names become
    numbered tids plus "M"-phase thread_name metadata so Perfetto labels
    the tracks."""
    if epoch_ns is None:
        epoch_ns = min((s.t0_ns for s in spans), default=0)
    tids: dict = {}
    events = []
    for s in spans:
        tid = tids.setdefault(s.tid, len(tids))
        args = {"span_id": s.span_id, "parent_id": s.parent_id,
                "clock": s.clock}
        args.update(s.args)
        events.append({
            "name": s.name, "ph": "X", "cat": s.clock,
            "ts": (s.t0_ns - epoch_ns) / 1e3, "dur": s.dur_ns / 1e3,
            "pid": 0, "tid": tid, "args": args,
        })
    for tname, tid in tids.items():
        events.append({"name": "thread_name", "ph": "M", "pid": 0,
                       "tid": tid, "args": {"name": tname}})
    return events


def write_chrome_trace(path: str, spans, *, metadata: dict | None = None,
                       epoch_ns: int | None = None) -> dict:
    """Write a Perfetto-loadable trace file; returns the written object."""
    obj = {"traceEvents": chrome_trace_events(spans, epoch_ns=epoch_ns),
           "displayTimeUnit": "ms"}
    if metadata:
        obj["otherData"] = metadata
    with open(path, "w") as fh:
        json.dump(obj, fh, indent=1)
    return obj


def validate_chrome_trace(obj) -> list:
    """Schema check; returns a list of problem strings (empty = valid)."""
    problems = []
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        return ["top level must be a dict with a 'traceEvents' list"]
    events = obj["traceEvents"]
    if not isinstance(events, list):
        return ["'traceEvents' is not a list"]
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            problems.append(f"event {i}: not a dict")
            continue
        if ev.get("ph") == "M":
            continue                      # metadata events: name/pid/tid only
        for key in _EVENT_KEYS:
            if key not in ev:
                problems.append(f"event {i}: missing {key!r}")
        if ev.get("ph") not in ("X",):
            problems.append(f"event {i}: ph={ev.get('ph')!r} (expected 'X')")
        for key in ("ts", "dur"):
            v = ev.get(key)
            if not isinstance(v, (int, float)) or v < 0:
                problems.append(f"event {i}: {key}={v!r} not a number >= 0")
    return problems


def write_metrics_jsonl(path: str, registry) -> int:
    """One JSON line per metric from ``registry.snapshot()``; returns the
    number of lines written."""
    snap = registry.snapshot()
    with open(path, "w") as fh:
        for name, payload in snap.items():
            fh.write(json.dumps(dict(payload, name=name), sort_keys=True)
                     + "\n")
    return len(snap)


def read_metrics_jsonl(path: str) -> dict:
    out = {}
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            out[rec["name"]] = rec
    return out


def validate_metrics_lines(metrics: dict) -> list:
    """Schema check for a parsed JSONL dump (empty list = valid)."""
    problems = []
    for name, rec in metrics.items():
        kind = rec.get("type")
        if kind == "counter":
            if not isinstance(rec.get("value"), (int, float)):
                problems.append(f"{name}: counter without numeric value")
        elif kind == "gauge":
            if not all(isinstance(rec.get(k), (int, float))
                       for k in ("value", "high")):
                problems.append(f"{name}: gauge needs numeric value+high")
        elif kind == "histogram":
            b = rec.get("buckets", {})
            edges, counts = b.get("edges"), b.get("counts")
            if not (isinstance(edges, list) and isinstance(counts, list)
                    and len(counts) == len(edges) + 1):
                problems.append(f"{name}: histogram needs len(counts) == "
                                "len(edges) + 1")
            elif sum(counts) != rec.get("count"):
                problems.append(f"{name}: bucket counts do not sum to count")
        else:
            problems.append(f"{name}: unknown metric type {kind!r}")
    return problems


def summarize_spans(spans) -> dict:
    """{span name: {count, total_us, max_us}}: a compact per-name
    summary of a span list."""
    out: dict = {}
    for s in spans:
        rec = out.setdefault(s.name, {"count": 0, "total_us": 0.0,
                                      "max_us": 0.0})
        rec["count"] += 1
        rec["total_us"] += s.dur_ns / 1e3
        rec["max_us"] = max(rec["max_us"], s.dur_ns / 1e3)
    for rec in out.values():
        rec["total_us"] = round(rec["total_us"], 3)
        rec["max_us"] = round(rec["max_us"], 3)
    return out
