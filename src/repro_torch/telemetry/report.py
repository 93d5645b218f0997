"""Latency-breakdown report CLI, as ``repro.telemetry.report``.

    python -m repro_torch.telemetry.report TRACE_pipeline.json  # Chrome trace
    python -m repro_torch.telemetry.report metrics.jsonl        # metrics dump
    python -m repro_torch.telemetry.report --selftest           # round trip

Given a Chrome trace it renders a per-span-name latency table (count,
total, mean, p50, max) plus — when the trace contains pipeline request
spans — a phase breakdown (queue/batch/dispatch/kernel) split into all
requests vs deadline-missed requests. Given a JSONL metrics dump it
renders each metric with its percentiles.

``--selftest`` is the export round-trip: emit spans + metrics in
process, write both formats to a temp dir, parse them back, validate
the schemas, render the tables, exit 0 only if every step agrees.
"""
from __future__ import annotations

import json
import statistics
import sys
import tempfile

from . import export as _export

#: pipeline phase spans, in request order (see service/pipeline.py)
PHASES = ("request.submit", "request.queue", "request.batch",
          "request.dispatch", "request.kernel")


def _fmt_us(us: float) -> str:
    return f"{us / 1e3:.3f}ms" if us >= 1e3 else f"{us:.1f}us"


def _table(rows, header) -> str:
    rows = [header] + [[str(c) for c in r] for r in rows]
    widths = [max(len(r[i]) for r in rows) for i in range(len(header))]
    lines = []
    for j, r in enumerate(rows):
        lines.append("  ".join(c.ljust(w) if i == 0 else c.rjust(w)
                               for i, (c, w) in enumerate(zip(r, widths))))
        if j == 0:
            lines.append("  ".join("-" * w for w in widths))
    return "\n".join(lines)


def _span_rows(events) -> list:
    by_name: dict = {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        by_name.setdefault(ev["name"], []).append(float(ev["dur"]))
    rows = []
    for name in sorted(by_name):
        durs = sorted(by_name[name])
        rows.append([name, len(durs), _fmt_us(sum(durs)),
                     _fmt_us(sum(durs) / len(durs)),
                     _fmt_us(durs[len(durs) // 2]), _fmt_us(durs[-1])])
    return rows


def _phase_breakdown(events) -> str | None:
    """Per-phase table over request.* spans, all vs deadline-missed."""
    buckets: dict = {p: {"all": [], "missed": []} for p in PHASES}
    seen = False
    for ev in events:
        if ev.get("ph") != "X" or ev["name"] not in buckets:
            continue
        seen = True
        buckets[ev["name"]]["all"].append(float(ev["dur"]))
        if ev.get("args", {}).get("deadline_missed"):
            buckets[ev["name"]]["missed"].append(float(ev["dur"]))
    if not seen:
        return None
    rows = []
    for phase in PHASES:
        a, m = buckets[phase]["all"], buckets[phase]["missed"]
        rows.append([
            phase.split(".", 1)[1], len(a),
            _fmt_us(statistics.median(a)) if a else "-",
            _fmt_us(max(a)) if a else "-", len(m),
            _fmt_us(statistics.median(m)) if m else "-",
            _fmt_us(max(m)) if m else "-",
        ])
    return _table(rows, ["phase", "n", "p50", "max",
                         "missed n", "missed p50", "missed max"])


def render_trace(obj) -> str:
    problems = _export.validate_chrome_trace(obj)
    if problems:
        raise ValueError("invalid Chrome trace: " + "; ".join(problems[:5]))
    events = obj["traceEvents"]
    out = ["spans by name:",
           _table(_span_rows(events),
                  ["span", "count", "total", "mean", "p50", "max"])]
    breakdown = _phase_breakdown(events)
    if breakdown:
        out += ["", "request phase breakdown:", breakdown]
    return "\n".join(out)


def render_metrics(metrics: dict) -> str:
    problems = _export.validate_metrics_lines(metrics)
    if problems:
        raise ValueError("invalid metrics dump: " + "; ".join(problems[:5]))
    rows = []
    for name in sorted(metrics):
        rec = metrics[name]
        kind = rec["type"]
        if kind == "counter":
            rows.append([name, kind, rec["value"], "-", "-", "-"])
        elif kind == "gauge":
            rows.append([name, kind, rec["value"], f"high={rec['high']}",
                         "-", "-"])
        else:
            rows.append([name, kind, rec["count"],
                         _fmt_us(rec["p50"]), _fmt_us(rec["p90"]),
                         _fmt_us(rec["p99"])])
    return _table(rows, ["metric", "type", "n/value", "p50", "p90", "p99"])


def selftest() -> int:
    """Emit -> export -> parse -> validate -> render, both formats."""
    from . import (MetricsRegistry, Tracer, read_metrics_jsonl,
                   write_chrome_trace, write_metrics_jsonl)

    tracer = Tracer(capacity=64)
    with tracer.span("selftest.outer", kind="demo"):
        with tracer.span("request.kernel", deadline_missed=True) as sp:
            sp.annotate(rows=7)
    tracer.add_span("request.queue", 0, 1500, deadline_missed=True)

    reg = MetricsRegistry()
    reg.counter("selftest.requests").add(3)
    reg.gauge("selftest.depth").adjust(+5)
    h = reg.histogram("selftest.latency_us")
    for v in (10.0, 100.0, 1000.0, 1e9):
        h.observe(v)

    with tempfile.TemporaryDirectory() as tmp:
        trace_path, metrics_path = f"{tmp}/trace.json", f"{tmp}/m.jsonl"
        write_chrome_trace(trace_path, tracer.spans(),
                           metadata={"selftest": True})
        write_metrics_jsonl(metrics_path, reg)
        with open(trace_path) as fh:
            trace = json.load(fh)
        metrics = read_metrics_jsonl(metrics_path)
        problems = (_export.validate_chrome_trace(trace)
                    + _export.validate_metrics_lines(metrics))
        if problems:
            print("telemetry selftest FAILED:", file=sys.stderr)
            for p in problems:
                print("  " + p, file=sys.stderr)
            return 1
        render_trace(trace)
        render_metrics(metrics)
    names = {ev["name"] for ev in trace["traceEvents"]}
    if not {"selftest.outer", "request.kernel", "request.queue"} <= names:
        print("telemetry selftest FAILED: spans missing from round-trip",
              file=sys.stderr)
        return 1
    print("telemetry selftest OK: "
          f"{len(trace['traceEvents'])} events, {len(metrics)} metrics "
          "round-tripped")
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv == ["--selftest"]:
        return selftest()
    if len(argv) != 1 or argv[0].startswith("-"):
        print("usage: python -m repro_torch.telemetry.report "
              "<trace.json | metrics.jsonl | --selftest>", file=sys.stderr)
        return 2
    path = argv[0]
    try:
        if path.endswith(".jsonl"):
            print(render_metrics(_export.read_metrics_jsonl(path)))
        else:
            with open(path) as fh:
                print(render_trace(json.load(fh)))
    except (OSError, ValueError, json.JSONDecodeError) as e:
        print(f"report: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
