"""The port's telemetry (``repro_torch.telemetry``) on the CPU: the
reference's tracer, metrics and export cases (``tests/test_telemetry.py``)
on the port, and the two packages held to each other:

  * the same observations give the same histogram quantiles, bucket
    counts and ``to_dict`` in both packages (exactly: one edge ladder and
    one quantile rule);
  * the same spans give the same ``summarize_spans`` and Chrome trace
    events in both packages (exactly);
  * a trace and a metrics JSONL written by the port pass the reference's
    validators and read back through its readers, and the other way
    round; ``report.render_trace`` / ``render_metrics`` give the same
    text for the same file;
  * the span taxonomy reaches ``engine.kernel`` with ``clock="device"``
    through the port's server and pipeline.

The disabled path is pinned by structure, not by timing: ``span()``
returns ``NULL_SPAN``, ``fence`` is never reached and no CUDA stream is
looked up or synchronized (``torch.cuda`` is patched to raise).
"""
import dataclasses
import json
import threading

import numpy as np
import pytest
import torch

from repro import telemetry as RTEL
from repro.telemetry import report as RREP
from repro_torch import telemetry
from repro_torch.core import geometry as TG
from repro_torch.core.lbvh import build as tree_build
from repro_torch.service import (PipelineConfig, QueryServer, ServiceConfig,
                                 ServingPipeline, knn_request, ray_request,
                                 within_request)
from repro_torch.service.pipeline import REQUEST_PHASES
from repro_torch.telemetry import (MetricsRegistry, Tracer, read_metrics_jsonl,
                                   report, summarize_spans,
                                   validate_chrome_trace,
                                   validate_metrics_lines, write_chrome_trace,
                                   write_metrics_jsonl)
from repro_torch.telemetry import tracer as TT

CPU = "cpu"
DIM = 3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One CPU thread per pytest worker."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _pts(n, seed=0):
    return np.random.default_rng(seed).uniform(
        0, 1, (n, DIM)).astype(np.float32)


@pytest.fixture
def fresh_tracer():
    """Enable telemetry on a fresh ring; restore the disabled default."""
    was = telemetry.enabled()
    tracer = telemetry.enable(capacity=65536)
    yield tracer
    if not was:
        telemetry.disable()
    tracer.drain()


@pytest.fixture
def telemetry_disabled():
    was = telemetry.enabled()
    telemetry.disable()
    yield
    if was:
        telemetry.enable()


@pytest.fixture
def no_cuda_streams(monkeypatch):
    """Any stream lookup or device-wide sync fails the test."""
    def boom(*a, **k):
        raise AssertionError("a CUDA stream was looked up or synchronized")

    monkeypatch.setattr(torch.cuda, "current_stream", boom)
    monkeypatch.setattr(torch.cuda, "synchronize", boom)


def _pipeline(n=300, seed=1, **kw):
    svc = ServiceConfig(capacity=kw.pop("capacity", 8), min_bucket=8,
                        max_bucket=kw.pop("max_bucket", 16))
    pipe = ServingPipeline(config=PipelineConfig(service=svc, **kw),
                           device=CPU)
    if n:
        pipe.create_index("default", TG.Points(torch.from_numpy(_pts(n, seed))))
    return pipe


# ---------------------------------------------------------------------------
# tracer
# ---------------------------------------------------------------------------

def test_ring_buffer_bounds_memory_oldest_spans_fall_off():
    tr = Tracer(capacity=16)
    for i in range(50):
        with tr.span(f"s{i}"):
            pass
    spans = tr.spans()
    assert len(spans) == len(tr) == 16
    assert [s.name for s in spans] == [f"s{i}" for i in range(34, 50)]
    assert tr.drain() == spans and len(tr) == 0


def test_nested_spans_carry_parent_ids():
    tr = Tracer()
    with tr.span("outer", op="knn") as outer:
        with tr.span("inner") as inner:
            pass
        with tr.span("inner2"):
            pass
    by_name = {s.name: s for s in tr.drain()}
    assert by_name["outer"].parent_id == 0
    assert by_name["inner"].parent_id == outer.span_id
    assert by_name["inner2"].parent_id == outer.span_id
    assert by_name["inner"].span_id == inner.span_id != outer.span_id
    assert by_name["outer"].args == {"op": "knn"}


def test_span_stacks_are_per_thread():
    tr = Tracer()

    def worker():
        with tr.span("other"):
            pass

    with tr.span("main-root"):
        th = threading.Thread(target=worker, name="tel-worker")
        th.start()
        th.join(60)
    assert not th.is_alive()
    by_name = {s.name: s for s in tr.drain()}
    assert by_name["other"].parent_id == 0
    assert by_name["other"].tid == "tel-worker"
    assert by_name["main-root"].tid == threading.current_thread().name


def test_exception_exit_still_records_with_error_arg():
    tr = Tracer()
    with pytest.raises(RuntimeError, match="boom"):
        with tr.span("failing", stage=1):
            raise RuntimeError("boom")
    (s,) = tr.drain()
    assert s.name == "failing"
    assert s.args == {"stage": 1, "error": "RuntimeError"}


def test_fence_stamps_device_clock_and_dur_us(no_cuda_streams):
    """CPU tensors are computed already: the fence syncs nothing."""
    tr = Tracer()
    with tr.span("kernel") as sp:
        out = sp.fence(torch.arange(8).sum())
    assert int(out) == 28
    (s,) = tr.drain()
    assert s.clock == "device"
    assert s.dur_ns > 0
    assert sp.dur_us == pytest.approx(s.dur_ns / 1e3)


def test_fence_walks_containers_and_dataclasses():
    x = torch.rand((16, DIM), generator=torch.Generator().manual_seed(0))
    tree = tree_build(TG.Boxes(x, x))
    value = {"a": [tree, (x, 3)], "b": TG.Points(x), "c": None}
    assert TT._cuda_devices(value, set()) == set()
    assert TT._cuda_devices(torch.empty(2, device="meta"), set()) == set()

    @dataclasses.dataclass
    class Box:
        t: object

    tr = Tracer()
    with tr.span("k") as sp:
        assert sp.fence(value) is value
        assert sp.fence(Box(x)).t is x


def test_annotate_merges_args():
    tr = Tracer()
    with tr.span("sp", a=1) as sp:
        sp.annotate(b=2).annotate(a=3)
    (s,) = tr.drain()
    assert s.args == {"a": 3, "b": 2}


def test_add_span_records_retroactive_intervals():
    tr = Tracer()
    root = tr.add_span("request", 1_000, 5_000, tid="requests", kind="knn")
    kid = tr.add_span("request.kernel", 1_000, 2_500, parent_id=root,
                      clock="device")
    neg = tr.add_span("negative", 10, 5)
    a, b, c = tr.drain()
    assert (a.span_id, a.t0_ns, a.dur_ns, a.tid) == (root, 1_000, 4_000,
                                                     "requests")
    assert (b.span_id, b.parent_id, b.clock) == (kid, root, "device")
    assert (c.span_id, c.dur_ns) == (neg, 0)
    assert root != kid != neg


def test_disabled_module_span_is_the_shared_noop(telemetry_disabled,
                                                 no_cuda_streams):
    sp = telemetry.span("anything", a=1)
    with sp:
        pass
    assert sp is telemetry.NULL_SPAN
    assert sp is telemetry.span("something-else")
    assert sp.span_id == 0 and sp.dur_us == 0.0
    obj = object()
    assert sp.fence(obj) is obj
    assert sp.annotate(z=2) is sp
    telemetry.get_tracer().drain()
    with telemetry.span("never-recorded"):
        pass
    assert len(telemetry.get_tracer()) == 0


def test_enable_disable_toggles_and_swaps_rings():
    was = telemetry.enabled()
    try:
        t1 = telemetry.enable(capacity=8)
        assert telemetry.enabled() and telemetry.get_tracer() is t1
        with telemetry.span("live"):
            pass
        assert [s.name for s in t1.drain()] == ["live"]
        t2 = telemetry.enable(capacity=4)
        assert t2 is not t1 and telemetry.get_tracer() is t2
        telemetry.disable()
        assert not telemetry.enabled()
        assert telemetry.get_tracer() is t2
    finally:
        telemetry.disable()
        if was:
            telemetry.enable()


def test_the_port_exports_the_reference_names():
    assert telemetry.__all__ == RTEL.__all__
    for name in RTEL.__all__:
        assert hasattr(telemetry, name), name


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def test_counter_concurrent_adds_do_not_lose_increments():
    c = MetricsRegistry().counter("hits")

    def work():
        for _ in range(1000):
            c.add(1)

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads)
    assert c.value == 8000


def test_gauge_high_water_updates_atomically_with_the_level():
    g = MetricsRegistry().gauge("depth")

    def work():
        for _ in range(1000):
            g.adjust(+1)

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert g.value == 8000 and g.high == 8000


def test_gauge_high_water_survives_drains():
    g = MetricsRegistry().gauge("depth")

    def churn():
        for _ in range(500):
            g.adjust(+1)
            g.adjust(-1)

    threads = [threading.Thread(target=churn) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert g.value == 0
    assert 1 <= g.high <= 8
    g.note_high(3)
    high = g.high
    g.note_high(high - 1)
    assert g.high == high
    assert g.to_dict() == {"type": "gauge", "value": 0, "high": high}


def test_histogram_quantiles_from_log_buckets():
    h = MetricsRegistry().histogram("latency_us")
    vals = list(range(1, 1001))
    for v in vals:
        h.observe(float(v))
    assert h.count == 1000
    assert h.total == pytest.approx(sum(vals))
    assert h.mean == pytest.approx(500.5)
    assert h.quantile(0.5) == pytest.approx(500, rel=0.15)
    assert h.quantile(0.99) == pytest.approx(990, rel=0.15)
    assert h.quantile(0.0) <= h.quantile(0.5) <= h.quantile(1.0)
    with pytest.raises(ValueError, match="outside"):
        h.quantile(1.5)


def test_histogram_underflow_overflow_buckets():
    reg = MetricsRegistry()
    h = reg.histogram("h", lo=1.0, hi=100.0, per_decade=4)
    h.observe(0.01)
    h.observe(1e9)
    assert h.counts[0] == 1 and h.counts[-1] == 1
    assert sum(h.counts) == h.count == 2
    d = h.to_dict()
    assert len(d["buckets"]["counts"]) == len(d["buckets"]["edges"]) + 1
    with pytest.raises(ValueError, match="per_decade"):
        reg.histogram("bad", lo=10.0, hi=1.0)


def test_registry_get_or_create_and_type_collision():
    reg = MetricsRegistry()
    assert reg.counter("x") is reg.counter("x")
    reg.gauge("g")
    with pytest.raises(TypeError, match="already registered"):
        reg.counter("g")
    assert reg.names() == ["g", "x"]
    snap = reg.snapshot()
    assert snap["x"]["type"] == "counter"
    assert snap["g"]["type"] == "gauge"


HISTOGRAM_CASES = [
    ("uniform", {}, lambda r: r.uniform(1, 1e4, 2000)),
    ("lognormal", {}, lambda r: r.lognormal(6, 2, 3000)),
    ("under_over", {"lo": 10.0, "hi": 1e3, "per_decade": 4},
     lambda r: r.uniform(0, 5e3, 500)),
    ("fine", {"lo": 0.5, "hi": 5e5, "per_decade": 16},
     lambda r: r.exponential(300, 1000)),
    ("empty", {}, lambda r: r.uniform(1, 2, 0)),
]


@pytest.mark.parametrize("name,kw,draw", HISTOGRAM_CASES,
                         ids=[c[0] for c in HISTOGRAM_CASES])
def test_histogram_quantiles_equal_the_reference(name, kw, draw):
    vals = draw(np.random.default_rng(len(name)))
    got = MetricsRegistry().histogram("h", **kw)
    want = RTEL.MetricsRegistry().histogram("h", **kw)
    for v in vals:
        got.observe(float(v))
        want.observe(float(v))
    assert got.edges == want.edges and got.counts == want.counts
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 0.999, 1.0):
        assert got.quantile(q) == want.quantile(q), q
    assert got.to_dict() == want.to_dict()


# ---------------------------------------------------------------------------
# exporters
# ---------------------------------------------------------------------------

def _demo_spans():
    tr = Tracer()
    with tr.span("outer", op="knn") as outer:
        with tr.span("inner") as sp:
            sp.fence(torch.zeros(4))
    tr.add_span("retro", outer._t0, outer._t0 + 2_000, parent_id=outer.span_id,
                tid="requests")
    return tr.drain()


def test_chrome_trace_round_trip(tmp_path):
    spans = _demo_spans()
    path = str(tmp_path / "trace.json")
    write_chrome_trace(path, spans, metadata={"suite": "unit"})
    with open(path) as fh:
        obj = json.load(fh)
    assert validate_chrome_trace(obj) == []
    assert obj["otherData"] == {"suite": "unit"}
    xs = [ev for ev in obj["traceEvents"] if ev["ph"] == "X"]
    ms = [ev for ev in obj["traceEvents"] if ev["ph"] == "M"]
    assert len(xs) == 3
    assert min(ev["ts"] for ev in xs) == 0
    by_name = {ev["name"]: ev for ev in xs}
    assert by_name["inner"]["args"]["parent_id"] \
        == by_name["outer"]["args"]["span_id"]
    assert by_name["inner"]["args"]["clock"] == "device"
    assert by_name["outer"]["args"]["op"] == "knn"
    assert {ev["args"]["name"] for ev in ms} \
        == {threading.current_thread().name, "requests"}
    assert {ev["tid"] for ev in ms} == {ev["tid"] for ev in xs}


def test_validate_chrome_trace_rejects_malformed():
    assert validate_chrome_trace([]) != []
    assert validate_chrome_trace({"events": []}) != []
    assert validate_chrome_trace({"traceEvents": {}}) != []
    ok = {"name": "a", "ph": "X", "ts": 0, "dur": 1.0, "pid": 0, "tid": 0}
    assert validate_chrome_trace({"traceEvents": [ok]}) == []
    assert any("ph=" in p for p in
               validate_chrome_trace({"traceEvents": [dict(ok, ph="B")]}))
    assert any("ts=" in p for p in
               validate_chrome_trace({"traceEvents": [dict(ok, ts=-5)]}))
    missing = {"ph": "X", "ts": 0, "dur": 1, "pid": 0}
    problems = validate_chrome_trace({"traceEvents": [missing]})
    assert any("'name'" in p for p in problems)
    assert any("'tid'" in p for p in problems)
    meta = {"name": "thread_name", "ph": "M", "pid": 0, "tid": 0,
            "args": {"name": "x"}}
    assert validate_chrome_trace({"traceEvents": [ok, meta]}) == []


def _demo_registry(M):
    reg = M.MetricsRegistry()
    reg.counter("c").add(3)
    g = reg.gauge("g")
    g.adjust(+2)
    g.adjust(-1)
    h = reg.histogram("h")
    for v in (10.0, 100.0, 1000.0, 0.5, 1e9):
        h.observe(v)
    return reg


def test_metrics_jsonl_round_trip(tmp_path):
    path = str(tmp_path / "metrics.jsonl")
    assert write_metrics_jsonl(path, _demo_registry(telemetry)) == 3
    back = read_metrics_jsonl(path)
    assert validate_metrics_lines(back) == []
    assert back["c"]["value"] == 3
    assert (back["g"]["value"], back["g"]["high"]) == (1, 2)
    assert back["h"]["count"] == 5
    assert sum(back["h"]["buckets"]["counts"]) == 5


def test_validate_metrics_rejects_malformed():
    assert validate_metrics_lines({"x": {"type": "counter"}}) != []
    assert validate_metrics_lines({"x": {"type": "gauge", "value": 1}}) != []
    assert validate_metrics_lines({"x": {"type": "nope"}}) != []
    short = {"type": "histogram", "count": 1,
             "buckets": {"edges": [1.0, 2.0], "counts": [0, 1]}}
    assert any("len(counts)" in p
               for p in validate_metrics_lines({"h": short}))
    drift = {"type": "histogram", "count": 5,
             "buckets": {"edges": [1.0, 2.0], "counts": [0, 1, 1]}}
    assert any("sum" in p for p in validate_metrics_lines({"h": drift}))


def _same_spans(M):
    """One fixed span list in package M (no clocks read)."""
    tr = M.Tracer()
    root = tr.add_span("request", 1_000, 9_500, tid="requests", kind="knn",
                       deadline_missed=True)
    for i, phase in enumerate(("queue", "batch", "kernel")):
        tr.add_span(f"request.{phase}", 1_000 + i * 2_000, 3_000 + i * 2_000,
                    parent_id=root, tid="requests",
                    clock="device" if phase == "kernel" else "wall",
                    deadline_missed=True)
    for d in (1_250, 4_000, 7_777):
        tr.add_span("engine.kernel", 2_000, 2_000 + d, tid="scheduler",
                    clock="device", route="kernel")
    tr.add_span("store.refit", 500, 12_345, tid="maintenance")
    return tr.drain()


def test_summaries_and_trace_events_equal_the_reference():
    got, want = _same_spans(telemetry), _same_spans(RTEL)
    assert summarize_spans(got) == RTEL.summarize_spans(want)
    assert telemetry.chrome_trace_events(got) == \
        RTEL.chrome_trace_events(want)


def test_port_files_pass_the_reference_validators_and_back(tmp_path):
    """Port-written files through the reference's readers and validators,
    reference-written files through the port's; the same report text."""
    for writer, reader, name in ((telemetry, RTEL, "port"),
                                 (RTEL, telemetry, "ref")):
        trace = str(tmp_path / f"{name}.json")
        metrics = str(tmp_path / f"{name}.jsonl")
        writer.write_chrome_trace(trace, _same_spans(writer),
                                  metadata={"by": name})
        writer.write_metrics_jsonl(metrics, _demo_registry(writer))
        with open(trace) as fh:
            obj = json.load(fh)
        assert reader.validate_chrome_trace(obj) == []
        back = reader.read_metrics_jsonl(metrics)
        assert reader.validate_metrics_lines(back) == []
        assert back == writer.read_metrics_jsonl(metrics)
        assert report.render_trace(obj) == RREP.render_trace(obj)
        assert report.render_metrics(back) == RREP.render_metrics(back)
    with open(tmp_path / "port.json") as a, open(tmp_path / "ref.json") as b:
        pa, pb = json.load(a), json.load(b)
    assert pa["traceEvents"] == pb["traceEvents"]


def test_summarize_spans_aggregates_per_name():
    tr = Tracer()
    tr.add_span("a", 0, 2_000)
    tr.add_span("a", 0, 4_000)
    tr.add_span("b", 0, 1_000)
    assert summarize_spans(tr.drain()) == {
        "a": {"count": 2, "total_us": 6.0, "max_us": 4.0},
        "b": {"count": 1, "total_us": 1.0, "max_us": 1.0},
    }


def test_report_selftest_round_trips():
    assert report.selftest() == 0
    assert report.main(["--selftest"]) == 0
    assert report.main([]) == 2
    assert report.main(["/nonexistent/trace.json"]) == 1


# ---------------------------------------------------------------------------
# the serving path's spans
# ---------------------------------------------------------------------------

def test_request_phase_spans_tile_recorded_latency(fresh_tracer):
    with _pipeline(200, seed=70) as pipe:
        tickets = [pipe.submit(knn_request(_pts(2, 71 + i), k=2),
                               deadline_us=1_000.0) for i in range(6)]
        responses = [t.result(60.0) for t in tickets]
    spans = fresh_tracer.drain()
    assert any(r.stats.deadline_missed for r in responses)
    for r in responses:
        st = r.stats
        assert st.span_id > 0
        assert set(st.phase_us) == set(REQUEST_PHASES)
        assert all(v >= 0 for v in st.phase_us.values())
        expect = st.queue_wait_us + st.service_us
        assert sum(st.phase_us.values()) == pytest.approx(expect, rel=1e-6)
        assert st.phase_us["kernel"] == pytest.approx(st.kernel_us)
        (root,) = [s for s in spans if s.span_id == st.span_id]
        assert root.name == "request" and root.tid == "requests"
        assert root.args["deadline_missed"] == st.deadline_missed
        kids = [s for s in spans if s.parent_id == st.span_id]
        assert {s.name for s in kids} \
            == {f"request.{p}" for p in REQUEST_PHASES}
        child_sum_us = sum(s.dur_ns for s in kids) / 1e3
        assert abs(child_sum_us - expect) <= 0.05 * expect
        (kern,) = [s for s in kids if s.name == "request.kernel"]
        assert kern.clock == "device"


def test_serving_span_taxonomy_reaches_the_kernel(fresh_tracer):
    with _pipeline(200, seed=75) as pipe:
        r = pipe.submit(knn_request(_pts(3, 76), k=2),
                        deadline_us=1_000.0).result(60.0)
    assert r.stats.kernel_us > 0
    spans = fresh_tracer.drain()
    names = {s.name for s in spans}
    for expected in ("pipeline.submit", "pipeline.dispatch",
                     "server.execute_group", "server.assemble",
                     "server.scatter", "engine.route", "engine.kernel",
                     "store.build", "request", "request.kernel"):
        assert expected in names, f"missing span {expected!r}"
    kernels = [s for s in spans if s.name == "engine.kernel"]
    assert all(s.clock == "device" for s in kernels)
    assert r.stats.kernel_us == pytest.approx(kernels[-1].dur_ns / 1e3)


def test_server_span_taxonomy_reaches_the_kernel(fresh_tracer):
    srv = QueryServer(config=ServiceConfig(capacity=8), device=CPU)
    srv.create_index("default", TG.Points(torch.from_numpy(_pts(300, 77))))
    q = _pts(5, 78)
    rs = srv.handle([knn_request(q, k=2), within_request(q, 0.1),
                     ray_request(q, np.ones((5, DIM), np.float32))])
    spans = fresh_tracer.drain()
    kernels = [s for s in spans if s.name == "engine.kernel"]
    assert len(kernels) == 3 and all(s.clock == "device" for s in kernels)
    assert {s.args["op"] for s in kernels} == {"knn", "spatial",
                                               "ray_nearest"}
    routes = [s for s in spans if s.name == "engine.route"]
    assert {s.args["route"] for s in routes} == {r.stats.route for r in rs}
    for r in rs:
        assert r.stats.kernel_us > 0


def test_maintenance_spans_cover_refit_and_swap(fresh_tracer):
    with _pipeline(0, 0) as pipe:
        pts = _pts(150, 77)
        pipe.create_index("default", TG.Points(torch.from_numpy(pts)))
        pipe.update_index("default", TG.Points(torch.from_numpy(pts + 0.001)))
        assert pipe.wait_maintenance_idle(60.0)
    spans = fresh_tracer.drain()
    names = {s.name for s in spans}
    for expected in ("pipeline.maintenance", "store.refit", "store.swap"):
        assert expected in names, f"missing span {expected!r}"
    (refit,) = [s for s in spans if s.name == "store.refit"]
    assert refit.clock == "device" and "maintenance" in refit.tid


def test_pipeline_metrics_registry_exports_jsonl(tmp_path):
    with _pipeline(150, seed=78) as pipe:
        pipe.submit(knn_request(_pts(2, 79), k=2),
                    deadline_us=1_000.0).result(60.0)
        reg = pipe.metrics_registry
        path = str(tmp_path / "pipeline.jsonl")
        assert write_metrics_jsonl(path, reg) > 0
    back = read_metrics_jsonl(path)
    assert validate_metrics_lines(back) == []
    assert RTEL.validate_metrics_lines(RTEL.read_metrics_jsonl(path)) == []
    assert back["pipeline.served"]["value"] == 1
    assert back["pipeline.queue_depth"]["high"] >= 1


def test_engine_stats_live_on_the_registry(tmp_path):
    srv = QueryServer(config=ServiceConfig(capacity=8), device=CPU)
    srv.create_index("default", TG.Points(torch.from_numpy(_pts(200, 80))))
    srv.handle([knn_request(_pts(3, 81), k=2)])
    srv.handle([knn_request(_pts(4, 82), k=2)])
    path = str(tmp_path / "engine.jsonl")
    write_metrics_jsonl(path, srv.engine.stats.registry)
    back = read_metrics_jsonl(path)
    assert {k: v["value"] for k, v in back.items()} == {
        "engine.cache_hits": 1, "engine.cache_misses": 1,
        "engine.jit_traces": 1}


def test_queue_depth_high_water_regression(monkeypatch):
    import repro_torch.service.pipeline as PL
    real_execute = PL.execute_group
    in_dispatch, go = threading.Event(), threading.Event()

    def gated_execute(engine, config, entry, group):
        in_dispatch.set()
        assert go.wait(60.0)
        return real_execute(engine, config, entry, group)

    monkeypatch.setattr(PL, "execute_group", gated_execute)
    pipe = _pipeline(150, seed=80)
    try:
        first = pipe.submit(knn_request(_pts(1, 81), k=2),
                            deadline_us=1_000.0)
        assert in_dispatch.wait(60.0)
        backlog = [pipe.submit(knn_request(_pts(1, 82 + i), k=2),
                               deadline_us=10_000_000.0) for i in range(6)]
        st = pipe.stats()
        assert st.queue_depth == 6
        assert st.max_queue_depth >= 6
    finally:
        go.set()
        pipe.close()
    final = pipe.stats()
    assert final.queue_depth == 0
    assert final.max_queue_depth >= 6
    assert first.done() and all(t.done() for t in backlog)


# ---------------------------------------------------------------------------
# the disabled path, by structure
# ---------------------------------------------------------------------------

def test_disabled_serving_never_fences_nor_syncs(telemetry_disabled,
                                                 no_cuda_streams,
                                                 monkeypatch):
    """With telemetry off every span is NULL_SPAN, the real fence is
    never called and no stream is looked up; kernel_us stays 0 and the
    warm cache makes no new entry."""
    def no_fence(self, value):
        raise AssertionError("fence reached with telemetry disabled")

    monkeypatch.setattr(TT._SpanCtx, "fence", no_fence)
    seen = []
    real_span = TT.span

    def spy(name, **args):
        sp = real_span(name, **args)
        seen.append(sp)
        return sp

    monkeypatch.setattr(TT, "span", spy)
    rng = np.random.default_rng(90)
    srv = QueryServer(config=ServiceConfig(capacity=16), device=CPU)
    srv.create_index("default", TG.Points(torch.from_numpy(_pts(500, 90))))
    srv.warmup("default", [("knn", 8), ("within", 0), ("ray", 1)],
               max_bucket=64, dim=DIM)
    before = srv.engine.stats.snapshot()
    for _ in range(10):
        m = [int(rng.integers(1, 65)) for _ in range(3)]
        rs = srv.handle([
            knn_request(rng.uniform(0, 1, (m[0], DIM)), k=8),
            within_request(rng.uniform(0, 1, (m[1], DIM)), 0.1),
            ray_request(rng.uniform(0, 1, (m[2], DIM)),
                        rng.normal(size=(m[2], DIM)))])
        assert all(r.stats.kernel_us == 0.0 and r.stats.cache_hit
                   for r in rs)
    assert seen and all(sp is telemetry.NULL_SPAN for sp in seen)
    assert srv.engine.stats.jit_traces == before.jit_traces


def test_enabling_telemetry_causes_no_new_traces(fresh_tracer):
    srv = QueryServer(config=ServiceConfig(capacity=16), device=CPU)
    srv.create_index("default", TG.Points(torch.from_numpy(_pts(300, 91))))
    telemetry.disable()
    srv.warmup("default", [("knn", 4)], max_bucket=8, dim=DIM)
    telemetry.enable()
    before = srv.engine.stats.snapshot()
    fresh_tracer.drain()
    r = srv.handle([knn_request(_pts(3, 92), k=4)])[0]
    assert r.stats.cache_hit
    assert srv.engine.stats.jit_traces == before.jit_traces
    kernels = [s for s in fresh_tracer.drain() if s.name == "engine.kernel"]
    assert kernels and all(s.clock == "device" for s in kernels)
    assert r.stats.kernel_us == pytest.approx(kernels[-1].dur_ns / 1e3)
