"""The port's async deadline-aware ``ServingPipeline`` on the CPU: the
reference's cases (``tests/test_pipeline.py``) on the port, with results
held against the port's direct ``BVH.query`` (bit for bit) and against
the reference pipeline's results for the same submitted requests
(within-radius counts equal; kNN distances within 1e-6 and indices equal
away from ties; ray t and indices equal).

The timing margins are the reference's or wider, and no case compares
two wall times.
"""
import threading
import time
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.service as RS
from repro.core import geometry as RG
from repro_torch.core import geometry as TG
from repro_torch.core import predicates as TP
from repro_torch.core import raytracing as RT
from repro_torch.core.access import default_indexable_getter
from repro_torch.core.bvh import BVH
from repro_torch.core.engine import EngineConfig, QueryEngine
from repro_torch.core.index import ExecutionPolicy
from repro_torch.core.route_table import RouteRule, RouteTable
from repro_torch.service import (PipelineConfig, ServiceConfig,
                                 ServingPipeline, knn_request, ray_request,
                                 within_request)
import repro_torch.service as TS
import repro_torch.service.pipeline as PL

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


def _config(**kw):
    svc = ServiceConfig(capacity=kw.pop("capacity", 8),
                        min_bucket=8, max_bucket=kw.pop("max_bucket", 16))
    return PipelineConfig(service=svc, **kw)


def _pipeline(n=300, seed=1, engine=None, **kw):
    """n=0 skips the default index (the test creates its own)."""
    pipe = ServingPipeline(engine=engine, config=_config(**kw), device=CPU)
    if n:
        pipe.create_index("default", TG.Points(torch.from_numpy(_pts(n, seed))))
    return pipe


# ---------------------------------------------------------------------------
# correctness: async results == direct BVH queries == the reference's
# ---------------------------------------------------------------------------

def test_pipeline_results_match_direct_queries():
    pts = _pts(400, seed=2)
    with _pipeline(0, 0) as pipe:
        pipe.create_index("default", TG.Points(torch.from_numpy(pts)))
        bvh = BVH(TG.Points(torch.from_numpy(pts)),
                  policy=ExecutionPolicy(device=CPU))
        qa, qb = _pts(5, 3), _pts(7, 4)
        dirs = np.random.default_rng(5).normal(size=(7, DIM)).astype(np.float32)
        tk = pipe.submit(knn_request(qa, k=3))
        tw = pipe.submit(within_request(qb, 0.2))
        tr = pipe.submit(ray_request(qb, dirs, k=2))
        rk, rw, rr = (t.result(60.0) for t in (tk, tw, tr))

    want = bvh.query(TP.nearest(TG.Points(torch.from_numpy(qa)), k=3))
    assert np.array_equal(rk.dists, want.distances.numpy())
    assert np.array_equal(rk.idxs, want.indices.numpy())
    counts = bvh.count(TP.intersects(TG.Spheres(torch.from_numpy(qb),
                                                torch.full((7,), 0.2))))
    assert np.array_equal(rw.counts, counts.numpy())
    t, i = RT.cast_nearest(bvh, TG.Rays(torch.from_numpy(qb),
                                        torch.from_numpy(dirs)), k=2)
    assert np.array_equal(rr.dists, t.numpy())
    assert np.array_equal(rr.idxs, i.numpy())
    for r in (rk, rw, rr):
        assert r.stats.queue_wait_us >= 0 and r.stats.service_us > 0
        assert r.stats.index_version == 1


def test_pipeline_results_match_the_reference_pipeline():
    """The same submitted requests through both pipelines (the port's
    engine sends no batch to brute force, whose expansion the reference's
    walk does not share: see tests/test_torch_service.py)."""
    rng = np.random.default_rng(80)
    pts = _pts(600, 81)
    lo, hi = pts - 0.02, pts + 0.02
    reqs = []
    for i in range(12):
        m = int(rng.integers(1, 20))
        q = rng.uniform(0, 1, (m, DIM)).astype(np.float32)
        d = rng.normal(size=(m, DIM)).astype(np.float32)
        reqs.append(("knn", q, None, 4) if i % 3 == 0 else
                    ("within", q, 0.1, 0) if i % 3 == 1 else ("ray", q, d, 2))

    def run(M, pipe, points, boxes):
        with pipe:
            pipe.create_index("points", points)
            pipe.create_index("boxes", boxes)
            tickets = []
            for kind, q, b, k in reqs:
                if kind == "knn":
                    r = M.knn_request(q, k=k, index="points")
                elif kind == "within":
                    r = M.within_request(q, b, index="points")
                else:
                    r = M.ray_request(q, b, k=k, index="boxes")
                tickets.append(pipe.submit(r, deadline_us=50_000.0))
            return [t.result(120.0) for t in tickets]

    svc = dict(capacity=16, min_bucket=8, max_bucket=32)
    want = run(RS, RS.ServingPipeline(config=RS.PipelineConfig(
        service=RS.ServiceConfig(**svc))), RG.Points(jnp.asarray(pts)),
        RG.Boxes(jnp.asarray(lo), jnp.asarray(hi)))
    engine = QueryEngine(EngineConfig(route_table=RouteTable(
        rules={"default": RouteRule(bf_max_work=0)})))
    got = run(TS, ServingPipeline(engine=engine, config=PipelineConfig(
        service=ServiceConfig(**svc)), device=CPU),
        TG.Points(torch.from_numpy(pts)),
        TG.Boxes(torch.from_numpy(lo), torch.from_numpy(hi)))
    for (kind, *_), g, w in zip(reqs, got, want):
        assert g.stats.index_version == w.stats.index_version == 1
        if kind == "within":
            assert np.array_equal(g.counts, w.counts)
            assert g.overflow == w.overflow
            for gi, wi, c in zip(g.idxs, w.idxs, w.counts):
                if c <= svc["capacity"]:
                    assert sorted(gi[:c].tolist()) == sorted(wi[:c].tolist())
        elif kind == "ray":
            assert np.array_equal(g.dists, w.dists)
            assert np.array_equal(g.idxs, w.idxs)
        else:
            assert np.allclose(g.dists, w.dists, rtol=0, atol=1e-6)
            for gi, wi, wd in zip(g.idxs, w.idxs, w.dists):
                for j, d in enumerate(wd):
                    if d < wd[-1] - 1e-6 and np.sum(np.abs(wd - d) <= 1e-6) == 1:
                        assert gi[j] == wi[j]


# ---------------------------------------------------------------------------
# adaptive batch formation
# ---------------------------------------------------------------------------

def test_group_closes_when_full():
    with _pipeline(200, seed=6, max_bucket=16) as pipe:
        # 10 s deadlines: only the FULL trigger can close this group fast
        t1 = pipe.submit(knn_request(_pts(8, 7), k=2), deadline_us=10_000_000)
        t2 = pipe.submit(knn_request(_pts(8, 8), k=2), deadline_us=10_000_000)
        r1, r2 = t1.result(60.0), t2.result(60.0)
        st = pipe.stats()
    assert r1.stats.bucket == r2.stats.bucket == 16   # one shared batch
    assert st.batches == 1 and st.closed_full == 1
    assert st.batch_rows == 16 and st.batch_slots == 16
    assert st.occupancy == 1.0


def test_group_closes_on_deadline_budget():
    with _pipeline(200, seed=9, default_service_est_us=30_000.0) as pipe:
        pipe.warmup("default", [("knn", 2)], max_bucket=8)
        t = pipe.submit(knn_request(_pts(1, 10), k=2), deadline_us=100_000)
        r = t.result(60.0)
        st = pipe.stats()
    # it lingered for more traffic (deadline - est - slack ~= 53 ms), then
    # the budget forced the close
    assert st.closed_deadline == 1 and st.closed_full == 0
    assert r.stats.queue_wait_us >= 40_000
    assert r.stats.deadline_us == 100_000


def test_hopeless_deadline_dispatches_immediately_and_is_flagged():
    with _pipeline(200, seed=11) as pipe:
        t = pipe.submit(knn_request(_pts(1, 12), k=2), deadline_us=1_000)
        r = t.result(60.0)
        st = pipe.stats()
    assert r.stats.queue_wait_us < 1_000_000
    assert r.stats.deadline_missed
    assert st.deadline_missed == 1 and st.miss_rate == 1.0


def test_no_deadline_rides_linger_cap():
    with _pipeline(200, seed=13, max_linger_us=2_000.0) as pipe:
        t = pipe.submit(knn_request(_pts(2, 14), k=2))
        r = t.result(60.0)
    assert r.stats.deadline_us is None and not r.stats.deadline_missed
    assert r.stats.queue_wait_us < 5_000_000


def test_oversized_request_dispatches_alone_at_natural_bucket():
    with _pipeline(200, seed=15, max_bucket=16) as pipe:
        t = pipe.submit(knn_request(_pts(40, 16), k=2), deadline_us=10_000_000)
        r = t.result(60.0)
        st = pipe.stats()
    assert r.stats.bucket == 64 and st.closed_full == 1
    assert r.idxs.shape == (40, 2)


def test_submit_unknown_kind_raises_named_error():
    from repro_torch.service.batcher import Request
    bogus = object.__new__(Request)
    for field, val in (("kind", "hyperplane"), ("a", _pts(3, 17)), ("b", None),
                       ("k", 1), ("index", "default")):
        object.__setattr__(bogus, field, val)
    with _pipeline(100, seed=18) as pipe:
        with pytest.raises(ValueError, match=r"hyperplane.*knn.*within.*ray"):
            pipe.submit(bogus)


def test_unknown_index_fails_ticket_not_pipeline():
    with _pipeline(100, seed=19) as pipe:
        t = pipe.submit(knn_request(_pts(2, 20), k=1, index="nope"))
        with pytest.raises(KeyError, match="nope"):
            t.result(60.0)
        ok = pipe.submit(knn_request(_pts(2, 21), k=1))
        assert ok.result(60.0).stats.index_version == 1
        assert pipe.stats().failed == 1


def test_close_drains_pending_requests():
    pipe = _pipeline(200, seed=22)
    tickets = [pipe.submit(knn_request(_pts(2, 23 + i), k=2),
                           deadline_us=10_000_000) for i in range(3)]
    pipe.close()
    assert all(t.done() for t in tickets)
    assert {t.result(0).stats.index_version for t in tickets} == {1}
    with pytest.raises(RuntimeError, match="closed"):
        pipe.submit(knn_request(_pts(1, 29), k=2))
    with pytest.raises(RuntimeError, match="closed"):
        pipe.update_index("default", TG.Points(torch.from_numpy(_pts(9, 1))))


# ---------------------------------------------------------------------------
# background maintenance
# ---------------------------------------------------------------------------

def test_serving_never_blocks_on_maintenance():
    gate, in_build = threading.Event(), threading.Event()

    def gated_getter(values):
        if "maintenance" in threading.current_thread().name:
            in_build.set()
            assert gate.wait(60.0)
        return default_indexable_getter(values)

    with _pipeline(0, 0) as pipe:
        pipe.create_index("default", TG.Points(torch.from_numpy(_pts(150, 30))),
                          gated_getter)
        pipe.update_index("default", TG.Points(torch.from_numpy(_pts(200, 31))))
        assert in_build.wait(60.0)
        served = [pipe.submit(knn_request(_pts(2, 32 + i), k=2)).result(60.0)
                  for i in range(3)]
        assert [r.stats.index_version for r in served] == [1, 1, 1]
        assert pipe.stats().swap_count == 0

        gate.set()
        assert pipe.wait_maintenance_idle(60.0)
        st = pipe.stats()
        assert st.swap_count == 1 and st.rebuilds == 1
        assert st.stalled_behind_maintenance == 0
        after = pipe.submit(knn_request(_pts(2, 40), k=2)).result(60.0)
        assert after.stats.index_version == 2


def test_rebuild_publishes_mid_flight_while_batch_finishes_on_pinned_version(
        monkeypatch):
    real_execute = PL.execute_group
    in_dispatch, go = threading.Event(), threading.Event()
    gating = [True]

    def gated_execute(engine, config, entry, group):
        if gating[0]:
            gating[0] = False
            in_dispatch.set()
            assert go.wait(60.0)
        return real_execute(engine, config, entry, group)

    monkeypatch.setattr(PL, "execute_group", gated_execute)
    pipe = _pipeline(150, seed=41)
    try:
        t = pipe.submit(knn_request(_pts(2, 42), k=2))
        assert in_dispatch.wait(60.0)
        pipe.update_index("default", TG.Points(torch.from_numpy(_pts(220, 43))))
        assert pipe.wait_maintenance_idle(60.0)
        assert pipe.store.get("default").version == 2
        go.set()
        r = t.result(60.0)
        assert r.stats.index_version == 1               # pinned throughout
        r2 = pipe.submit(knn_request(_pts(2, 44), k=2)).result(60.0)
        assert r2.stats.index_version == 2
    finally:
        go.set()
        pipe.close()


def test_updates_coalesce_to_newest_values():
    with _pipeline(0, 0) as pipe:
        gate, in_build = threading.Event(), threading.Event()

        def gated_getter(values):
            if "maintenance" in threading.current_thread().name \
                    and not gate.is_set():
                in_build.set()
                assert gate.wait(60.0)
            return default_indexable_getter(values)

        base = _pts(100, 50)
        pipe.create_index("default", TG.Points(torch.from_numpy(base)),
                          gated_getter)
        pipe.update_index("default", TG.Points(torch.from_numpy(_pts(120, 51))))
        assert in_build.wait(60.0)
        for n in (130, 140, 160):
            pipe.update_index("default",
                              TG.Points(torch.from_numpy(_pts(n, n))))
        gate.set()
        assert pipe.wait_maintenance_idle(60.0)
        st = pipe.stats()
        assert pipe.store.get("default").bvh.size() == 160
        assert st.swap_count == 2


def test_failed_update_counts_an_error_and_serving_goes_on():
    with _pipeline(100, seed=60) as pipe:
        pipe.update_index("nope", TG.Points(torch.from_numpy(_pts(9, 61))))
        assert pipe.wait_maintenance_idle(60.0)
        st = pipe.stats()
        assert st.maintenance_errors == 1 and st.swap_count == 0
        r = pipe.submit(knn_request(_pts(2, 62), k=1)).result(60.0)
        assert r.stats.index_version == 1


@pytest.mark.parametrize("outcome", ["refit", "error"])
def test_counters_are_final_when_maintenance_goes_idle(monkeypatch, outcome):
    """wait_maintenance_idle returns only after the maintenance thread
    has counted its update. The pipeline's conditions are made to hold
    the maintenance thread for 0.3 s each time it enters one, so a
    counter update made after the thread leaves the in-flight count
    (and wakes the waiter) would still be pending when stats() reads."""
    class SlowForMaintenance(threading.Condition):
        def __enter__(self):
            if threading.current_thread().name == "repro-pipeline-maintenance":
                time.sleep(0.3)
            return super().__enter__()

    slow = types.SimpleNamespace(**vars(threading))
    slow.Condition = SlowForMaintenance
    monkeypatch.setattr(PL, "threading", slow)
    with _pipeline(100, seed=64) as pipe:
        name = "default" if outcome == "refit" else "missing"
        pipe.update_index(name, TG.Points(torch.from_numpy(_pts(100, 64) + 1e-4)))
        assert pipe.wait_maintenance_idle(60.0)
        st = pipe.stats()
        if outcome == "refit":
            assert (st.refits, st.swap_count, st.maintenance_errors) == (1, 1, 0)
        else:
            assert (st.maintenance_errors, st.swap_count) == (1, 0)
        assert st.maintenance_pending == 0


def test_cpu_pipeline_has_no_maintenance_stream():
    with _pipeline(50, seed=63) as pipe:
        assert pipe.maintenance_stream is None
        assert pipe.store.device.type == "cpu"


def test_pipeline_serves_the_store_it_is_given():
    from repro_torch.service import IndexStore
    store = IndexStore(keep_versions=7, device=CPU)
    with ServingPipeline(store=store, config=_config()) as pipe:
        assert pipe.store is store and pipe.engine is store.engine
        pipe.create_index("default", TG.Points(torch.from_numpy(_pts(50, 64))))
        r = pipe.submit(knn_request(_pts(2, 65), k=1)).result(60.0)
    assert r.stats.index_version == 1 and store.keep_versions == 7
