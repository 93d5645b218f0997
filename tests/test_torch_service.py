"""The port's serving stack (``repro_torch.service``) and the engine's
executable cache against the JAX reference (``repro.service``) on the CPU.

Compared at these tolerances, on seeded numpy inputs:

  * ``Batcher.plan``: equal groups (keys, buckets, members, n_real) and
    padded arrays bit for bit;
  * ``QueryServer.handle`` against the reference's server on the same
    points, requests and capacities: within-radius counts and overflow
    flags equal, index sets equal on rows whose count fits the capacity;
    kNN distances within 1e-6 (absolute) and indices equal wherever a
    row's distance is below its k-th and unique in the row (ties may
    order differently); ray t and indices equal (tolerance 0, as
    ``tests/test_torch_ray_knn.py`` holds ``cast_nearest``);
  * the executable-cache accounting (hits, misses, traces) equal after
    every ``handle`` of the same request sequence.

The two packages route differently by design (the port has no minimum
batch for its kernels, and sends rays to the ray kNN kernel), so route
names are not compared. In the parity cases the port's engine sends no
batch to brute force: the reference's server takes its exact walk for
kNN over Points here, and the port's brute force, like the reference's,
expands |q - p|^2 (Queue 3 of ROADMAP.md).

The rest are the reference's own cases (``tests/test_service.py``) on the
port: zero traces after warm-up across 100 mixed requests, cache keys
split by route, shape and getter, LRU eviction, forced routes agreeing,
the degenerate index, and ``EngineConfig.force``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.service as RS
from repro.core import geometry as RG
from repro_torch import service as TS
from repro_torch.core import callbacks as CB
from repro_torch.core import geometry as TG
from repro_torch.core import predicates as TP
from repro_torch.core.access import default_indexable_getter
from repro_torch.core.bvh import BVH
from repro_torch.core.engine import (ROUTE_BRUTEFORCE, ROUTE_KERNEL,
                                     ROUTE_LOOP, EngineConfig,
                                     EngineStatsSnapshot, QueryEngine)
from repro_torch.core.index import ExecutionPolicy
from repro_torch.core.route_table import RouteRule, RouteTable
from repro_torch.service.batcher import Batcher, Request, bucket_size

CPU = "cpu"
DIM = 3
KNN_ATOL = 1e-6
NO_BRUTE_FORCE = RouteTable(rules={"default": RouteRule(bf_max_work=0)})


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One CPU thread per pytest worker."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _pts(n, seed=0, dim=DIM):
    return np.random.default_rng(seed).uniform(
        0, 1, (n, dim)).astype(np.float32)


def _server(n=500, seed=1, capacity=32, config=None, engine=None):
    srv = TS.QueryServer(engine=engine,
                         config=config or TS.ServiceConfig(capacity=capacity),
                         device=CPU)
    srv.create_index("default", TG.Points(torch.from_numpy(_pts(n, seed))))
    return srv


# ---------------------------------------------------------------------------
# batcher: the same plan in both packages
# ---------------------------------------------------------------------------

def _mix(M, seed):
    """A seeded request mix of every kind in request module M."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(12):
        m = int(rng.integers(1, 70))
        dim = 2 if i % 5 == 4 else DIM
        a = rng.uniform(0, 1, (m, dim)).astype(np.float32)
        kind = ("knn", "within", "ray")[int(rng.integers(0, 3))]
        index = ("default", "other")[int(rng.integers(0, 2))]
        if kind == "knn":
            reqs.append(M.knn_request(a, k=int(rng.choice([1, 3, 8])),
                                      index=index))
        elif kind == "within":
            r = rng.uniform(0, 0.2, (m,)) if i % 2 else float(rng.uniform())
            reqs.append(M.within_request(a, r, index=index))
        else:
            reqs.append(M.ray_request(a, rng.normal(size=(m, dim)),
                                      k=int(rng.choice([1, 4])), index=index))
    return reqs


@pytest.mark.parametrize("min_bucket", [1, 8, 32])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_batcher_plans_equal_groups(seed, min_bucket):
    want = RS.Batcher(min_bucket).plan(_mix(RS, seed))
    got = TS.Batcher(min_bucket).plan(_mix(TS, seed))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.key, g.bucket, g.n_real, g.members) == \
            (w.key, w.bucket, w.n_real, w.members)
        assert g.a.dtype == w.a.dtype and g.a.tobytes() == w.a.tobytes()
        assert (g.b is None) == (w.b is None)
        if g.b is not None:
            assert g.b.dtype == w.b.dtype and g.b.tobytes() == w.b.tobytes()


def test_bucket_size_power_of_two():
    assert [bucket_size(q) for q in (1, 7, 8, 9, 100, 128)] \
        == [8, 8, 8, 16, 128, 128]
    assert bucket_size(3, min_bucket=4) == 4


def test_batcher_groups_by_kind_k_and_pads():
    b = Batcher(min_bucket=8)
    reqs = [TS.knn_request(_pts(5, 1), k=4), TS.knn_request(_pts(6, 2), k=4),
            TS.knn_request(_pts(3, 3), k=2), TS.within_request(_pts(9, 4), 0.1),
            TS.ray_request(_pts(2, 5), np.ones((2, DIM), np.float32))]
    groups = b.plan(reqs)
    assert len(groups) == 4          # knn k=4, knn k=2, within, ray
    by_kind = {(g.kind, g.k): g for g in groups}
    g = by_kind[("knn", 4)]
    assert (g.n_real, g.bucket, g.a.shape) == (11, 16, (16, DIM))
    assert [(rid, m) for rid, _, m in g.members] == [(0, 5), (1, 6)]
    assert np.array_equal(g.a[11:], np.repeat(g.a[10:11], 5, 0))
    assert by_kind[("within", 0)].bucket == 16
    assert by_kind[("ray", 1)].bucket == 8


def test_batcher_rejects_bad_requests():
    bogus = object.__new__(Request)
    for field, val in (("kind", "voxel"), ("a", _pts(3, 1)), ("b", None),
                       ("k", 1), ("index", "default")):
        object.__setattr__(bogus, field, val)
    with pytest.raises(ValueError, match=r"voxel.*knn.*within.*ray"):
        Batcher().plan([bogus])
    with pytest.raises(ValueError, match=r"voxel.*knn.*within.*ray"):
        Request("voxel", _pts(3, 1))
    with pytest.raises(ValueError, match="empty"):
        TS.knn_request(np.zeros((0, DIM), np.float32))
    with pytest.raises(ValueError, match="mismatch"):
        Request("within", _pts(5, 2), np.full((3,), 0.1, np.float32))
    with pytest.raises(ValueError, match="power of two"):
        Batcher(min_bucket=6)


# ---------------------------------------------------------------------------
# QueryServer.handle against the reference's server
# ---------------------------------------------------------------------------

def _same_knn(got, want, label):
    assert got.dists.shape == want.dists.shape, label
    fin = np.isfinite(want.dists)
    assert np.array_equal(np.isfinite(got.dists), fin), label
    assert np.allclose(got.dists[fin], want.dists[fin], rtol=0,
                       atol=KNN_ATOL), label
    assert np.array_equal(got.idxs < 0, want.idxs < 0), label
    for row, (gi, wi, wd) in enumerate(zip(got.idxs, want.idxs, want.dists)):
        kth = wd[-1]
        for j, d in enumerate(wd):
            # away from ties the index is the same
            if (np.isfinite(d) and d < kth - KNN_ATOL
                    and np.sum(np.abs(wd - d) <= KNN_ATOL) == 1):
                assert gi[j] == wi[j], (label, row, j)


def _same_response(got, want, capacity, label):
    if want.counts is not None:
        assert np.array_equal(got.counts, want.counts), label
        assert got.overflow == want.overflow, label
        for gi, wi, c in zip(got.idxs, want.idxs, want.counts):
            if c <= capacity:
                assert sorted(gi[:c].tolist()) == sorted(wi[:c].tolist())
                assert (gi[c:] == -1).all()
    elif want.stats.kind == "ray":
        assert np.array_equal(got.dists, want.dists), label
        assert np.array_equal(got.idxs, want.idxs), label
    else:
        _same_knn(got, want, label)
    assert (got.stats.kind, got.stats.bucket, got.stats.index_name,
            got.stats.index_version) == \
        (want.stats.kind, want.stats.bucket, want.stats.index_name,
         want.stats.index_version), label
    assert got.stats.cache_hit == want.stats.cache_hit, label


def _requests(M, rng, dim, ks, radius):
    """Two handle() batches of kNN, within and ray requests (m 1-64): new
    query points of the same sizes, so the second batch rides the
    buckets the first one warmed (cache hits in both packages)."""
    sizes = [int(rng.integers(1, 65)) for _ in ks] + \
        [int(rng.integers(1, 9)), int(rng.integers(1, 25)),
         int(rng.integers(1, 65))]
    out = []
    for _ in range(2):
        reqs = [M.knn_request(rng.uniform(0, 1, (m, dim)), k=k, index="points")
                for k, m in zip(ks, sizes)]
        for m in sizes[len(ks):-1]:
            reqs.append(M.within_request(rng.uniform(0, 1, (m, dim)), radius,
                                         index="points"))
        m = sizes[-1]
        reqs.append(M.ray_request(rng.uniform(0, 1, (m, dim)),
                                  rng.normal(size=(m, dim)), k=ks[-1],
                                  index="boxes"))
        out.append(reqs)
    return out


# (N, dim, capacity, kNN ks, within radius): capacity 4 overflows on some
# rows, 64 on none
SERVER_CASES = [(300, 3, 4, (1, 8), 0.15), (2000, 2, 64, (3,), 0.05)]


@pytest.mark.parametrize("n,dim,capacity,ks,radius", SERVER_CASES)
def test_handle_matches_the_reference_server(n, dim, capacity, ks, radius):
    pts = _pts(n, n, dim)
    lo, hi = pts - 0.02, pts + 0.02
    ref = RS.QueryServer(config=RS.ServiceConfig(capacity=capacity))
    ref.create_index("points", RG.Points(jnp.asarray(pts)))
    ref.create_index("boxes", RG.Boxes(jnp.asarray(lo), jnp.asarray(hi)))
    port = TS.QueryServer(
        engine=QueryEngine(EngineConfig(route_table=NO_BRUTE_FORCE)),
        config=TS.ServiceConfig(capacity=capacity), device=CPU)
    port.create_index("points", TG.Points(torch.from_numpy(pts)))
    port.create_index("boxes", TG.Boxes(torch.from_numpy(lo),
                                        torch.from_numpy(hi)))
    batches = zip(_requests(RS, np.random.default_rng(n + 1), dim, ks, radius),
                  _requests(TS, np.random.default_rng(n + 1), dim, ks, radius))
    overflowed = False
    for step, (want_reqs, got_reqs) in enumerate(batches):
        want = ref.handle(want_reqs)
        got = port.handle(got_reqs)
        for i, (g, w) in enumerate(zip(got, want)):
            _same_response(g, w, capacity, (n, dim, step, i))
            overflowed |= w.overflow
        # the same cache accounting after every handle()
        assert port.engine.stats.snapshot() == _as_port_snapshot(
            ref.engine.stats)
        assert all(g.stats.cache_hit for g in got) == (step == 1)
    assert overflowed == (capacity < 64)


def _as_port_snapshot(stats):
    """The reference's EngineStats as the port's snapshot type."""
    return EngineStatsSnapshot(**dataclasses.asdict(stats.snapshot()))


def test_degenerate_index_matches_the_reference():
    """N = 1 (no tree): both servers scan the one point."""
    one = _pts(1, 31)
    ref = RS.QueryServer(config=RS.ServiceConfig(capacity=8))
    ref.create_index("default", RG.Points(jnp.asarray(one)))
    port = TS.QueryServer(config=TS.ServiceConfig(capacity=8), device=CPU)
    port.create_index("default", TG.Points(torch.from_numpy(one)))
    q = _pts(3, 32)
    want, got = (srv.handle([M.knn_request(q, k=2), M.within_request(q, 10.0)])
                 for M, srv in ((RS, ref), (TS, port)))
    for g, w in zip(got, want):
        _same_response(g, w, 8, "degenerate")
        assert g.stats.route == ROUTE_LOOP and not g.stats.cache_hit


# ---------------------------------------------------------------------------
# the reference's server cases on the port
# ---------------------------------------------------------------------------

def test_server_scatter_matches_direct_queries():
    pts = _pts(400, seed=2)
    srv = TS.QueryServer(config=TS.ServiceConfig(capacity=64), device=CPU)
    srv.create_index("default", TG.Points(torch.from_numpy(pts)))
    bvh = BVH(TG.Points(torch.from_numpy(pts)),
              policy=ExecutionPolicy(device=CPU))

    qa, qb, qc = _pts(5, 3), _pts(11, 4), _pts(7, 5)
    dirs = np.random.default_rng(6).normal(size=(7, DIM)).astype(np.float32)
    rs = srv.handle([TS.knn_request(qa, k=3), TS.within_request(qb, 0.2),
                     TS.ray_request(qc, dirs, k=2)])

    kr = bvh.query(TP.nearest(TG.Points(torch.from_numpy(qa)), k=3))
    assert np.array_equal(rs[0].dists, kr.distances.numpy())
    assert np.array_equal(rs[0].idxs, kr.indices.numpy())
    want = bvh.count(TP.intersects(TG.Spheres(torch.from_numpy(qb),
                                              torch.full((11,), 0.2))))
    assert np.array_equal(rs[1].counts, want.numpy())
    assert not rs[1].overflow
    for row, c in zip(rs[1].idxs, rs[1].counts):
        assert (row[:c] >= 0).all() and (row[c:] == -1).all()
    from repro_torch.core import raytracing as RT
    t, i = RT.cast_nearest(bvh, TG.Rays(torch.from_numpy(qc),
                                        torch.from_numpy(dirs)), k=2)
    assert np.array_equal(rs[2].dists, t.numpy())
    assert np.array_equal(rs[2].idxs, i.numpy())
    for r, kind in zip(rs, ("knn", "within", "ray")):
        assert r.stats.kind == kind
        assert r.stats.route in (ROUTE_BRUTEFORCE, ROUTE_KERNEL, ROUTE_LOOP)
        assert r.stats.bucket == bucket_size(len(r.dists if r.counts is None
                                                else r.counts))
        assert (r.stats.index_name, r.stats.index_version) == ("default", 1)
    assert rs[2].stats.route == ROUTE_KERNEL    # the ray kNN kernel's twin


def test_server_within_overflow_flagged_per_request():
    srv = _server(60, seed=7, capacity=4)
    rs = srv.handle([TS.within_request(_pts(3, 8), 10.0),
                     TS.within_request(_pts(3, 9) + 50.0, 1e-6)])
    assert rs[0].overflow and (rs[0].counts == 60).all()
    assert not rs[1].overflow and (rs[1].counts == 0).all()


def test_server_serves_updated_index_version():
    pts = _pts(300, seed=10)
    srv = _server(300, seed=10)
    r0 = srv.handle([TS.knn_request(_pts(4, 11), k=2)])[0]
    assert r0.stats.index_version == 1
    srv.update_index("default", TG.Points(torch.from_numpy(pts + 0.001)))
    r1 = srv.handle([TS.knn_request(_pts(4, 11), k=2)])[0]
    assert r1.stats.index_version == 2
    # same bucket shape + same N -> the refit swap reuses the warm entry
    assert r1.stats.cache_hit


def test_zero_traces_after_warmup_across_100_mixed_requests():
    rng = np.random.default_rng(12)
    srv = _server(500, seed=12, capacity=16)
    srv.warmup("default", [("knn", 8), ("within", 0), ("ray", 1)],
               max_bucket=128, dim=DIM)
    stats = srv.engine.stats
    assert stats.jit_traces == stats.cache_misses > 0

    before = stats.snapshot()
    served = 0
    for _ in range(25):                      # 25 calls x 4 requests = 100
        m = [int(rng.integers(1, 65)) for _ in range(4)]
        reqs = [TS.knn_request(rng.uniform(0, 1, (m[0], DIM)), k=8),
                TS.within_request(rng.uniform(0, 1, (m[1], DIM)), 0.1),
                TS.knn_request(rng.uniform(0, 1, (m[2], DIM)), k=8),
                TS.ray_request(rng.uniform(0, 1, (m[3], DIM)),
                               rng.normal(size=(m[3], DIM)))]
        for r in srv.handle(reqs):
            assert r.stats.cache_hit
            served += 1
    assert served == 100
    after = srv.engine.stats
    assert after.jit_traces == before.jit_traces       # ZERO traces
    assert after.cache_misses == before.cache_misses
    assert after.cache_hits > before.cache_hits


def test_exec_cache_keys_split_by_route_and_shape():
    eng = QueryEngine(EngineConfig(force="loop"))
    srv = TS.QueryServer(engine=eng, config=TS.ServiceConfig(capacity=8),
                         device=CPU)
    srv.create_index("default", TG.Points(torch.from_numpy(_pts(300, 13))))
    srv.handle([TS.within_request(_pts(5, 14), 0.1)])    # bucket 8
    srv.handle([TS.within_request(_pts(20, 15), 0.1)])   # bucket 32
    assert eng.stats.cache_misses == 2
    srv.handle([TS.within_request(_pts(6, 16), 0.1)])    # bucket 8 again
    assert eng.stats.cache_misses == 2
    assert eng.stats.cache_hits == 1
    keys = list(eng._executables)
    assert {k[0] for k in keys} == {ROUTE_LOOP}
    assert {k[1] for k in keys} == {"spatial"}


def test_exec_paths_agree_across_forced_routes():
    """The same bucket served by all three routes returns identical counts
    and match sets, and kNN lists, through the service."""
    pts = _pts(400, seed=17)
    q = _pts(24, 18)
    results = {}
    for force in (ROUTE_LOOP, ROUTE_BRUTEFORCE, ROUTE_KERNEL):
        eng = QueryEngine(EngineConfig(force=force))
        srv = TS.QueryServer(engine=eng, config=TS.ServiceConfig(capacity=32),
                             device=CPU)
        srv.create_index("default", TG.Points(torch.from_numpy(pts)))
        rs = srv.handle([TS.within_request(q, 0.2), TS.knn_request(q, k=4)])
        assert {r.stats.route for r in rs} == {force}
        results[force] = rs
    ref_w, ref_k = results[ROUTE_LOOP]
    for force in (ROUTE_BRUTEFORCE, ROUTE_KERNEL):
        got_w, got_k = results[force]
        assert np.array_equal(got_w.counts, ref_w.counts)
        for ra, rb, c in zip(got_w.idxs, ref_w.idxs, ref_w.counts):
            assert set(ra[:c].tolist()) == set(rb[:c].tolist())
        # brute force expands |q - p|^2: its distances are within its
        # rounding of the walk's (ROADMAP Queue 3)
        assert np.allclose(got_k.dists, ref_k.dists, rtol=0, atol=1e-5)
    assert np.array_equal(results[ROUTE_KERNEL][1].dists, ref_k.dists)
    assert np.array_equal(results[ROUTE_KERNEL][1].idxs, ref_k.idxs)


def test_server_survives_degenerate_index():
    srv = _server(300, seed=30)
    one = TG.Points(torch.from_numpy(_pts(1, 31)))
    v = srv.update_index("default", one)        # N change -> rebuild, no tree
    assert v.action == "rebuild" and v.bvh.tree is None
    q = _pts(3, 32)
    rs = srv.handle([TS.knn_request(q, k=2), TS.within_request(q, 10.0),
                     TS.ray_request(q, np.ones((3, DIM), np.float32))])
    assert (rs[0].idxs[:, 0] == 0).all()        # the one point is everyone's NN
    assert (rs[0].idxs[:, 1] == -1).all()
    assert (rs[1].counts == 1).all()
    for r in rs:
        assert r.stats.route == ROUTE_LOOP and not r.stats.cache_hit


def test_exec_cache_keyed_on_indexable_getter():
    eng = QueryEngine(EngineConfig())
    srv = TS.QueryServer(engine=eng, config=TS.ServiceConfig(capacity=8),
                         device=CPU)
    pts = _pts(100, 33)

    def fat_getter(values):     # inflate each point to a box
        b = default_indexable_getter(values)
        return TG.Boxes(b.lo - 0.05, b.hi + 0.05)

    srv.create_index("plain", TG.Points(torch.from_numpy(pts)))
    srv.create_index("fat", TG.Points(torch.from_numpy(pts)), fat_getter)
    srv.handle([TS.within_request(_pts(4, 34), 0.1, index="plain")])
    m1 = eng.stats.cache_misses
    srv.handle([TS.within_request(_pts(4, 34), 0.1, index="fat")])
    assert eng.stats.cache_misses == m1 + 1     # distinct entry


def test_exec_cache_lru_eviction_bounded():
    eng = QueryEngine(EngineConfig(force="loop", max_executables=1))
    srv = TS.QueryServer(engine=eng, config=TS.ServiceConfig(capacity=8),
                         device=CPU)
    srv.create_index("default", TG.Points(torch.from_numpy(_pts(300, 40))))
    srv.handle([TS.within_request(_pts(5, 41), 0.1)])    # bucket 8 (cached)
    srv.handle([TS.within_request(_pts(20, 42), 0.1)])   # bucket 32 evicts it
    assert len(eng._executables) == 1
    srv.handle([TS.within_request(_pts(5, 41), 0.1)])    # bucket 8: re-miss
    assert eng.stats.cache_misses == 3 and eng.stats.cache_hits == 0
    assert eng.stats.jit_traces == 3


def test_warmup_defaults_warm_all_three_kinds_zero_cold_dispatch():
    srv = _server(300, seed=60, capacity=8,
                  config=TS.ServiceConfig(capacity=8, min_bucket=8,
                                          max_bucket=32))
    srv.warmup("default")                      # no kinds, no bucket, no dim
    before = srv.engine.stats.snapshot()
    rng = np.random.default_rng(61)
    for m in (3, 9, 30):                       # buckets 8, 16, 32
        q = rng.uniform(0, 1, (m, DIM)).astype(np.float32)
        d = rng.normal(size=(m, DIM)).astype(np.float32)
        rs = srv.handle([TS.knn_request(q, k=1), TS.within_request(q, 0.1),
                         TS.ray_request(q, d, k=1)])
        assert all(r.stats.cache_hit for r in rs)
    after = srv.engine.stats
    assert after.jit_traces == before.jit_traces
    assert after.cache_misses == before.cache_misses


def test_warmup_explicit_kinds_still_cover_missing_ones():
    srv = _server(300, seed=62, capacity=8)
    srv.warmup("default", [("knn", 8)], max_bucket=8, dim=DIM)
    before = srv.engine.stats.snapshot()
    q = _pts(4, 63)
    rs = srv.handle([TS.ray_request(q, np.ones((4, DIM), np.float32), k=1),
                     TS.within_request(q, 0.1)])
    assert all(r.stats.cache_hit for r in rs)
    assert srv.engine.stats.jit_traces == before.jit_traces


def test_warmup_rounds_max_bucket_up_to_pow2():
    srv = _server(300, seed=50, capacity=8)
    srv.warmup("default", [("knn", 2)], max_bucket=100, dim=DIM)
    r = srv.handle([TS.knn_request(_pts(100, 51), k=2)])[0]
    assert r.stats.bucket == 128 and r.stats.cache_hit


# ---------------------------------------------------------------------------
# EngineConfig.force
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route", [ROUTE_BRUTEFORCE, ROUTE_KERNEL, ROUTE_LOOP])
def test_engine_config_force_pins_the_route(route):
    srv = _server(300, seed=70, capacity=8,
                  engine=QueryEngine(EngineConfig(force=route)))
    q = _pts(5, 71)
    rs = srv.handle([TS.within_request(q, 0.1), TS.knn_request(q, k=2)])
    assert {r.stats.route for r in rs} == {route}


def test_forced_loop_sends_callbacks_to_the_loop():
    eng = QueryEngine(EngineConfig(force=ROUTE_LOOP,
                                   route_table=NO_BRUTE_FORCE))
    srv = _server(300, seed=64, capacity=8, engine=eng)
    q = _pts(9, 65)
    rs = srv.handle([TS.knn_request(q, k=3), TS.within_request(q, 0.1),
                     TS.ray_request(q, np.ones((9, DIM), np.float32))])
    assert {r.stats.route for r in rs} == {ROUTE_LOOP}
    index = srv.store.get("default").bvh
    preds = TP.intersects(TG.Points(torch.from_numpy(q)))
    counting, _ = CB.counting()
    assert eng.route_callback(index, preds, counting) == ROUTE_LOOP
    assert QueryEngine().route_callback(index, preds, counting) == ROUTE_KERNEL


def test_engine_config_force_rejects_unknown_routes():
    with pytest.raises(ValueError, match="force"):
        EngineConfig(force="pallas")
    assert EngineConfig().force is None


def test_sharded_versions_are_refused_by_name():
    """A version flagged ``sharded`` is kept from the engine's cache by
    that flag alone, as the reference's execute_group does: it goes to
    the executor it carries (``service.sharded``)."""
    calls = []

    class Executor:
        def execute_group(self, config, entry, group):
            calls.append((config, entry, group))
            return {0: "served"}

    @dataclasses.dataclass(frozen=True)
    class Sharded:
        executor: object
        sharded: bool = True

    group = Batcher().plan([TS.knn_request(_pts(2, 72), k=1)])[0]
    entry, cfg = Sharded(Executor()), TS.ServiceConfig()
    assert TS.execute_group(QueryEngine(), cfg, entry, group) == {0: "served"}
    assert calls == [(cfg, entry, group)]
