"""The port's API-v1 shims against the reference's (``repro``'s README,
"Migrating from the per-kind methods").

Each shim forwards to the current spelling and warns once, through
``core.index._warn_deprecated``. On the same seeded inputs, every shim
is held three ways: it warns once, with the reference's text; it gives
what the current spelling gives; and it gives what the reference's shim
gives. The port's execution space is a torch device (or a device name),
mapped into ``ExecutionPolicy(device=...)``; the reference's is a JAX
device or None. ``DistributedTree``'s shims run in a gloo group of one
process, the reference's on a mesh of one device.

``EngineConfig``'s crossover fields are not ported (ROADMAP, the
``benchmark`` PR), so they have no case here.
"""
import datetime
import os
import tempfile
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core import callbacks as JCB
from repro.core import geometry as JG
from repro.core import index as JIX
from repro.core import predicates as JP
from repro.core.brute_force import BruteForce as JBruteForce
from repro.core.bvh import BVH as JBVH
from repro.core.engine import EngineConfig as JEngineConfig
from repro.core.engine import EngineStats as JEngineStats
from repro.core.engine import QueryEngine as JQueryEngine
from repro.core.index import ExecutionPolicy as JPolicy
from repro.service.pipeline import PipelineStats as JPipelineStats
from repro_torch.core import callbacks as CB
from repro_torch.core import geometry as G
from repro_torch.core import index as IX
from repro_torch.core import predicates as P
from repro_torch.core.brute_force import BruteForce
from repro_torch.core.bvh import BVH
from repro_torch.core.engine import EngineConfig, EngineStats, QueryEngine
from repro_torch.core.index import ExecutionPolicy
from repro_torch.service.pipeline import PipelineStats
from test_torch_parity import assert_csr_equal_sets, assert_knn_equal, np_of

CPU = torch.device("cpu")
PTS = np.random.default_rng(0).uniform(0, 1, (200, 3)).astype(np.float32)
QS = np.random.default_rng(1).uniform(0, 1, (16, 3)).astype(np.float32)
RADIUS = 0.15


def _shim(fn, seen):
    """(result, the DeprecationWarning texts of a first call, of a second
    call) with the registry of warned keys `seen` cleared first."""
    seen.clear()
    texts = []
    for _ in range(2):
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            out = fn()
        texts.append([str(w.message) for w in rec
                      if issubclass(w.category, DeprecationWarning)])
    seen.clear()
    return out, texts[0], texts[1]


def _same_warning(port_texts, ref_texts):
    """The port warned on the first call only, each text once, and each
    with a text the reference's shim warned."""
    first, second = port_texts
    assert first and second == [] and len(set(first)) == len(first)
    assert set(first) <= set(ref_texts[0])


def _spheres(q, r):
    return (P.intersects(G.Spheres(torch.from_numpy(q),
                                   torch.full((len(q),), r))),
            JP.intersects(JG.Spheres(jnp.asarray(q),
                                     jnp.full((len(q),), r, jnp.float32))))


#: both BVHs held to their walk kernels (the reference's brute force
#: rounds d^2 by panel, ROADMAP Queue 3)
POLICY = ExecutionPolicy(device="cpu", engine=QueryEngine(
    EngineConfig(force="kernel")))
JPOLICY = JPolicy(engine=JQueryEngine(JEngineConfig(force="pallas")))


def _nearest(q, k):
    return (P.nearest(G.Points(torch.from_numpy(q)), k=k),
            JP.nearest(JG.Points(jnp.asarray(q)), k=k))


@pytest.fixture(scope="module", params=["bvh", "bruteforce"])
def indexes(request):
    """(port index, reference index) over the same points."""
    pts, jpts = G.Points(torch.from_numpy(PTS)), JG.Points(jnp.asarray(PTS))
    if request.param == "bvh":
        return BVH(pts, policy=POLICY), JBVH(jpts, policy=JPOLICY)
    return (BruteForce(pts, policy=ExecutionPolicy(device="cpu")),
            JBruteForce(jpts))


def _run(port_fn, ref_fn):
    got, *pw = _shim(port_fn, IX._SEEN_DEPRECATIONS)
    want, *rw = _shim(ref_fn, JIX._SEEN_DEPRECATIONS)
    _same_warning(pw, rw)
    return got, want


# ---------------------------------------------------------------------------
# Index: count, query, query_callback, query_out, knn
# ---------------------------------------------------------------------------

def test_count_space_first(indexes):
    idx, jidx = indexes
    preds, jpreds = _spheres(QS, RADIUS)
    got, want = _run(lambda: idx.count(CPU, preds),
                     lambda: jidx.count(None, jpreds))
    np.testing.assert_array_equal(np_of(got), np.asarray(want))
    np.testing.assert_array_equal(np_of(got), np_of(idx.count(preds)))


@pytest.mark.parametrize("capacity", [None, 2])
def test_query_space_first_returns_the_legacy_triple(indexes, capacity):
    """query(space, preds[, capacity]): the (values, indices, offsets)
    triple with ``overflow``; a positional capacity too small to hold the
    matches after the doubling retries flags it."""
    idx, jidx = indexes
    preds, jpreds = _spheres(QS, RADIUS)
    extra = () if capacity is None else (capacity,)
    (got, want) = _run(lambda: idx.query(CPU, preds, *extra),
                       lambda: jidx.query(None, jpreds, *extra))
    assert isinstance(got, tuple) and len(got) == 3
    assert got.overflow == want.overflow
    _, indices, offsets = got
    assert_csr_equal_sets(offsets, indices, np.asarray(want[2]),
                          np.asarray(want[1]))
    now = idx.query(preds, capacity=capacity)
    assert got.overflow == now.overflow
    assert_csr_equal_sets(offsets, indices, now.offsets, now.indices)


def test_query_space_first_with_a_callback(indexes):
    idx, jidx = indexes
    preds, jpreds = _spheres(QS, RADIUS)
    got, want = _run(lambda: idx.query(CPU, preds, callback=CB.counting()),
                     lambda: jidx.query(None, jpreds,
                                        callback=JCB.counting()))
    np.testing.assert_array_equal(np_of(got), np.asarray(want))
    np.testing.assert_array_equal(
        np_of(got), np_of(idx.query(preds, callback=CB.counting())))


def test_query_space_first_with_out(indexes):
    idx, jidx = indexes
    preds, jpreds = _spheres(QS, RADIUS)
    got, want = _run(
        lambda: idx.query(CPU, preds, out=lambda p, v, i, t: i * 2),
        lambda: jidx.query(None, jpreds, out=lambda p, v, i, t: i * 2))
    (vals, off), (jvals, joff) = got, want
    assert_csr_equal_sets(off, vals, np.asarray(joff), np.asarray(jvals))
    now = idx.query(preds, out=lambda p, v, i, t: i * 2)
    assert_csr_equal_sets(off, vals, now.offsets, now.values)


def test_query_callback_keeps_the_batched_state(indexes):
    idx, jidx = indexes
    preds, jpreds = _spheres(QS, RADIUS)
    cb, _ = CB.counting()
    jcb, _ = JCB.counting()
    state = torch.zeros((len(QS),), dtype=torch.int32)
    got, want = _run(
        lambda: idx.query_callback(CPU, preds, cb, state),
        lambda: jidx.query_callback(None, jpreds, jcb,
                                    jnp.zeros((len(QS),), jnp.int32)))
    np.testing.assert_array_equal(np_of(got), np.asarray(want))
    np.testing.assert_array_equal(
        np_of(got), np_of(idx.query(preds, callback=CB.counting())))


def test_query_out(indexes):
    idx, jidx = indexes
    preds, jpreds = _spheres(QS, RADIUS)
    got, want = _run(
        lambda: idx.query_out(CPU, preds, lambda p, v, i, t: i + 1),
        lambda: jidx.query_out(None, jpreds, lambda p, v, i, t: i + 1))
    assert_csr_equal_sets(got[1], got[0], np.asarray(want[1]),
                          np.asarray(want[0]))


def test_knn(indexes):
    idx, jidx = indexes
    preds, jpreds = _nearest(QS, 5)
    (d, i), (jd, ji) = _run(lambda: idx.knn(CPU, preds),
                            lambda: jidx.knn(None, jpreds))
    assert_knn_equal(d, i, np.asarray(jd), np.asarray(ji))
    now = idx.query(preds)
    assert_knn_equal(d, i, now.distances, now.indices)


# ---------------------------------------------------------------------------
# the space-first constructors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("space", [CPU, "cpu"])
def test_bvh_and_bruteforce_space_first(space):
    pts, jpts = G.Points(torch.from_numpy(PTS)), JG.Points(jnp.asarray(PTS))
    preds, jpreds = _nearest(QS, 3)
    for cls, jcls in ((BVH, JBVH), (BruteForce, JBruteForce)):
        index, jindex = _run(lambda: cls(space, pts), lambda: jcls(None, jpts))
        assert index.device == CPU and index.size() == len(PTS)
        pol = POLICY.override(device=space) if cls is BVH else None
        got = index.query(preds, policy=pol)
        want = jindex.query(jpreds, policy=JPOLICY if cls is BVH else None)
        assert_knn_equal(got.distances, got.indices,
                         np.asarray(want.distances), np.asarray(want.indices))
        with pytest.raises(TypeError, match="positional"):
            cls(pts, G.Points, None)


def test_bvh_from_tree_space_first():
    pts, jpts = G.Points(torch.from_numpy(PTS)), JG.Points(jnp.asarray(PTS))
    built = BVH(pts, policy=ExecutionPolicy(device="cpu"))
    jbuilt = JBVH(jpts)
    index, jindex = _run(lambda: BVH.from_tree(CPU, pts, built.tree),
                         lambda: JBVH.from_tree(None, jpts, jbuilt.tree))
    assert index.tree is built.tree and index.device == CPU
    preds, jpreds = _nearest(QS, 3)
    got = index.query(preds, policy=POLICY)
    want = jindex.query(jpreds, policy=JPOLICY)
    assert_knn_equal(got.distances, got.indices,
                     np.asarray(want.distances), np.asarray(want.indices))


# ---------------------------------------------------------------------------
# stats built from keywords
# ---------------------------------------------------------------------------

def test_engine_stats_from_keywords():
    got, want = _run(lambda: EngineStats(cache_hits=3, jit_traces=2),
                     lambda: JEngineStats(cache_hits=3, jit_traces=2))
    assert got.snapshot() == type(got.snapshot())(3, 0, 2)
    assert (want.cache_hits, want.cache_misses, want.jit_traces) == (3, 0, 2)
    assert got.registry.counter("engine.cache_hits").value == 3
    with pytest.raises(TypeError, match="unexpected fields"):
        EngineStats(misses=1)


def test_pipeline_stats_from_keywords():
    got, want = _run(
        lambda: PipelineStats(served=4, max_queue_depth=7, refits=1),
        lambda: JPipelineStats(served=4, max_queue_depth=7, refits=1))
    fields = ("served", "max_queue_depth", "refits", "failed")
    assert [getattr(got, f) for f in fields] \
        == [getattr(want, f) for f in fields] == [4, 7, 1, 0]
    with pytest.raises(TypeError, match="unexpected fields"):
        PipelineStats(latency=1)


def test_assigning_max_queue_depth_only_extends_it():
    got, want = PipelineStats(), JPipelineStats()
    for stats, seen in ((got, IX._SEEN_DEPRECATIONS),
                        (want, JIX._SEEN_DEPRECATIONS)):
        _, first, second = _shim(
            lambda s=stats: [setattr(s, "max_queue_depth", 5),
                             setattr(s, "max_queue_depth", 2)], seen)
        assert len(first) == 1 and second == []
        assert stats.max_queue_depth == 5
    assert got.max_queue_depth == want.max_queue_depth


# ---------------------------------------------------------------------------
# DistributedTree's per-kind methods and ship_values_baseline
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def trees():
    """(port tree in a gloo group of one, reference tree on a mesh of
    one); the group is destroyed after the module."""
    from repro.compat import make_mesh
    from repro.core.distributed import DistributedTree as JDistributedTree
    from repro_torch.core.distributed import DistributedTree
    assert not dist.is_initialized()
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "gloo", init_method="file://" + os.path.join(tmp, "store"),
            rank=0, world_size=1, timeout=datetime.timedelta(seconds=60))
        try:
            yield (DistributedTree(None, torch.from_numpy(PTS),
                                   policy=ExecutionPolicy(device="cpu")),
                   JDistributedTree(make_mesh((1,), ("data",)), "data", PTS))
        finally:
            dist.destroy_process_group()


def test_distributed_query_knn(trees):
    tree, jtree = trees
    (d, i), (jd, ji) = _run(lambda: tree.query_knn(QS, 4),
                            lambda: jtree.query_knn(jnp.asarray(QS), 4))
    assert_knn_equal(d, i, np.asarray(jd), np.asarray(ji))
    now = tree.query(_nearest(QS, 4)[0])
    assert_knn_equal(d, i, now.distances, now.indices)


def test_distributed_query_radius_count(trees):
    tree, jtree = trees
    got, want = _run(lambda: tree.query_radius_count(QS, RADIUS),
                     lambda: jtree.query_radius_count(jnp.asarray(QS),
                                                      RADIUS))
    np.testing.assert_array_equal(np_of(got), np.asarray(want))
    np.testing.assert_array_equal(np_of(got),
                                  np_of(tree.count(_spheres(QS, RADIUS)[0])))


def test_distributed_query_ray_nearest(trees):
    tree, jtree = trees
    dirs = np.random.default_rng(2).normal(size=QS.shape).astype(np.float32)
    (t, i), (jt, ji) = _run(
        lambda: tree.query_ray_nearest(QS - dirs, dirs, 2),
        lambda: jtree.query_ray_nearest(jnp.asarray(QS - dirs),
                                        jnp.asarray(dirs), 2))
    np.testing.assert_array_equal(np_of(t).view(np.int32),
                                  np.asarray(jt).view(np.int32))
    assert_knn_equal(t, i, np.asarray(jt), np.asarray(ji))


def test_distributed_query_callback(trees):
    tree, jtree = trees
    cb, s0 = CB.counting()
    jcb, js0 = JCB.counting()
    got, want = _run(
        lambda: tree.query_callback(
            lambda q: P.intersects(G.Spheres(q, torch.full((len(q),),
                                                           RADIUS))),
            cb, s0, QS),
        lambda: jtree.query_callback(
            lambda q: JP.intersects(JG.Spheres(
                q, jnp.full((q.shape[0],), RADIUS, jnp.float32))),
            jcb, js0, jnp.asarray(QS)))
    np.testing.assert_array_equal(np_of(got), np.asarray(want))


@pytest.mark.parametrize("alias", [False, True])
def test_ship_values_baseline(trees, alias):
    """The fixed-capacity baseline (and its alias
    ``query_values_to_origin``): (q, R, capacity, dim) coordinates, inf
    where no match, and (q, R) counts, as the reference's."""
    from repro.core.distributed import ship_values_baseline as jship
    from repro_torch.core.distributed import ship_values_baseline as ship
    tree, jtree = trees
    if alias:
        port = lambda: tree.query_values_to_origin(QS, RADIUS, 4)    # noqa: E731
        ref = lambda: jtree.query_values_to_origin(                  # noqa: E731
            jnp.asarray(QS), RADIUS, 4)
    else:
        port = lambda: ship(tree, QS, RADIUS, 4)                     # noqa: E731
        ref = lambda: jship(jtree, jnp.asarray(QS), RADIUS, 4)       # noqa: E731
    (vals, count), (jvals, jcount) = _run(port, ref)
    assert tuple(vals.shape) == (len(QS), 1, 4, 3)
    np.testing.assert_array_equal(np_of(count), np.asarray(jcount))
    np.testing.assert_array_equal(np_of(vals), np.asarray(jvals))
    from repro_torch.core.distributed import DistributedTree
    boxes = G.Boxes(torch.from_numpy(PTS), torch.from_numpy(PTS))
    with pytest.raises(TypeError, match="Points"), warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        ship(DistributedTree(None, boxes,
                             policy=ExecutionPolicy(device="cpu")),
             QS, RADIUS, 4)
