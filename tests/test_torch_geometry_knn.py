"""``Nearest`` over Spheres, Triangles, Segments, Tetrahedra and KDOPs
values against the JAX reference on the CPU: the fine kNN kernel's twin
(``core.traversal.knn_walk``) through ``BVH.query`` and the serving
stack's cached entry, bit for bit against the reference's compiled walk,
ties and (inf, -1) padding included, and the routes. Scenes and helpers
are ``test_torch_geometry_query``'s; the kernel on the card is held there.
"""
import pytest

from test_torch_geometry_query import (  # noqa: F401
    CPU, KNN_KINDS, N, Q, _jax_loop, _kernel_engine, _policy,
    assert_states, both, jx, np_of, one_torch_thread, query_arrays, scene,
    value_arrays)
from repro_torch import BVH, EngineConfig, QueryEngine, convert
from repro_torch.core import callbacks as CB
from repro_torch.core import engine as TE
from repro_torch.core import geometry as TG
from repro_torch.core import predicates as TP
from repro_torch.core import traversal as TT
from repro_torch.kernels import bvh_traverse as BT


# ---------------------------------------------------------------------------
# k nearest by fine distance
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vkind,dim,qkind", [
    (v, d, "points") for v, d in KNN_KINDS] + [
    ("triangles", 3, q) for q in ("spheres", "boxes", "triangles")])
def test_knn_matches_reference_walk(vkind, dim, qkind):
    """``BVH.query(nearest(...))`` through the fine kNN kernel's twin
    against the reference's compiled walk: dists and indices bit for bit,
    ties and (inf, -1) padding included (k = 1, 8, and k > N)."""
    j = jx()
    varr, qarr = scene(vkind, dim, N, qkind)
    (jv, tv), (jq, tq) = both(vkind, varr), both(qkind, qarr)
    engine = _kernel_engine()
    index = BVH(tv, policy=_policy(engine))
    jindex = j["BVH"](jv, engine=_jax_loop())
    for k in (1, 8):
        pred = TP.nearest(tq, k)
        assert engine.route_knn(index, pred) == TE.ROUTE_KERNEL
        calls = TT.knn_walk.calls
        got = index._knn_impl(pred, index.policy)
        assert TT.knn_walk.calls == calls + 1     # the twin is the walk
        want = jindex._knn_impl(j["P"].nearest(jq, k), jindex.policy)
        assert_states(want, got)
    small = value_arrays(vkind, 5, dim)
    (jv, tv) = both(vkind, small)
    small_index = BVH(tv, policy=_policy(engine))
    got = small_index._knn_impl(TP.nearest(tq, 7), small_index.policy)
    jindex = j["BVH"](jv, engine=_jax_loop())
    assert_states(jindex._knn_impl(j["P"].nearest(jq, 7), jindex.policy),
                  got)
    assert (np_of(got[1])[:, 5:] == -1).all()


def test_knn_routes():
    """The fine kNN kernel takes Spheres, Triangles, Segments, Tetrahedra
    and KDOPs values under the default getter; force="loop", a custom
    getter and k above KNN_MAX_K take the loop walk; brute force only
    below the crossover."""
    varr = value_arrays("triangles", 300, 3)
    tv = convert.geometry_from_numpy("triangles", varr, CPU)
    tq = convert.geometry_from_numpy("points", query_arrays("points", 3, Q),
                                     CPU)
    engine = QueryEngine()
    index = BVH(tv, policy=_policy(engine))
    assert engine.route_knn(index, TP.nearest(tq, 3)) == TE.ROUTE_BRUTEFORCE
    big = BVH(convert.geometry_from_numpy(
        "triangles", value_arrays("triangles", 70_000, 3), CPU),
        policy=_policy(engine))
    many = convert.geometry_from_numpy("points",
                                       query_arrays("points", 3, 64), CPU)
    assert engine.route_knn(big, TP.nearest(many, 3)) == TE.ROUTE_KERNEL
    assert engine.route_knn(big, TP.nearest(many, BT.KNN_MAX_K + 1)) == \
        TE.ROUTE_LOOP
    loop = QueryEngine(EngineConfig(force="loop"))
    assert loop.route_knn(big, TP.nearest(many, 3)) == TE.ROUTE_LOOP
    custom = BVH(tv, lambda v: TG.to_boxes(v), policy=_policy(engine))
    assert _kernel_engine().route_knn(custom, TP.nearest(tq, 3)) == \
        TE.ROUTE_LOOP
    cb, _ = CB.counting()
    assert engine.route_callback(index, TP.intersects(tq), cb) == \
        TE.ROUTE_KERNEL
    assert engine.route_callback(custom, TP.intersects(tq), cb) == \
        TE.ROUTE_LOOP


def test_exec_knn_caches_the_fine_kernel_entry():
    """The serving stack's cached kNN entry takes the fine kNN kernel."""
    varr = value_arrays("segments", 400, 3)
    tv = convert.geometry_from_numpy("segments", varr, CPU)
    tq = convert.geometry_from_numpy("points", query_arrays("points", 3, Q),
                                     CPU)
    engine = _kernel_engine()
    index = BVH(tv, policy=_policy(engine))
    (d1, i1), info1 = engine.exec_knn(index, TP.nearest(tq, 4))
    (d2, i2), info2 = engine.exec_knn(index, TP.nearest(tq, 4))
    assert info1.route == TE.ROUTE_KERNEL and not info1.cache_hit
    assert info2.cache_hit
    assert_states((d1, i1), index._knn_impl(TP.nearest(tq, 4), index.policy))
    assert_states((d1, i1), (d2, i2))


