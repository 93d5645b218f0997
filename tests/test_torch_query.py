"""PyTorch port vs the JAX package end to end: ``BVH(...).query()`` and
``BruteForce`` on the same seeded values and predicates (CPU; the port's
kernels run as their plain twins). CSR offsets equal and index sets equal
per query (the fill order depends on the route); kNN equal up to ties."""
import jax
import numpy as np
import pytest
import torch

from test_torch_parity import (CPU, ROUTE_MAP, assert_csr_equal_sets,  # noqa: F401
                           assert_knn_equal, cloud, geoms, np_of,
                           one_torch_thread)
from repro.core import BVH as JBVH
from repro.core import BruteForce as JBF
from repro.core import geometry as JG
from repro.core import predicates as JP
from repro.core.engine import EngineConfig as JEngineConfig
from repro.core.engine import QueryEngine as JQueryEngine
from repro_torch import BVH, BruteForce, EngineConfig, ExecutionPolicy, QueryEngine
from repro_torch.core import engine as TE
from repro_torch.core import geometry as TG
from repro_torch.core import predicates as TP

N, Q, DIM = 600, 48, 3


def _values(kind, n=N, dim=DIM, seed=0):
    lo = cloud(n, dim, "uniform", seed=seed)
    if kind == "points":
        return geoms("points", [lo])
    hi = lo + np.random.default_rng(seed + 1).uniform(0.01, 0.08, lo.shape)
    return geoms("boxes", [lo, hi])


def _predicate_geoms(kind, q=Q, dim=DIM, seed=9):
    c = cloud(q, dim, "uniform", seed=seed)
    if kind == "points":
        return geoms("points", [c])
    if kind == "boxes":
        return geoms("boxes", [c, c + np.float32(0.12)])
    return geoms("spheres", [c, np.full((q,), 0.1, np.float32)])


def _policy(route):
    return ExecutionPolicy(device=CPU,
                           engine=QueryEngine(EngineConfig(force=route)))


def _jax_engine(route):
    return JQueryEngine(JEngineConfig(force=ROUTE_MAP[route]))


@pytest.mark.parametrize("route", ["kernel", "bruteforce"])
@pytest.mark.parametrize("qkind", ["points", "boxes", "spheres"])
@pytest.mark.parametrize("vkind", ["points", "boxes"])
def test_bvh_csr_query_matches_reference(vkind, qkind, route):
    jv, tv = _values(vkind)
    jg, tg = _predicate_geoms(qkind)
    if qkind == "points" and vkind == "points":       # hit exact points
        jg, tg = geoms("points", [np.asarray(jv.coords)[::13]])
    jres = JBVH(jv, engine=_jax_engine(route)).query(JP.intersects(jg))
    index = BVH(tv, policy=_policy(route))
    assert index.size() == N and index.device == torch.device("cpu")
    assert index.policy.resolve_engine().route_spatial(
        index, TP.intersects(tg)) == route
    tres = index.query(TP.intersects(tg))
    assert_csr_equal_sets(tres.offsets, tres.indices, jres.offsets, jres.indices)
    assert not tres.overflow and tres.offsets.dtype == torch.int32
    # values gathered at the matched indices
    vals = tres.values.coords if vkind == "points" else tres.values.lo
    src = tv.coords if vkind == "points" else tv.lo
    assert torch.equal(vals, src[tres.indices.long()])
    np.testing.assert_array_equal(np_of(index.count(TP.intersects(tg))),
                                  np.diff(np_of(tres.offsets)))


@pytest.mark.parametrize("route", ["kernel", "bruteforce"])
@pytest.mark.parametrize("vkind", ["points", "boxes"])
@pytest.mark.parametrize("k", [1, 6])
def test_bvh_knn_query_matches_reference(k, vkind, route):
    """Kernel route: distances bit-identical to the reference's (same sum
    order, exact sqrt). Brute force over Points uses the matrix expansion
    |x|^2 - 2x.y + |y|^2, whose product runs in another order than XLA's:
    there distances agree to 1e-6 absolute (coordinates in [0, 1])."""
    jv, tv = _values(vkind, seed=3)
    jg, tg = _predicate_geoms("points", seed=4)
    jres = JBVH(jv, engine=_jax_engine(route)).query(JP.nearest(jg, k=k))
    tres = BVH(tv, policy=_policy(route)).query(TP.nearest(tg, k=k))
    expansion = route == "bruteforce" and vkind == "points"
    assert_knn_equal(tres.distances, tres.indices, jres.distances,
                     jres.indices, atol=1e-6 if expansion else 0.0)
    assert tres.values is not None and tres.indices.shape == (Q, k)


def test_knn_query_sphere_and_box_predicates_use_centroids():
    jv, tv = _values("points", seed=5)
    for kind in ("boxes", "spheres"):
        jg, tg = _predicate_geoms(kind, seed=6)
        jres = JBVH(jv, engine=_jax_engine("kernel")).query(JP.nearest(jg, k=4))
        tres = BVH(tv, policy=_policy("kernel")).query(TP.nearest(tg, k=4))
        assert_knn_equal(tres.distances, tres.indices, jres.distances,
                         jres.indices)


@pytest.mark.parametrize("vkind", ["points", "boxes"])
def test_bruteforce_index_matches_reference(vkind):
    jv, tv = _values(vkind, n=300, seed=7)
    jg, tg = _predicate_geoms("spheres", q=40, seed=8)
    jb, tb = JBF(jv), BruteForce(tv, policy=ExecutionPolicy(device=CPU))
    jr, tr = jb.query(JP.intersects(jg)), tb.query(TP.intersects(tg))
    assert_csr_equal_sets(tr.offsets, tr.indices, jr.offsets, jr.indices)
    # BruteForce fills in index order on both sides: the flat CSR is equal
    np.testing.assert_array_equal(np_of(tr.indices), np.asarray(jr.indices))
    jk, tk = jb.query(JP.nearest(jg, k=5)), tb.query(TP.nearest(tg, k=5))
    assert_knn_equal(tk.distances, tk.indices, jk.distances, jk.indices,
                     atol=1e-6 if vkind == "points" else 0.0)


@pytest.mark.parametrize("max_doublings", [0, 6])
def test_capacity_overflow_matches_reference(max_doublings):
    jv, tv = _values("points", seed=11)
    jg, tg = _predicate_geoms("spheres", seed=12)
    from repro.core import ExecutionPolicy as JPolicy
    jres = JBVH(jv, engine=_jax_engine("kernel"),
                policy=JPolicy(max_doublings=max_doublings)).query(
                    JP.intersects(jg), capacity=2)
    pol = ExecutionPolicy(device=CPU, max_doublings=max_doublings,
                          engine=QueryEngine(EngineConfig(force="kernel")))
    tres = BVH(tv, policy=pol).query(TP.intersects(tg), capacity=2)
    assert tres.overflow == jres.overflow == (max_doublings == 0)
    np.testing.assert_array_equal(np_of(tres.offsets), np.asarray(jres.offsets))
    if max_doublings:
        assert_csr_equal_sets(tres.offsets, tres.indices, jres.offsets,
                              jres.indices)


@pytest.mark.parametrize("n", [0, 1])
@pytest.mark.parametrize("vkind", ["points", "boxes"])
def test_degenerate_sizes_match_reference(n, vkind):
    jv, tv = _values(vkind, n=max(n, 1), seed=13)
    if n == 0:
        jv = type(jv)(*(a[:0] for a in jv.__dict__.values()))
        tv = type(tv)(*(a[:0] for a in tv.__dict__.values()))
    jg, tg = _predicate_geoms("spheres", q=16, seed=14)
    jb, tb = JBVH(jv), BVH(tv, policy=ExecutionPolicy(device=CPU))
    assert tb.tree is None and tb.size() == n
    jr, tr = jb.query(JP.intersects(jg)), tb.query(TP.intersects(tg))
    assert_csr_equal_sets(tr.offsets, tr.indices, jr.offsets, jr.indices)
    jk = jb.query(JP.nearest(JG.Points(jg.center), k=3))
    tk = tb.query(TP.nearest(TG.Points(tg.center), k=3))
    assert_knn_equal(tk.distances, tk.indices, jk.distances, jk.indices)


def test_empty_predicate_batch():
    _, tv = _values("points")
    index = BVH(tv, policy=_policy("kernel"))
    z = TG.Points(torch.zeros((0, DIM)))
    r = index.query(TP.intersects(z))
    assert r.offsets.tolist() == [0] and r.indices.numel() == 0
    k = index.query(TP.nearest(z, k=2))
    assert k.indices.shape == (0, 2)


@pytest.mark.parametrize("vkind", ["points", "boxes", "spheres"])
@pytest.mark.parametrize("qkind", ["points", "boxes", "spheres"])
def test_leaf_tests_match_reference(qkind, vkind):
    """The fine tests brute force runs: predicate x value kinds."""
    rng = np.random.default_rng(15)
    c = rng.uniform(0, 1, (40, 3)).astype(np.float32)
    arrays = {"points": [c], "boxes": [c, c + np.float32(0.2)],
              "spheres": [c, rng.uniform(0.05, 0.2, 40).astype(np.float32)]}
    jv, tv = geoms(vkind, arrays[vkind])
    qc = rng.uniform(0, 1, (7, 3)).astype(np.float32)
    qarr = {"points": [qc], "boxes": [qc, qc + np.float32(0.3)],
            "spheres": [qc, np.full((7,), 0.25, np.float32)]}
    jg, tg = geoms(qkind, qarr[qkind])
    want_m = jax.vmap(lambda p: JP.leaf_match_test(p, jv))(JP.intersects(jg))
    want_d = jax.vmap(lambda p: JP.leaf_distance(p, jv))(JP.nearest(jg))
    got_m = TP.leaf_match_test(TP.lift(TP.intersects(tg)), tv)
    got_d = TP.leaf_distance(TP.lift(TP.nearest(tg)), tv)
    np.testing.assert_array_equal(np.asarray(want_m), np_of(got_m))
    np.testing.assert_array_equal(np.asarray(want_d), np_of(got_d))


def test_routes_follow_the_route_table():
    _, tv = _values("points")
    index = BVH(tv, policy=ExecutionPolicy(device=CPU))
    eng = QueryEngine()
    small = TP.intersects(TG.Points(torch.zeros((4, DIM))))
    assert eng.route_spatial(index, small) == TE.ROUTE_BRUTEFORCE
    big = TP.intersects(TG.Points(torch.zeros((8000, DIM))))
    assert eng.route_spatial(index, big) == TE.ROUTE_KERNEL
    assert eng.route_knn(index, TP.nearest(TG.Points(torch.zeros((8000, DIM))),
                                           k=300)) == TE.ROUTE_LOOP
    sv = TG.Spheres(torch.rand((600, DIM)), torch.full((600,), 0.1))
    sphere_index = BVH(sv, policy=ExecutionPolicy(device=CPU))
    assert eng.route_spatial(sphere_index, big) == TE.ROUTE_LOOP
    on_centres = TP.intersects(TG.Points(sv.center.repeat(14, 1)[:8000]))
    res = sphere_index.query(on_centres)     # the loop route answers it
    want = BruteForce(sv, policy=ExecutionPolicy(device=CPU)).count(on_centres)
    assert torch.equal(res.offsets.diff(), want) and bool((want >= 1).all())
    with pytest.raises(ValueError):
        EngineConfig(force="pallas")


def test_values_above_the_kernel_dim_cap_take_the_loop_route():
    """More dimensions than the kernels take: brute force below the
    threshold, the loop route above it, never the kernels."""
    from repro_torch.kernels.bvh_traverse import MAX_DIM
    dim = MAX_DIM + 1
    index = BVH(TG.Points(torch.rand((600, dim))),
                policy=ExecutionPolicy(device=CPU))
    eng = QueryEngine()
    small = torch.rand((4, dim))
    assert eng.route_spatial(index, TP.intersects(TG.Points(small))) == \
        TE.ROUTE_BRUTEFORCE
    assert eng.route_knn(index, TP.nearest(TG.Points(small), k=2)) == \
        TE.ROUTE_BRUTEFORCE
    assert index.query(TP.nearest(TG.Points(small), k=2)).indices.shape == (4, 2)
    big = torch.zeros((8000, dim))
    big[:3] = index.values.coords[:3]
    assert eng.route_spatial(index, TP.intersects(TG.Points(big))) == \
        TE.ROUTE_LOOP
    res = index.query(TP.intersects(TG.Points(big)))
    assert res.indices[:3].tolist() == [0, 1, 2] and int(res.offsets[-1]) == 3
    assert eng.route_knn(index, TP.nearest(TG.Points(big), k=2)) == \
        TE.ROUTE_LOOP
    knn = index.query(TP.nearest(TG.Points(big[:3]), k=2),
                      policy=ExecutionPolicy(device=CPU, engine=QueryEngine(
                          EngineConfig(force="loop"))))
    assert knn.indices[:, 0].tolist() == [0, 1, 2]
