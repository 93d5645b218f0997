"""BruteForce over the remaining geometries against the JAX reference
on the CPU: the match matrix and the fine distances op by op (the
"eager" order of ``geometry.ORDERS``), the callbacks in the brute-force
loop's ("loop") order, and the linear scans of a BVH of N in {0, 1} with
the smallest tree, N = 2. Scenes and helpers are
``test_torch_geometry_query``'s.
"""
import pytest

from test_torch_geometry_query import (  # noqa: F401
    KNN_KINDS, N, SCENES, VALUE_KINDS, _factories, _jax_loop,
    _kernel_engine, _policy, assert_csr_sets, assert_states, both, jx,
    one_torch_thread, scene)
from repro_torch import BVH, BruteForce
from repro_torch.core import predicates as TP


@pytest.mark.parametrize("n", [0, 1, 2])
@pytest.mark.parametrize("vkind,dim", VALUE_KINDS)
def test_small_indexes_match_reference(vkind, dim, n):
    """N in {0, 1} (the linear scans, op by op) and 2 (the smallest
    tree): CSR sets and kNN lists, padding included, for sphere
    queries."""
    j = jx()
    for qkind in ("spheres",):
        varr, qarr = scene(vkind, dim, n, qkind)
        (jv, tv), (jq, tq) = both(vkind, varr), both(qkind, qarr)
        index = BVH(tv, policy=_policy(_kernel_engine()))
        jindex = j["BVH"](jv, engine=_jax_loop())
        assert_csr_sets(jindex.query(j["P"].intersects(jq)),
                        index.query(TP.intersects(tq)))
        for k in (3,):
            want = jindex._knn_impl(j["P"].nearest(jq, k), jindex.policy)
            got = index._knn_impl(TP.nearest(tq, k), index.policy)
            assert_states(want, got)


@pytest.mark.parametrize("vkind,dim,qkind", SCENES)
def test_bruteforce_intersects_matches_reference(vkind, dim, qkind):
    """BruteForce's match matrix (op by op, the "eager" order) against
    the reference's, on the boundary queries of points and spheres and on
    generic boxes and shapes."""
    j = jx()
    for boundary in (qkind in ("points", "spheres"),):
        varr, qarr = scene(vkind, dim, N, qkind, boundary)
        (jv, tv), (jq, tq) = both(vkind, varr), both(qkind, qarr)
        assert_csr_sets(j["BF"](jv).query(j["P"].intersects(jq)),
                        BruteForce(tv, policy=_policy()).query(
                            TP.intersects(tq)))


@pytest.mark.parametrize("vkind,dim", [("segments", 3), ("segments", 2),
                                       ("triangles", 3), ("tetrahedra", 3)])
def test_bruteforce_callbacks_take_the_loop_order(vkind, dim):
    """BruteForce callbacks (the reference's compiled ``fori_loop``, the
    "loop" order, where a segment's dot products fuse): collect_hits and
    counting states bit-identical on the boundary scenes."""
    j = jx()
    qkind = "points" if vkind == "tetrahedra" else "spheres"
    varr, qarr = scene(vkind, dim, N, qkind, True)
    (jv, tv), (jq, tq) = both(vkind, varr), both(qkind, qarr)
    for name in ("counting", "collect_hits"):
        (jcb, js0), (tcb, ts0) = _factories(name)
        assert_states(j["BF"](jv).query(j["P"].intersects(jq),
                                        callback=(jcb, js0)),
                      BruteForce(tv, policy=_policy()).query(
                          TP.intersects(tq), callback=(tcb, ts0)))


@pytest.mark.parametrize("vkind,dim", KNN_KINDS)
def test_bruteforce_knn_matches_reference(vkind, dim):
    """BruteForce's fine distances (op by op) and their order."""
    j = jx()
    varr, qarr = scene(vkind, dim, N, "points")
    (jv, tv), (jq, tq) = both(vkind, varr), both("points", qarr)
    jb = j["BF"](jv)
    assert_states(jb._knn_impl(j["P"].nearest(jq, 6), jb.policy),
                  BruteForce(tv, policy=_policy())._knn_impl(
                      TP.nearest(tq, 6), _policy()))


