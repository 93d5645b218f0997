"""The remaining geometries of the port (Segments, Tetrahedra, KDOPs, and
Triangles' spatial tests) against ``repro.core.geometry`` on the CPU.

Bounding boxes, centroids and k-DOP directions are compared bit for bit,
signed zeros included: XLA's minimum and maximum order -0 below +0,
which ``torch.minimum`` does not. The point tests (distance to a segment
or a triangle, point in a triangle or a tetrahedron) are compared bit for
bit in each of the reference's float contexts (``geometry.ORDERS``): op
by op (its brute force, here called eagerly), its jitted k-nearest walk
and spatial walk (read through ``traverse_knn``'s distances and through a
counting walk over values far apart, one value a query), and its
brute-force callback loop. The scenes sit on the boundaries where the
orders part: points a hair off an edge or a face, and sphere radii equal
to the distance in the order under test, so that a wrong order changes
the answer; each test also shows that another order would change it.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import BruteForce as JBF
from repro.core import callbacks as JCB
from repro.core import geometry as JG
from repro.core import lbvh as JL
from repro.core import predicates as JP
from repro.core import traversal as JT
from repro.core.index import _bcast_state as jbcast
from repro_torch.core import access as TA
from repro_torch.core import geometry as TG
from repro_torch.core import predicates as TP

NV, PER = 16, 256          # values far apart, queries per value


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One CPU thread per pytest worker."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def T(*arrays):
    return [torch.from_numpy(np.array(a, np.float32)) for a in arrays]


def _bits_equal(want, got):
    want, got = np.asarray(want), got.numpy()
    assert want.dtype == got.dtype and want.shape == got.shape
    np.testing.assert_array_equal(want.view(np.uint8), got.view(np.uint8))


# ---------------------------------------------------------------------------
# directions, boxes and centroids
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dim,k", [(2, 4), (2, 8), (3, 6), (3, 14), (3, 18),
                                   (3, 26)])
def test_kdop_directions(dim, k):
    _bits_equal(JG.kdop_directions(dim, k), TG.kdop_directions(dim, k))


@pytest.mark.parametrize("dim,k", [(2, 6), (3, 8), (4, 8), (1, 2)])
def test_kdop_directions_refuse_what_the_reference_refuses(dim, k):
    with pytest.raises(ValueError):
        JG.kdop_directions(dim, k)
    with pytest.raises(ValueError):
        TG.kdop_directions(dim, k)


def _shapes(dim, n=200, seed=0):
    """{kind: arrays} of every geometry in `dim` dimensions."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1, 1, (n, dim)).astype(np.float32)
    e = [(a + rng.uniform(-0.2, 0.2, (n, dim))).astype(np.float32)
         for _ in range(3)]
    out = {"points": [a], "boxes": [a, a + np.abs(e[0])],
           "spheres": [a, rng.uniform(0, 0.3, n).astype(np.float32)],
           "triangles": [a, e[0], e[1]], "segments": [a, e[0]]}
    if dim == 3:
        out["tetrahedra"] = [a, e[0], e[1], e[2]]
    if dim in (2, 3):
        dirs = np.asarray(JG.kdop_directions(dim, 8 if dim == 2 else 26))
        sup = np.stack([a, e[0], e[1]], 1) @ dirs.T
        out["kdops"] = [sup.min(1), sup.max(1), dirs]
    return out


_JCLS = {"points": JG.Points, "boxes": JG.Boxes, "spheres": JG.Spheres,
         "triangles": JG.Triangles, "segments": JG.Segments,
         "tetrahedra": JG.Tetrahedra, "kdops": JG.KDOPs}
_TCLS = {"points": TG.Points, "boxes": TG.Boxes, "spheres": TG.Spheres,
         "triangles": TG.Triangles, "segments": TG.Segments,
         "tetrahedra": TG.Tetrahedra, "kdops": TG.KDOPs}


@pytest.mark.parametrize("dim", [2, 3, 5])
def test_to_boxes_and_centroid_of_every_kind(dim):
    for kind, arrays in _shapes(dim).items():
        jg = _JCLS[kind](*(jnp.asarray(a) for a in arrays))
        tg = _TCLS[kind](*T(*arrays))
        jb, tb = JG.to_boxes(jg), TG.to_boxes(tg)
        _bits_equal(jb.lo, tb.lo)
        _bits_equal(jb.hi, tb.hi)
        _bits_equal(JG.centroid(jg), TG.centroid(tg))


@pytest.mark.parametrize("kind", ["triangles", "segments", "tetrahedra"])
def test_to_boxes_orders_signed_zeros_as_the_reference(kind):
    """Every combination of +0 and -0 over the vertices: lo takes -0 when
    any vertex has it, hi +0 (XLA's reduction), NaN propagates (by
    place: its sign bit carries nothing)."""
    verts = {"triangles": 3, "segments": 2, "tetrahedra": 4}[kind]
    combos = np.array(np.meshgrid(*[[0.0, -0.0]] * verts)).reshape(verts, -1)
    m = combos.shape[1]
    arrays = [np.stack([c, np.full(m, 1.0), np.where(np.arange(m) == 0,
                                                     np.nan, 0.5)], 1)
              .astype(np.float32) for c in combos]
    jg = _JCLS[kind](*(jnp.asarray(a) for a in arrays))
    tg = _TCLS[kind](*T(*arrays))
    for side in ("lo", "hi"):
        want = np.asarray(getattr(JG.to_boxes(jg), side))
        got = getattr(TG.to_boxes(tg), side).numpy()
        np.testing.assert_array_equal(np.isnan(want), np.isnan(got))
        num = ~np.isnan(want)
        np.testing.assert_array_equal(np.signbit(want[num]),
                                      np.signbit(got[num]))
    assert np.signbit(TG.to_boxes(tg).lo[:, 0].numpy()).sum() == m - 1


def test_min_max_zeros():
    a = torch.tensor([0.0, -0.0, 0.0, -0.0, float("nan"), 1.0])
    b = torch.tensor([-0.0, 0.0, 0.0, -0.0, 1.0, float("nan")])
    for x, y in ((a, b), (b, a)):
        lo, hi = TG.min_zeros(x, y), TG.max_zeros(x, y)
        assert torch.signbit(lo[:4]).tolist() == [True, True, False, True]
        assert torch.signbit(hi[:4]).tolist() == [False, False, False, True]
        assert torch.isnan(lo[4:]).all() and torch.isnan(hi[4:]).all()


def test_kdops_index_and_to_keep_the_directions():
    arrays = _shapes(3)["kdops"]
    g = TG.KDOPs(*T(*arrays))
    sub = g.index(torch.tensor([3, 1]))
    assert sub.lo.shape == (2, 13) and sub.directions.shape == (13, 3)
    assert TA.value_at(g, torch.tensor([0])).directions is g.directions
    assert TA.as_geometry(g) is g and len(g) == 200 and g.dim == 3
    assert g.to("cpu").directions.shape == (13, 3)


@pytest.mark.parametrize("seed", range(10))
def test_kdop_contains_box(seed):
    """The reference's property: a k-DOP of a point set contains the
    set's axis-aligned box."""
    r = np.random.default_rng(seed)
    pts = r.uniform(-1, 1, (16, 3)).astype(np.float32)
    dirs = TG.kdop_directions(3, 14)
    support = pts @ dirs.numpy().T
    kd = TG.KDOPs(*T(support.min(0, keepdims=True),
                     support.max(0, keepdims=True)), dirs)
    bb = TG.to_boxes(kd)
    assert np.all(bb.lo.numpy() <= pts.min(0) + 1e-6)
    assert np.all(bb.hi.numpy() >= pts.max(0) - 1e-6)


def test_point_in_tetrahedron_inside_outside():
    a, b, c, d = ([0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1])
    for order in TG.ORDERS:
        inside = TG.point_in_tetrahedron(*T([[0.1, 0.1, 0.1]], [a], [b], [c],
                                            [d]), order)
        outside = TG.point_in_tetrahedron(*T([[0.9, 0.9, 0.9]], [a], [b],
                                             [c], [d]), order)
        assert bool(inside[0]) and not bool(outside[0])


@pytest.mark.parametrize("order", TG.ORDERS)
def test_distance_point_triangle_matches_sampling(order):
    """The reference's dense barycentric sampling oracle."""
    rng = np.random.default_rng(0)
    a, b, c, p = (rng.uniform(0, 1, (20, 3)).astype(np.float32)
                  for _ in range(4))
    d = TG.distance_point_triangle(*T(p, a, b, c), order).numpy()
    u = np.linspace(0, 1, 60)
    uu, vv = np.meshgrid(u, u)
    m = uu + vv <= 1
    uu, vv = uu[m], vv[m]
    pts = (a[:, None] + uu[None, :, None] * (b - a)[:, None]
           + vv[None, :, None] * (c - a)[:, None])
    dmin = np.linalg.norm(pts - p[:, None], axis=-1).min(1)
    assert np.all(d <= dmin + 1e-4)
    assert np.allclose(d, dmin, atol=2e-2)


def test_orders_are_checked():
    p = T(np.zeros((1, 3)))[0]
    with pytest.raises(ValueError, match="order"):
        TG.distance_point_segment(p, p, p, "fast")


# ---------------------------------------------------------------------------
# the point tests in each of the reference's float contexts
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def far_scene(kind, dim, seed=0):
    """NV values 10 apart, PER queries around each (value j for query
    j // PER): points near a triangle's plane and edges, near a segment,
    or a hair off a tetrahedron's face (the -1e-9 slack of its test)."""
    r = np.random.default_rng(seed)
    grid = np.arange(NV)[:, None] * 10.0 * np.ones(dim)
    a = grid + r.uniform(0, 1, (NV, dim))
    side = 0.4 if kind == "tetrahedra" else 0.1
    verts = [a] + [a + r.uniform(-side, side, (NV, dim))
                   for _ in range({"segments": 1, "triangles": 2,
                                   "tetrahedra": 3}[kind])]
    verts = [v.astype(np.float32) for v in verts]
    j = np.repeat(np.arange(NV), PER)
    q = len(j)
    V = [v[j].astype(np.float64) for v in verts]
    if kind == "segments":
        t = r.uniform(-0.2, 1.2, q)[:, None]
        p = V[0] + t * (V[1] - V[0]) + r.normal(0, 0.02, (q, dim))
    elif kind == "triangles":
        w = r.dirichlet([1, 1, 1], q)
        w[np.arange(q), r.integers(0, 3, q)] = r.normal(0, 2e-7, q)
        w[1::2] += r.normal(0, 0.05, (q // 2, 3))
        w /= w.sum(1, keepdims=True)
        p = sum(w[:, i:i + 1] * V[i] for i in range(3))
        p[1::4] += r.normal(0, 0.02, (q // 4, dim))
    else:
        f = r.integers(0, 4, q)
        W = np.stack(V, 1)
        idx = np.stack([(f + i) % 4 for i in range(4)], 1)
        W = np.take_along_axis(W, idx[:, :, None], 1)
        n = np.cross(W[:, 1] - W[:, 0], W[:, 2] - W[:, 0])
        s3 = (n * (W[:, 3] - W[:, 0])).sum(1)
        bw = r.dirichlet([1, 1, 1], q)
        onf = sum(bw[:, i:i + 1] * W[:, i] for i in range(3))
        tgt = -1e-9 * (1 + r.normal(0, 0.3, q))
        p = onf + (tgt / s3 / (n * n).sum(1))[:, None] * n
    return verts, p.astype(np.float32), j


def _jtree(kind, verts):
    jv = _JCLS[kind](*(jnp.asarray(v) for v in verts))
    return jv, JL.build(JG.to_boxes(jv))


def _port_distance(kind, p, vs, order):
    fn = (TG.distance_point_segment if kind == "segments"
          else TG.distance_point_triangle)
    return fn(*T(p, *vs), order).numpy()


@pytest.mark.parametrize("kind,dim", [("segments", 3), ("segments", 2),
                                      ("triangles", 3), ("triangles", 2)])
def test_distances_eager(kind, dim):
    """Op by op: the reference's brute force order."""
    verts, p, j = far_scene(kind, dim)
    vs = [v[j] for v in verts]
    fn = (JG.distance_point_segment if kind == "segments"
          else JG.distance_point_triangle)
    want = np.asarray(fn(p, *vs))
    np.testing.assert_array_equal(want, _port_distance(kind, p, vs, "eager"))
    assert (want != _port_distance(kind, p, vs, "walk")).sum() > 20


@pytest.mark.parametrize("kind,dim", [("segments", 3), ("segments", 2),
                                      ("triangles", 3), ("triangles", 2)])
def test_distances_in_the_knn_walk(kind, dim):
    """The reference's jitted k-nearest walk with k = N: every value's
    distance from every query, in the "walk" order."""
    verts, p, _ = far_scene(kind, dim)
    jv, jtree = _jtree(kind, verts)
    d, i = map(np.asarray, JT.traverse_knn(
        jtree, jv, JP.nearest(JG.Points(jnp.asarray(p)), NV), NV))
    want = np.take_along_axis(d, np.argsort(i, 1), 1)
    q = len(p)
    for order, same in (("walk", True), ("eager", False)):
        got = np.stack([_port_distance(kind, p, [v[np.full(q, m)]
                                                 for v in verts], order)
                        for m in range(NV)], 1)
        assert np.array_equal(want, got) == same, order


def _radius_scene(kind, dim, order):
    """Sphere queries whose radius is the distance to their value in
    `order`, once as is and once one ulp below: the walk matches the
    first and not the second exactly when its distance is the same."""
    verts, p, j = far_scene(kind, dim)
    d = _port_distance(kind, p, [v[j] for v in verts], order)
    r = np.concatenate([d, np.nextafter(d, np.float32(-np.inf))])
    keep = d > 1e-30            # a -denormal radius reads as -0 in XLA
    return verts, np.concatenate([p, p]), r, keep


def _count_walk(jv, jtree, preds):
    cb, s0 = JCB.counting()
    return np.asarray(JT.traverse(jtree, jv, preds, cb,
                                  jbcast(s0, len(preds))))


def _count_loop(jv, jtree, preds):
    cb, s0 = JCB.counting()
    return np.asarray(JBF(jv).query(preds, callback=(cb, s0)))


@pytest.mark.parametrize("context", ["walk", "loop"])
@pytest.mark.parametrize("kind,dim", [("segments", 3), ("segments", 2),
                                      ("triangles", 3), ("triangles", 2)])
def test_distances_in_the_spatial_walk_and_loop(kind, dim, context):
    """Spheres over segments and triangles in the reference's jitted
    walk (its callback kernel compiles alike: see
    test_torch_geometry_query) and its brute-force callback loop: the
    port's order for the context gives radii the reference matches
    exactly at the distance and not one ulp below."""
    count = {"walk": _count_walk, "loop": _count_loop}[context]
    verts, p, j = far_scene(kind, dim)
    jv, jtree = _jtree(kind, verts)
    q = len(p)
    lo, hi = (f.reduce([v[j] for v in verts]) for f in (np.minimum,
                                                          np.maximum))
    misses = {}
    for order in ("walk", "loop"):
        _, pp, r, keep = _radius_scene(kind, dim, order)
        cnt = count(jv, jtree, JP.intersects(JG.Spheres(jnp.asarray(pp),
                                                        jnp.asarray(r))))
        exact = (cnt[:q] == 1) & (cnt[q:] == 0)
        # the walk's node test prunes a leaf whose box the sphere of the
        # lower radius misses
        gap = np.maximum(np.maximum(lo - p, p - hi), 0)
        box = TG.sum_sq_fused(torch.from_numpy(gap)).numpy()
        rp = r[q:]
        valid = keep & ((box <= rp * rp) if context == "walk" else True)
        misses[order] = int((~exact & valid).sum())
    assert misses[context] == 0
    if kind == "segments":
        assert misses["walk" if context == "loop" else "loop"] > 0


@pytest.mark.parametrize("context", ["walk", "loop", "eager"])
@pytest.mark.parametrize("kind,dim", [("triangles", 3), ("triangles", 2),
                                      ("tetrahedra", 3)])
def test_point_tests_in_every_context(kind, dim, context):
    """Points over triangles (the projection test with its 1e-7 slack) and
    tetrahedra (the -1e-9 product slack), one value a query, in the
    reference's walk, brute-force callback loop and brute force: the
    port's order for the context agrees on every query whose point lies
    in the value's box (the walk prunes the others)."""
    verts, p, j = far_scene(kind, dim)
    jv, jtree = _jtree(kind, verts)
    pred = JP.intersects(JG.Points(jnp.asarray(p)))
    if context == "walk":
        want = _count_walk(jv, jtree, pred)
    elif context == "loop":
        want = _count_loop(jv, jtree, pred)
    else:
        want = np.asarray(JBF(jv).count(pred))
    fn = (TG.point_in_triangle if kind == "triangles"
          else TG.point_in_tetrahedron)
    vs = [v[j] for v in verts]
    got = fn(*T(p, *vs), context).numpy()
    lo, hi = (f.reduce(vs) for f in (np.minimum, np.maximum))
    inbox = np.all((lo <= p) & (p <= hi), 1) | (context != "walk")
    np.testing.assert_array_equal(want[inbox], got[inbox].astype(np.int32))
    assert 0.2 < want[inbox].mean() < 0.8


def test_point_in_triangle_orders_differ():
    """The three orders of point_in_triangle are not interchangeable on
    the edge scenes (each of the tests above would see a swap)."""
    for dim in (2, 3):
        verts, p, j = far_scene("triangles", dim)
        vs = T(p, *[v[j] for v in verts])
        res = [TG.point_in_triangle(*vs, o).numpy() for o in TG.ORDERS]
        assert (res[0] != res[1]).any() and (res[1] != res[2]).any()


def test_leaf_tests_take_the_reference_branches():
    """predicates.leaf_match_test: the box fallbacks of the reference
    (points over segments and k-DOPs, spheres over tetrahedra and k-DOPs,
    a triangle, segment or tetrahedron query) against its own, op by
    op, over a (Q, N) matrix."""
    rng = np.random.default_rng(8)
    shapes = _shapes(3, n=64)
    queries = {"points": [rng.uniform(-1, 1, (16, 3)).astype(np.float32)],
               "spheres": [rng.uniform(-1, 1, (16, 3)).astype(np.float32),
                           rng.uniform(0, 0.4, 16).astype(np.float32)]}
    queries.update({k: [a[:16] for a in shapes[k]] for k in
                    ("triangles", "segments", "tetrahedra", "boxes")})
    for vkind, varr in shapes.items():
        jv = _JCLS[vkind](*(jnp.asarray(a) for a in varr))
        tv = _TCLS[vkind](*T(*varr))
        for qkind, qarr in queries.items():
            jq = _JCLS[qkind](*(jnp.asarray(a) for a in qarr))
            tq = _TCLS[qkind](*T(*qarr))
            want = jax.vmap(lambda g: JP.leaf_match_test(
                JP.intersects(g), jv))(jq)
            got = TP.leaf_match_test(TP.lift(TP.intersects(tq)), tv)
            np.testing.assert_array_equal(np.asarray(want), got.numpy(),
                                          err_msg=f"{qkind} over {vkind}")
            want = jax.vmap(lambda g: JP.leaf_distance(JP.nearest(g), jv))(jq)
            got = TP.leaf_distance(TP.lift(TP.nearest(tq)), tv)
            np.testing.assert_array_equal(np.asarray(want), got.numpy(),
                                          err_msg=f"{qkind} near {vkind}")
