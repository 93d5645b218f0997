"""PyTorch port vs the JAX package: ray tracing (ArborX 2.0 section 2.5)
on the CPU, where the callback kernel runs as its plain twin.

Ray hit parameters t depend on how XLA:CPU contracts the products of
``ray_sphere`` and ``ray_triangle``, and it compiles the reference's
contexts differently: op by op (brute force's matrices, the N < 2
scans), its jitted walks and callback kernel, and its brute-force
callback loop (``geometry.ray_sphere`` names the three orders). Every
path of the port takes the order of its counterpart, so t is compared
bit for bit everywhere; the scenes hold grazing rays, zero direction
components, origins on box faces and rays aimed at triangle edges, where
a wrong order changes the hit sets too.

The reference's jitted walks round their last Q mod 8 lanes with scalar
code that orders sphere products differently from the vector lanes (and
from its own callback kernel, which pads every block to 8 lanes); the
walk scenes use Q = 64 and :func:`test_reference_walk_tail_lanes` pins
the port to the vector order on a Q = 37 batch.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parity import CPU, np_of, one_torch_thread  # noqa: F401
from repro.core import BVH as JBVH
from repro.core import BruteForce as JBF
from repro.core import callbacks as JCB
from repro.core import geometry as JG
from repro.core import lbvh as JL
from repro.core import predicates as JP
from repro.core import raytracing as JRT
from repro.core import traversal as JT
from repro.core.engine import EngineConfig as JEngineConfig
from repro.core.engine import QueryEngine as JQueryEngine
from repro.core.index import ExecutionPolicy as JExecutionPolicy
from repro.core.index import _bcast_state as j_bcast_state
from repro.kernels.bvh_callback import bvh_traverse_callback as j_callback_kernel
from repro_torch import (BVH, BruteForce, EngineConfig, ExecutionPolicy,
                         QueryEngine, convert, raytracing)
from repro_torch.core import callbacks as CB
from repro_torch.core import geometry as TG
from repro_torch.core import predicates as TP
from repro_torch.core import traversal as TT
from repro_torch.core.index import _bcast_state
from repro_torch.core.lbvh import FIELDS
from repro_torch.kernels import bvh_callback as TK

N, Q = 240, 64
TREE_ARGS = ("node_lo", "node_hi", "rope", "left_child", "range_last",
             "leaf_perm")
VKINDS = ["points", "boxes", "spheres", "triangles"]
POLICY = ExecutionPolicy(device=CPU)
_JCLS = {"points": JG.Points, "boxes": JG.Boxes, "spheres": JG.Spheres,
         "triangles": JG.Triangles, "rays": JG.Rays}


def both(kind, arrays):
    """The same geometry for both packages: (jax_geom, torch_geom)."""
    arrays = [np.asarray(a, np.float32) for a in arrays]
    return (_JCLS[kind](*(jnp.asarray(a) for a in arrays)),
            convert.geometry_from_numpy(kind, arrays, CPU))


def _lattice(n, rng):
    """Points on the 1/8 lattice of the unit cube: exactly representable,
    so axis-aligned rays from lattice origins hit them exactly."""
    return (rng.integers(0, 9, (n, 3)) / 8.0).astype(np.float32)


def value_arrays(vkind, n=N, seed=1):
    rng = np.random.default_rng(seed)
    if vkind == "points":
        return [_lattice(n, rng)]
    c = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    if vkind == "boxes":
        return [c, (c + rng.uniform(0.02, 0.12, c.shape)).astype(np.float32)]
    if vkind == "spheres":
        return [c, rng.uniform(0.02, 0.08, n).astype(np.float32)]
    b = (c + rng.uniform(-0.15, 0.15, c.shape)).astype(np.float32)
    return [c, b, (c + rng.uniform(-0.15, 0.15, c.shape)).astype(np.float32)]


def ray_arrays(vkind, varr, q=Q, seed=2, paired=False):
    """(origin, direction) (q, 3): random rays, a third aimed at a value
    (a triangle edge, a sphere's rim, a box face; value i for ray i when
    `paired`), an eighth with a zero direction component, and for boxes
    some origins on a box corner; for points, axis-aligned rays from
    lattice origins."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(0, 1, (q, 3)).astype(np.float32)
    d = rng.normal(size=(q, 3)).astype(np.float32)
    j = np.arange(q) if paired else rng.integers(0, len(varr[0]), q)
    aim = np.arange(q) % 3 == 0
    if vkind == "points":
        o[::2] = _lattice(len(o[::2]), rng)
        d[::2] = np.eye(3, dtype=np.float32)[rng.integers(0, 3, len(o[::2]))]
        d[1::4] = varr[0][j[1::4]] - o[1::4]
        return [o, d.astype(np.float32)]
    if vkind == "triangles":
        a, b, c = (x[j] for x in varr)
        w = rng.dirichlet([1, 1, 1], q)
        w[np.arange(q), rng.integers(0, 3, q)] = rng.normal(0, 1e-7, q)
        w /= w.sum(1, keepdims=True)
        target = w[:, :1] * a + w[:, 1:2] * b + w[:, 2:] * c
    elif vkind == "spheres":
        n = rng.normal(size=(q, 3))
        n /= np.linalg.norm(n, axis=1, keepdims=True)
        # grazing: the rim seen from the origin, within float noise
        target = varr[0][j] + varr[1][j][:, None] * n
    else:
        lo, hi = varr[0][j], varr[1][j]
        target = np.where(rng.random((q, 3)) < 0.5, lo, hi)
        o[1::5] = lo[1::5]                           # origins on a corner
    d = np.where(aim[:, None], target - o, d).astype(np.float32)
    d[3::8, rng.integers(0, 3)] = 0.0               # zero components
    return [o, d]


def _carry(jtree):
    return convert.lbvh_from_numpy({f: np.asarray(getattr(jtree, f))
                                    for f in FIELDS}, CPU)


@functools.lru_cache(maxsize=None)
def scene(vkind, n=N, q=Q, seed=1):
    """(jax_tree, port_tree, (jax_values, port_values), (jax_rays,
    port_rays)); the port tree is the JAX tree carried across."""
    varr = value_arrays(vkind, n, seed)
    jv, tv = both(vkind, varr)
    jtree = JL.build(JG.to_boxes(jv)) if n >= 2 else None
    jr, tr = both("rays", ray_arrays(vkind, varr, q, seed + 1))
    return jtree, None if jtree is None else _carry(jtree), (jv, tv), (jr, tr)


def _leaves(state):
    return list(state) if isinstance(state, (tuple, list)) else [state]


def assert_states_equal(want, got):
    want, got = _leaves(want), _leaves(got)
    assert len(want) == len(got)
    for w, g in zip(want, got):
        w, g = np.asarray(w), np_of(g)
        assert w.dtype == g.dtype and w.shape == g.shape
        np.testing.assert_array_equal(w, g)


def epilogue(name, n=N):
    """(jax (cb, state0), port (cb, state0)) of one callback."""
    if name == "min_where":
        rng = np.random.default_rng(3)
        flags = rng.random(n) < 0.5
        weights = rng.integers(0, 10 * n, n).astype(np.int32)
        jf, jw, big = jnp.asarray(flags), jnp.asarray(weights), 10**6

        def jcb(state, pred, value, index, t):
            w = jnp.where(jf[index], jw[index], jnp.int32(big))
            return jnp.minimum(state, w), jnp.bool_(False)

        return (jcb, jnp.int32(big)), CB._min_where(
            torch.from_numpy(flags), torch.from_numpy(weights), big)
    make = {"counting": lambda m: m.counting(),
            "count_with_limit": lambda m: m.count_with_limit(2),
            "min_distance": lambda m: m.min_distance(),
            "collect_first_k": lambda m: m.collect_first_k(3),
            "collect_hits": lambda m: m.collect_hits(16)}[name]
    return make(JCB), make(CB)


RAY_PREDS = {"intersect": (JP.RayIntersect, TP.RayIntersect),
             "ordered": (JP.RayOrderedIntersect, TP.RayOrderedIntersect),
             "nearest": (lambda r: JP.RayNearest(r, 2),
                         lambda r: TP.RayNearest(r, 2))}


# ---------------------------------------------------------------------------
# the three ray tests, in every order
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _pairs(kind, m=4096, seed=7):
    """m (ray, target) pairs, one per row, of the edge cases of `kind`."""
    varr = value_arrays(kind, m, seed)
    o, d = ray_arrays(kind, varr, m, seed + 1, paired=True)
    if kind == "boxes":
        o[2::7] = np.where(np.arange(3) == 0, varr[0][2::7], o[2::7])
    return varr, o, d


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("kind", ["boxes", "points", "spheres", "triangles"])
def test_ray_tests_bit_identical(kind, fused):
    """geometry.ray_box / ray_sphere / ray_triangle against the reference
    jitted (the "walk" order) and op by op (the "eager" order): hit masks
    and t bit-identical (tolerance 0)."""
    varr, o, d = _pairs(kind)
    jfn = {"boxes": JG.ray_box, "points": JG.ray_box,
           "spheres": JG.ray_sphere, "triangles": JG.ray_triangle}[kind]
    args = [o, d] + (varr * 2 if kind == "points" else varr)
    want_h, want_t = map(np.asarray, (jax.jit(jfn) if fused else jfn)(*args))
    targs = [torch.from_numpy(np.asarray(a)) for a in args]
    if kind == "spheres":
        got_h, got_t = TG.ray_sphere(*targs, "walk" if fused else "eager")
    elif kind == "triangles":
        got_h, got_t = TG.ray_triangle(*targs, fused=fused)
    else:
        got_h, got_t = TG.ray_box(*targs)
    np.testing.assert_array_equal(want_h, got_h.numpy())
    np.testing.assert_array_equal(want_t, got_t.numpy())
    assert want_h.sum() > len(o) // 8


def test_ray_orders_differ_where_it_matters():
    """The orders are not interchangeable: on the edge scenes the jitted
    and the op-by-op reference disagree, and so do the port's orders."""
    varr, o, d = _pairs("triangles")
    jh = np.asarray(jax.jit(JG.ray_triangle)(o, d, *varr)[0])
    eh = np.asarray(JG.ray_triangle(o, d, *varr)[0])
    assert (jh != eh).any()
    varr, o, d = _pairs("spheres")
    ts = [TG.ray_sphere(*(torch.from_numpy(a) for a in (o, d, *varr)),
                        order)[1].numpy() for order in TG.ORDERS]
    assert (ts[0] != ts[1]).any() and (ts[1] != ts[2]).any()
    with pytest.raises(ValueError, match="order"):
        TG.ray_sphere(*(torch.from_numpy(a) for a in (o, d, *varr)), "fast")


def test_sphere_orders_disagree_only_within_the_rim_bound():
    """The three sphere orders decide a hit differently only where the
    float64 discriminant b^2 - d.d c lies within 24 u d.d (|o-c|^2 + r^2)
    of 0 or c = |o-c|^2 - r^2 within 12 u (|o-c|^2 + r^2) of 0 (u =
    2^-24): the first-order float32 error bound of either order, which
    the chip check of the BVH's sphere hits against BruteForce's uses.
    200,000 rays graze spheres of radius 0.005 or start on their surface."""
    rng = np.random.default_rng(11)
    m, r = 200_000, 0.005
    o = rng.uniform(0, 1, (m, 3))
    d = rng.normal(size=(m, 3))
    side = rng.normal(size=(m, 3))
    side -= (side * d).sum(1, keepdims=True) / (d * d).sum(1, keepdims=True) * d
    side /= np.linalg.norm(side, axis=1, keepdims=True)
    scale = 1 + rng.uniform(-1, 1, (m, 1)) * 10.0 ** rng.uniform(-7, -3, (m, 1))
    c = o + rng.uniform(-0.2, 1.3, (m, 1)) * d + r * scale * side
    on = np.arange(m) % 3 == 0
    c[on] = o[on] + r * scale[on] * side[on]
    o, d, c = (x.astype(np.float32) for x in (o, d, c))
    rad = np.full(m, r, np.float32)
    hits = [TG.ray_sphere(*(torch.from_numpy(a) for a in (o, d, c, rad)),
                          order)[0].numpy() for order in TG.ORDERS]
    oc = o.astype(np.float64) - c
    d64, r2 = d.astype(np.float64), np.float64(rad[0]) ** 2
    dd, s = (d64 * d64).sum(1), (oc * oc).sum(1)
    disc = (oc * d64).sum(1) ** 2 - dd * (s - r2)
    u = 2.0 ** -24
    near = ((np.abs(disc) <= 24 * u * dd * (s + r2))
            | (np.abs(s - r2) <= 12 * u * (s + r2)))
    differ = (hits[0] != hits[1]) | (hits[1] != hits[2]) | (hits[0] != hits[2])
    assert differ.sum() > 1000
    assert near[differ].all()


# ---------------------------------------------------------------------------
# the walk: reference traverse, reference callback kernel, port twin and
# port loop walk, every state bit for bit
# ---------------------------------------------------------------------------

def _run_all(vkind, jpred, tpred, jcall, tcall):
    jtree, ttree, (jv, tv), _ = scene(vkind)
    (jcb, js0), (tcb, ts0) = jcall, tcall
    js0b = j_bcast_state(js0, len(jpred))
    ts0b = _bcast_state(ts0, len(tpred), CPU)
    want = JT.traverse(jtree, jv, jpred, jcb, js0b)
    assert_states_equal(want, j_callback_kernel(
        *(getattr(jtree, f) for f in TREE_ARGS), jv, jpred, jcb, js0b,
        bq=64, interpret=True))
    twin = TK.bvh_traverse_callback(*(getattr(ttree, f) for f in TREE_ARGS),
                                    tv, tpred, tcb, ts0b)
    assert_states_equal(want, twin)
    assert_states_equal(want, TT.traverse(ttree, tv, tpred, tcb, ts0b))
    return twin


@pytest.mark.parametrize("name", ["counting", "count_with_limit",
                                  "min_distance", "collect_first_k",
                                  "collect_hits", "min_where"])
def test_every_epilogue_over_ray_sphere_hits(name):
    """Every epilogue with RayIntersect over spheres (the order-sensitive
    value kind): final states bit-identical on all four paths."""
    _, _, _, (jr, tr) = scene("spheres")
    twin = _run_all("spheres", JP.RayIntersect(jr), TP.RayIntersect(tr),
                    *epilogue(name))
    if name == "counting":
        assert int(np_of(twin).sum()) > Q // 2


@pytest.mark.parametrize("vkind,kind", [(v, "intersect") for v in VKINDS] + [
    (v, k) for v in ("spheres", "triangles") for k in ("ordered", "nearest")])
def test_ray_walk_collects_t_bit_identical(vkind, kind):
    """collect_hits (indices and t in walk order) for RayIntersect over
    every value geometry, and for the other two ray kinds over the two
    order-sensitive ones, on all four paths."""
    _, _, _, (jr, tr) = scene(vkind)
    jmake, tmake = RAY_PREDS[kind]
    twin = _run_all(vkind, jmake(jr), tmake(tr), *epilogue("collect_hits"))
    assert int(np_of(twin[0]).sum()) >= Q // 8


@pytest.mark.parametrize("vkind", ["boxes", "triangles"])
def test_ray_walk_min_distance(vkind):
    """min_distance reduces t: the nearest hit per ray, on all four
    paths."""
    _, _, _, (jr, tr) = scene(vkind)
    _run_all(vkind, JP.RayIntersect(jr), TP.RayIntersect(tr),
             *epilogue("min_distance"))


def test_reference_walk_tail_lanes():
    """Q = 37 rays over spheres: the port's walk equals the reference's
    callback kernel on every lane and the reference's walk on the 32
    vector lanes; the reference's walk may round its 5 tail lanes the
    scalar way (a finding about the reference, not a tolerance)."""
    jtree, ttree, (jv, tv), (jr, tr) = scene("spheres")
    q = 37
    jp, tp = JP.RayIntersect(jr.__class__(jr.origin[:q], jr.direction[:q])), \
        TP.RayIntersect(TP.take(TP.RayIntersect(tr), slice(0, q)).rays)
    (jcb, js0), (tcb, ts0) = epilogue("collect_hits")
    js0b, ts0b = j_bcast_state(js0, q), _bcast_state(ts0, q, CPU)
    kernel = j_callback_kernel(*(getattr(jtree, f) for f in TREE_ARGS), jv,
                               jp, jcb, js0b, bq=64, interpret=True)
    walk = JT.traverse(jtree, jv, jp, jcb, js0b)
    port = TT.traverse(ttree, tv, tp, tcb, ts0b)
    assert_states_equal(kernel, port)
    assert_states_equal([np.asarray(a)[:32] for a in walk],
                        [a[:32] for a in port])


# ---------------------------------------------------------------------------
# the entry points: BVH and BruteForce, every value geometry
# ---------------------------------------------------------------------------

def _indexes(vkind, n=N):
    jtree, ttree, (jv, tv), (jr, tr) = scene(vkind, n)
    return (JBVH(jv), BVH(tv, policy=POLICY), JBF(jv),
            BruteForce(tv, policy=POLICY), jr, tr)


def assert_csr_sets(jres, tres):
    """Offsets equal and the same index set per ray."""
    off = np.asarray(jres[2])
    np.testing.assert_array_equal(off, np_of(tres[2]))
    ji, ti = np.asarray(jres[1]), np_of(tres[1])
    for q in range(len(off) - 1):
        np.testing.assert_array_equal(np.sort(ji[off[q]:off[q + 1]]),
                                      np.sort(ti[off[q]:off[q + 1]]))


@pytest.mark.parametrize("backend", ["bvh", "bruteforce"])
@pytest.mark.parametrize("vkind", VKINDS)
def test_cast_intersect_and_ordered(vkind, backend):
    """cast_intersect: CSR offsets and per-ray index sets equal;
    cast_ordered: indices and t equal in order (tolerance 0)."""
    jb, tb, jbf, tbf, jr, tr = _indexes(vkind)
    ji, ti = (jb, tb) if backend == "bvh" else (jbf, tbf)
    want = JRT.cast_intersect(ji, jr)
    assert_csr_sets(want, raytracing.cast_intersect(ti, tr))
    assert int(np.asarray(want[2])[-1]) >= Q // 8
    w_idx, w_t, w_off = map(np.asarray, JRT.cast_ordered(ji, jr))
    g_idx, g_t, g_off = map(np_of, raytracing.cast_ordered(ti, tr))
    np.testing.assert_array_equal(w_off, g_off)
    np.testing.assert_array_equal(w_idx, g_idx)
    np.testing.assert_array_equal(w_t, g_t)
    for q in range(Q):
        assert np.all(np.diff(g_t[g_off[q]:g_off[q + 1]]) >= 0)


@pytest.mark.parametrize("backend", ["bvh", "bruteforce"])
@pytest.mark.parametrize("vkind", VKINDS)
def test_cast_nearest(vkind, backend):
    """cast_nearest for k in {1, 4}: t bit-identical (tolerance 0) and
    indices equal; misses are (inf, -1)."""
    jb, tb, jbf, tbf, jr, tr = _indexes(vkind)
    ji, ti = (jb, tb) if backend == "bvh" else (jbf, tbf)
    for k in (1, 4):
        wt, wi = map(np.asarray, JRT.cast_nearest(ji, jr, k))
        gt, gi = map(np_of, raytracing.cast_nearest(ti, tr, k))
        np.testing.assert_array_equal(wt, gt)
        np.testing.assert_array_equal(wi, gi)
        assert np.isfinite(gt[:, 0]).sum() >= Q // 8
        assert np.array_equal(np.isinf(gt), gi == -1)


@pytest.mark.parametrize("vkind", ["spheres", "triangles"])
def test_bruteforce_ray_callbacks(vkind):
    """BruteForce callbacks over ray predicates (the reference's compiled
    loop, the "loop" sphere order): collect_hits and min_distance states
    bit-identical."""
    _, _, jbf, tbf, jr, tr = _indexes(vkind)
    for name in ("collect_hits", "min_distance"):
        (jcb, js0), (tcb, ts0) = epilogue(name)
        assert_states_equal(
            jbf.query(JP.RayIntersect(jr), callback=(jcb, js0)),
            tbf.query(TP.RayIntersect(tr), callback=(tcb, ts0)))


@pytest.mark.parametrize("force", ["pallas", "loop"])
def test_query_ray_kinds_against_pinned_reference(force):
    """The port's BVH.query for the three ray kinds and count() against
    the reference pinned to its callback kernel or to its walk."""
    jtree, ttree, (jv, tv), (jr, tr) = scene("triangles")
    jb = JBVH(jv, engine=JQueryEngine(JEngineConfig(force=force)))
    tb = BVH(tv, policy=POLICY)
    np.testing.assert_array_equal(
        np.asarray(jb.count(JP.RayIntersect(jr))),
        np_of(tb.count(TP.RayIntersect(tr))))
    w = jb.query(JP.RayOrderedIntersect(jr))
    g = tb.query(TP.RayOrderedIntersect(tr))
    for a, b in ((w.indices, g.indices), (w.offsets, g.offsets),
                 (w.distances, g.distances)):
        np.testing.assert_array_equal(np.asarray(a), np_of(b))
    w = jb.query(JP.RayNearest(jr, 3))
    g = tb.query(TP.RayNearest(tr, 3))
    np.testing.assert_array_equal(np.asarray(w.distances), np_of(g.distances))
    np.testing.assert_array_equal(np.asarray(w.indices), np_of(g.indices))
    np.testing.assert_array_equal(np.asarray(w.values.a), np_of(g.values.a))


def test_ray_routes():
    """Ray count and fill run the callback kernel's route (its twin here),
    RayNearest the ray kNN kernel's route (no callback batch);
    force="loop" pins the walks, and both routes give identical
    cast_nearest results; brute force and the spatial kernel never see a
    ray."""
    _, _, (_, tv), (_, tr) = scene("boxes")
    engine = QueryEngine()
    tb = BVH(tv, policy=POLICY.override(engine=engine))
    preds = TP.RayIntersect(tr)
    assert engine.route_spatial(tb, preds) == "loop"
    assert engine.route_knn(tb, TP.RayNearest(tr, 1)) == "kernel"
    raytracing.cast_intersect(tb, tr)
    raytracing.cast_ordered(tb, tr)
    assert engine.callback_batches == {"kernel": 4, "loop": 0}
    raytracing.cast_nearest(tb, tr)
    assert engine.callback_batches == {"kernel": 4, "loop": 0}
    loop = QueryEngine(EngineConfig(force="loop"))
    lb = BVH(tv, policy=POLICY.override(engine=loop))
    assert loop.route_knn(lb, TP.RayNearest(tr, 1)) == "loop"
    a = lb.count(preds)
    assert loop.callback_batches == {"kernel": 0, "loop": 1}
    assert torch.equal(a, tb.count(preds))
    for k in (1, 4):
        kt, ki = raytracing.cast_nearest(tb, tr, k)
        lt, li = raytracing.cast_nearest(lb, tr, k)
        assert torch.equal(kt, lt) and torch.equal(ki, li)


def test_query_out_over_rays_gets_t_zero():
    """query(out=) over ray predicates: out_fn sees t = 0, as in the
    reference, with the matches in the CSR layout."""
    jb, tb, _, _, jr, tr = _indexes("boxes")
    w = jb.query(JP.RayIntersect(jr), out=lambda p, v, i, t: i * 10 + t)
    g = tb.query(TP.RayIntersect(tr), out=lambda p, v, i, t: i * 10 + t)
    np.testing.assert_array_equal(np.asarray(w.offsets), np_of(g.offsets))
    assert np.array_equal(np.sort(np.asarray(w.values)), np.sort(np_of(g.values)))
    assert np_of(g.values).dtype == np.float32


@pytest.mark.parametrize("vkind,n", [("triangles", 0), ("triangles", 1),
                                     ("spheres", 1)])
def test_degenerate_indexes(vkind, n):
    """N in {0, 1}: the linear scan answers every cast and a callback as
    the reference's does (t bit-identical)."""
    jtree, _, (jv, tv), (jr, tr) = scene(vkind, max(n, 1))
    if n == 0:
        jv = jax.tree_util.tree_map(lambda a: a[:0], jv)
        tv = tv.index(slice(0, 0))
    jb, tb = JBVH(jv), BVH(tv, policy=POLICY)
    wt, wi = map(np.asarray, JRT.cast_nearest(jb, jr, 2))
    gt, gi = map(np_of, raytracing.cast_nearest(tb, tr, 2))
    np.testing.assert_array_equal(wt, gt)
    np.testing.assert_array_equal(wi, gi)
    assert_csr_sets(JRT.cast_intersect(jb, jr), raytracing.cast_intersect(tb, tr))
    for a, b in zip(JRT.cast_ordered(jb, jr), raytracing.cast_ordered(tb, tr)):
        np.testing.assert_array_equal(np.asarray(a), np_of(b))
    (jcb, js0), (tcb, ts0) = epilogue("collect_hits", max(n, 1))
    assert_states_equal(jb.query(JP.RayIntersect(jr), callback=(jcb, js0)),
                        tb.query(TP.RayIntersect(tr), callback=(tcb, ts0)))


def test_triangle_spatial_queries_wait_for_a_later_slice():
    """The later slice came (the geometries slice): spatial queries over
    the ray scene's triangles are answered as the reference answers them
    (tests/test_torch_geometry_query.py holds them in full); the ray test
    stays 3-D only."""
    _, _, (jv, tv), (jr, tr) = scene("triangles")
    from repro_torch import RouteRule, RouteTable
    walk = QueryEngine(EngineConfig(route_table=RouteTable(
        rules={"default": RouteRule(bf_max_work=0)})))
    tb = BVH(tv, policy=ExecutionPolicy(device=CPU, engine=walk))
    jb = JBVH(jv, engine=JQueryEngine(JEngineConfig(force="loop")))
    probe = TG.Spheres(tr.origin[:8], torch.full((8,), 0.1))
    jprobe = JG.Spheres(jr.origin[:8], jnp.full((8,), 0.1, jnp.float32))
    assert_csr_sets(jb.query(JP.intersects(jprobe)),
                    tb.query(TP.intersects(probe)))
    want = jb.query(JP.nearest(JG.Points(jr.origin[:8]), k=1))
    got = tb.query(TP.nearest(TG.Points(tr.origin[:8]), k=1))
    np.testing.assert_array_equal(np.asarray(want.indices),
                                  np_of(got.indices))
    with pytest.raises(NotImplementedError, match="3-D only"):
        TG.ray_triangle(*(torch.zeros((1, 2)),) * 5)


def test_geometry_from_numpy_carries_triangles_and_rays():
    a = np.arange(9, dtype=np.float32).reshape(3, 3)
    t = convert.geometry_from_numpy("triangles", {"a": a, "b": a + 1,
                                                  "c": a + 2}, "cpu")
    r = convert.geometry_from_numpy("rays", (a, -a), "cpu")
    assert isinstance(t, TG.Triangles) and len(t) == 3 and t.dim == 3
    assert isinstance(r, TG.Rays) and torch.equal(r.direction,
                                                  -torch.from_numpy(a))
    np.testing.assert_array_equal(
        np_of(TG.to_boxes(t).hi),
        np.asarray(JG.to_boxes(JG.Triangles(a, a + 1, a + 2)).hi))
    np.testing.assert_array_equal(
        np_of(TG.centroid(t)),
        np.asarray(JG.centroid(JG.Triangles(a, a + 1, a + 2))))
    with pytest.raises(TypeError, match="bounding box"):
        TG.to_boxes(r)


def test_reference_pinned_to_its_kernel_counts_rays():
    """The reference's own callback-kernel route serves rays (its
    route_callback admits them) at the scene's sizes once forced."""
    jtree, _, (jv, _), (jr, _) = scene("spheres")
    jb = JBVH(jv, engine=JQueryEngine(JEngineConfig(force="pallas")),
              policy=JExecutionPolicy())
    eng = jb.policy.resolve_engine()
    assert eng.route_callback(jb, JP.RayIntersect(jr)) == "pallas"
