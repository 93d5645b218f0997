"""Queries over the remaining geometries (Triangles, Segments, Tetrahedra,
KDOPs, and Spheres values for ``Nearest``): ``BVH`` and ``BruteForce`` of
the port against the JAX reference on the CPU, and the two kernels of the
path against their twins on the card (tests marked ``cuda``).

Intersects batches over these values walk the callback kernel
(``kernels.bvh_callback``, the counterpart of the reference's Pallas
callback kernel; its CPU twin is ``core.traversal.walk``); ``Nearest``
batches walk the fine kNN kernel (``kernels.bvh_traverse.
bvh_traverse_fine_knn``, the counterpart of the reference's compiled
``traverse_knn``; its twin is ``core.traversal.knn_walk``). Everything is
compared bit for bit (tolerance 0): CSR sets, counts, callback states,
kNN distances and indices with their ties and (inf, -1) padding. The
scenes hold the traps of the float orders (``geometry.ORDERS``): sphere
radii equal to a value's distance in the walk's order, points a hair off
a triangle's edge or a tetrahedron's face, duplicate values (ties at the
k-th distance), and N in {0, 1, 2, 3}.

The reference's jitted walks round their last Q mod 8 lanes with other
scalar code, so every walked batch holds a multiple of 8 queries. Its
brute force tests only the leaves (no node test), its BVH the node boxes
too, so a point far above a triangle (``point_in_triangle`` tests the
projection) matches in brute force only: each index is compared with its
own counterpart. The JAX package is imported inside the CPU tests only,
so that the file collects on a machine without JAX, where ``-m cuda``
runs its card cases.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch import (BVH, BruteForce, EngineConfig, ExecutionPolicy,
                         QueryEngine, RouteRule, RouteTable, convert)
from repro_torch.core import callbacks as CB
from repro_torch.core import engine as TE
from repro_torch.core import geometry as TG
from repro_torch.core import predicates as TP
from repro_torch.core import traversal as TT
from repro_torch.core.index import _bcast_state
from repro_torch.kernels import bvh_callback as TK
from repro_torch.kernels import bvh_traverse as BT

CPU = "cpu"
Q = 32
#: (value kind, dim) of the scenes
VALUE_KINDS = [("triangles", 3), ("triangles", 2), ("segments", 3),
               ("segments", 2), ("tetrahedra", 3), ("kdops", 3),
               ("kdops", 2)]
QUERY_KINDS = ["points", "spheres", "boxes", "triangles", "segments",
               "tetrahedra"]
NO_BRUTE_FORCE = RouteTable(rules={"default": RouteRule(bf_max_work=0)})
TREE = ("node_lo", "node_hi", "rope", "left_child", "range_last",
        "leaf_perm")
KNN_TREE = ("node_lo", "node_hi", "rope", "left_child", "leaf_perm")
#: (value kind, dim) of the k-nearest scenes: every kind whose Nearest the
#: fine kNN walk answers
KNN_KINDS = [("triangles", 3), ("triangles", 2), ("segments", 3),
             ("segments", 2), ("tetrahedra", 3), ("kdops", 3),
             ("kdops", 2), ("spheres", 3), ("spheres", 2)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One CPU thread per pytest worker."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _f32(arrays):
    return [np.asarray(a, np.float32) for a in arrays]


def kdop_arrays(centres, dim, rng):
    """14-DOPs (3-D) or 8-DOPs (2-D) of four points around each centre."""
    dirs = TG.kdop_directions(dim, 14 if dim == 3 else 8).numpy()
    pts = centres[:, None, :] + rng.uniform(-0.06, 0.06,
                                            (len(centres), 4, dim))
    sup = _f32([pts])[0] @ dirs.T
    return _f32([sup.min(1), sup.max(1), dirs])


def value_arrays(kind, n, dim, seed=1):
    """Seeded values of `kind`; a quarter of them duplicates of others
    (ties at the k-th distance)."""
    rng = np.random.default_rng(seed)
    m = max(n - n // 4, 1)
    a = rng.uniform(0, 1, (m, dim))
    n_dup = max(n - m, 0)
    side = {"triangles": 0.1, "segments": 0.1, "tetrahedra": 0.15,
            "spheres": 0.05}.get(kind, 0.06)
    pick = np.concatenate([np.arange(min(m, n)), rng.integers(0, m, n_dup)])
    if kind == "kdops":
        lo, hi, dirs = kdop_arrays(a, dim, rng)
        return [lo[pick], hi[pick], dirs]
    if kind == "spheres":
        return _f32([a[pick], rng.uniform(0.01, side, m)[pick]])
    verts = {"triangles": 3, "segments": 2, "tetrahedra": 4}[kind]
    out = [a] + [a + rng.uniform(-side, side, a.shape)
                 for _ in range(verts - 1)]
    return _f32([v[pick] for v in out])


def query_arrays(qkind, dim, q, seed=2):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-0.05, 1.05, (q, dim))
    if qkind == "points":
        return _f32([c])
    if qkind == "spheres":
        return _f32([c, rng.uniform(0.02, 0.12, q)])
    if qkind == "boxes":
        return _f32([c, c + rng.uniform(0.0, 0.1, (q, dim))])
    verts = {"triangles": 3, "segments": 2, "tetrahedra": 4}[qkind]
    return _f32([c] + [c + rng.uniform(-0.05, 0.05, (q, dim))
                       for _ in range(verts - 1)])


def boundary_queries(vkind, varr, qkind, q, seed=3):
    """Queries on the boundary of a value's test, in the walk's float
    order: a sphere whose radius is its centre's distance to a value (the
    edge case of ``distance <= r``), a point a hair off a triangle's edge
    (``point_in_triangle``'s 1e-7 slack) or a tetrahedron's face."""
    rng = np.random.default_rng(seed)
    dim = varr[0].shape[1]
    n = len(varr[0])
    j = rng.integers(0, n, q)
    if vkind == "kdops" or qkind not in ("points", "spheres"):
        return None
    if vkind == "segments" and qkind == "points":
        # on the segment: inside its box, the reference's box test
        t = rng.uniform(0, 1, (q, 1))
        return _f32([varr[0][j] + t * (varr[1][j] - varr[0][j])])
    tv = convert.geometry_from_numpy(vkind, [v[j] for v in varr], CPU)
    if qkind == "spheres":
        c = query_arrays("points", dim, q, seed)[0]
        if vkind == "tetrahedra":
            return None
        d = TP.leaf_distance(TP.Nearest(TG.Points(torch.from_numpy(c))), tv,
                             "walk").numpy()
        d = np.where(np.arange(q) % 2 == 0, d,
                     np.nextafter(d, np.float32(np.inf)))
        return _f32([c, d])
    if vkind == "triangles":
        w = rng.dirichlet([1, 1, 1], q)
        w[np.arange(q), rng.integers(0, 3, q)] = rng.normal(0, 2e-7, q)
        w /= w.sum(1, keepdims=True)
        p = sum(w[:, i:i + 1] * varr[i][j].astype(np.float64)
                for i in range(3))
        if dim == 3:
            p[1::2] += rng.normal(0, 1e-3, (q // 2, 3))
        return _f32([p])
    if vkind == "tetrahedra":
        v = np.stack([x[j].astype(np.float64) for x in varr], 1)
        f = rng.integers(0, 4, q)
        idx = np.stack([(f + i) % 4 for i in range(4)], 1)
        w3 = np.take_along_axis(v, idx[:, :, None], 1)
        n_ = np.cross(w3[:, 1] - w3[:, 0], w3[:, 2] - w3[:, 0])
        s3 = (n_ * (w3[:, 3] - w3[:, 0])).sum(1)
        bw = rng.dirichlet([1, 1, 1], q)
        onf = sum(bw[:, i:i + 1] * w3[:, i] for i in range(3))
        t = -1e-9 * (1 + rng.normal(0, 0.3, q)) / s3 / (n_ * n_).sum(1)
        return _f32([onf + t[:, None] * n_])
    return None


# ---------------------------------------------------------------------------
# the reference (imported here only: the card runs without JAX)
# ---------------------------------------------------------------------------

def jx():
    """The JAX package's modules this file compares with."""
    import jax.numpy as jnp
    from repro.core import BVH as JBVH
    from repro.core import BruteForce as JBF
    from repro.core import callbacks as JCB
    from repro.core import geometry as JG
    from repro.core import lbvh as JL
    from repro.core import predicates as JP
    from repro.core import traversal as JT
    from repro.core.engine import EngineConfig as JEC
    from repro.core.engine import QueryEngine as JQE
    from repro.core.index import ExecutionPolicy as JPolicy
    from repro.core.index import _bcast_state as jbcast
    from repro.kernels.bvh_callback import bvh_traverse_callback as jkernel
    return dict(jnp=jnp, BVH=JBVH, BF=JBF, CB=JCB, G=JG, L=JL, P=JP, T=JT,
                EC=JEC, QE=JQE, Policy=JPolicy, bcast=jbcast, kernel=jkernel)


_JCLASS = {"points": "Points", "boxes": "Boxes", "spheres": "Spheres",
           "triangles": "Triangles", "segments": "Segments",
           "tetrahedra": "Tetrahedra", "kdops": "KDOPs", "rays": "Rays"}


def both(kind, arrays):
    """(jax geometry, port geometry) of the same arrays."""
    j = jx()
    jg = getattr(j["G"], _JCLASS[kind])(*(j["jnp"].asarray(a)
                                          for a in arrays))
    return jg, convert.geometry_from_numpy(kind, arrays, CPU)


def np_of(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def assert_csr_sets(want, got):
    """Offsets equal and the same index set per query."""
    off = np_of(want[2])
    np.testing.assert_array_equal(off, np_of(got[2]))
    wi, gi = np_of(want[1]), np_of(got[1])
    for i in range(len(off) - 1):
        np.testing.assert_array_equal(np.sort(wi[off[i]:off[i + 1]]),
                                      np.sort(gi[off[i]:off[i + 1]]))


def assert_states(want, got):
    want = list(want) if isinstance(want, (tuple, list)) else [want]
    got = list(got) if isinstance(got, (tuple, list)) else [got]
    assert len(want) == len(got)
    for w, g in zip(want, got):
        w, g = np_of(w), np_of(g)
        assert w.dtype == g.dtype and w.shape == g.shape
        np.testing.assert_array_equal(w, g)


def _policy(engine=None):
    return ExecutionPolicy(device=CPU, engine=engine)


def _kernel_engine():
    """The port's default routes with the brute-force crossover at 0: the
    callback kernel's twin and the fine kNN kernel's twin."""
    return QueryEngine(EngineConfig(route_table=NO_BRUTE_FORCE))


def _jax_loop():
    j = jx()
    return j["QE"](j["EC"](force="loop"))


@functools.lru_cache(maxsize=None)
def scene(vkind, dim, n, qkind, boundary=False):
    varr = value_arrays(vkind, n, dim)
    qarr = None
    if boundary and n:
        qarr = boundary_queries(vkind, varr, qkind, Q)
    if qarr is None:
        qarr = query_arrays(qkind, dim, Q)
    return varr, qarr


#: N of the scenes walked against the reference
N = 120
#: (value kind, dim, query kind): points and spheres (their boundary
#: scenes) and boxes over every value kind; the shape queries (by their
#: boxes) over 3-D triangles
SCENES = ([(v, d, q) for v, d in VALUE_KINDS
           for q in ("points", "spheres", "boxes")]
          + [("triangles", 3, q) for q in ("triangles", "segments",
                                           "tetrahedra")])


#: the epilogues on the card; against the reference, counting and
#: collect_first_k (early exit) stand for them (their leaf tests are the
#: same, t = 0 for spatial predicates)
EPILOGUES = ["counting", "count_with_limit", "min_distance",
             "collect_first_k", "collect_hits"]


def _factories(name):
    j = jx()
    make = {"counting": lambda m: m.counting(),
            "count_with_limit": lambda m: m.count_with_limit(3),
            "min_distance": lambda m: m.min_distance(),
            "collect_first_k": lambda m: m.collect_first_k(5),
            "collect_hits": lambda m: m.collect_hits(16)}[name]
    return make(j["CB"]), make(CB)


# ---------------------------------------------------------------------------
# BVH against the reference (brute force, kNN and the four callback paths:
# test_torch_geometry_bruteforce.py, _knn.py, _callbacks.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vkind,dim,qkind", SCENES)
def test_bvh_intersects_matches_reference(vkind, dim, qkind):
    """CSR sets and counts of ``BVH.query(intersects(...))`` (the
    callback kernel's twin: counting, then collect_hits) against the
    reference's walk, on the boundary queries of points and spheres and
    on generic boxes and shapes."""
    j = jx()
    for boundary in (qkind in ("points", "spheres"),):
        varr, qarr = scene(vkind, dim, N, qkind, boundary)
        (jv, tv), (jq, tq) = both(vkind, varr), both(qkind, qarr)
        engine = _kernel_engine()
        index = BVH(tv, policy=_policy(engine))
        jindex = j["BVH"](jv, engine=_jax_loop())
        want = jindex.query(j["P"].intersects(jq))
        assert_csr_sets(want, index.query(TP.intersects(tq)))
        np.testing.assert_array_equal(
            np_of(jindex.count(j["P"].intersects(jq))),
            np_of(index.count(TP.intersects(tq))))
        assert engine.callback_batches == {"kernel": 3, "loop": 0}
        assert int(np_of(want[2])[-1]) > 0


def test_kdops_query_is_answered_by_brute_force_only():
    """An ``intersects(KDOPs)`` batch: brute force answers it by boxes;
    a tree walk raises, as the reference's (its node test has no KDOPs
    branch); the callback kernel does not take it. The reference's brute
    force maps the shared directions over the queries too, so it answers
    only a batch of as many queries as directions (7 for a 14-DOP) and
    raises on others; the port's keeps them whole and answers any."""
    j = jx()
    varr = value_arrays("triangles", 200, 3)
    karr = kdop_arrays(query_arrays("points", 3, Q)[0].astype(np.float64),
                       3, np.random.default_rng(4))
    (jv, tv), (jk, tk) = both("triangles", varr), both("kdops", karr)
    seven = [a[:7] for a in karr[:2]] + [karr[2]]
    (j7, t7) = both("kdops", seven)
    assert_csr_sets(j["BF"](jv).query(j["P"].intersects(j7)),
                    BruteForce(tv, policy=_policy()).query(
                        TP.intersects(t7)))
    with pytest.raises(ValueError, match="inconsistent sizes"):
        j["BF"](jv).query(j["P"].intersects(jk))
    got = BruteForce(tv, policy=_policy()).query(TP.intersects(tk))
    assert_csr_sets(BruteForce(tv, policy=_policy()).query(
        TP.intersects(TG.to_boxes(tk))), got)
    index = BVH(tv, policy=_policy(_kernel_engine()))
    cb, _ = CB.counting()
    assert not TK.expressible(tv, TP.intersects(tk), cb)
    with pytest.raises(TypeError, match="KDOPs"):
        j["BVH"](jv, engine=_jax_loop()).query(j["P"].intersects(j7))
    with pytest.raises(TypeError, match="KDOPs"):
        index.query(TP.intersects(tk))


@pytest.mark.parametrize("vkind", ["segments", "tetrahedra", "kdops"])
def test_rays_over_these_values_raise(vkind):
    """No ray test for Segments, Tetrahedra or KDOPs, in either package."""
    j = jx()
    varr = value_arrays(vkind, 50, 3)
    rng = np.random.default_rng(5)
    rarr = _f32([rng.uniform(0, 1, (8, 3)), rng.normal(size=(8, 3))])
    (jv, tv), (jr, tr) = both(vkind, varr), both("rays", rarr)
    with pytest.raises(TypeError, match="ray tracing unsupported"):
        j["BF"](jv).query(j["P"].RayIntersect(jr))
    with pytest.raises(TypeError, match="ray tracing unsupported"):
        BruteForce(tv, policy=_policy()).query(TP.RayIntersect(tr))
    index = BVH(tv, policy=_policy())
    with pytest.raises(TypeError, match="ray tracing unsupported"):
        index.query(TP.RayNearest(tr, 2))
    assert index.policy.resolve_engine().route_callback(
        index, TP.RayIntersect(tr), CB.counting()[0]) == TE.ROUTE_LOOP


#: the six Kuhn tetrahedra of a cube: the paths 0 -> e_s0 -> e_s0 + e_s1
#: -> (1, 1, 1) over the permutations s of the axes
KUHN = ((0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0))


def kuhn_mesh(m, cells_per_unit):
    """The cube [0, m]^3 of unit cells cut into 6 m^3 Kuhn tetrahedra,
    coordinates divided by `cells_per_unit` in float32 (1: unit cells, as
    chip_smoke.py's mesh; 56: a corner of the unit cube cut 56 to a
    side): (a, b, c, d),
    tetrahedron 6 cell + s for cell (i, j, k) = (cell // m^2, cell // m
    % m, cell % m) and permutation s of KUHN."""
    ijk = np.stack(np.meshgrid(*[np.arange(m)] * 3, indexing="ij"),
                   -1).reshape(-1, 3)
    eye = np.eye(3, dtype=np.int64)
    verts = [[], [], [], []]
    for cell in ijk:
        for s in KUHN:
            v = cell.copy()
            verts[0].append(v.copy())
            for j, axis in enumerate(s):
                v = v + eye[axis]
                verts[j + 1].append(v.copy())
    scale = np.float32(cells_per_unit)
    return [np.asarray(v, np.float32) / scale for v in verts]


def kuhn_cell_of(p, m, cells_per_unit):
    """The tetrahedron holding each point: its cell and the order of its
    fractional coordinates."""
    x = p.astype(np.float64) * cells_per_unit
    cell = np.clip(np.floor(x), 0, m - 1).astype(np.int64)
    f = x - cell
    order = np.argsort(-f, axis=1, kind="stable")
    s = [KUHN.index(tuple(o)) for o in order]
    return (cell[:, 0] * m * m + cell[:, 1] * m + cell[:, 2]) * 6 + s


@pytest.mark.parametrize("cells_per_unit", [56, 1])
def test_tetrahedral_mesh_point_location(cells_per_unit):
    """Point location in a Kuhn mesh, both packages: at unit cells each
    point lies in its own tetrahedron (and in a neighbour only on a shared
    face); at 56 cells a unit, the reference's slack (a same-side product
    of degree 6 in the length is >= -1e-9, and it is at most 2.45 h^6 =
    7.9e-11 in magnitude) admits every tetrahedron of the point's cell,
    whose bounding boxes are the cell: 6 matches a point. The port matches
    the reference either way, CSR sets equal."""
    j = jx()
    m = 4
    varr = kuhn_mesh(m, cells_per_unit)
    rng = np.random.default_rng(6)
    p = _f32([rng.uniform(0.02, m - 0.02, (Q, 3)) / cells_per_unit])[0]
    (jv, tv), (jq, tq) = both("tetrahedra", varr), both("points", [p])
    want = j["BVH"](jv, engine=_jax_loop()).query(j["P"].intersects(jq))
    got = BVH(tv, policy=_policy(_kernel_engine())).query(TP.intersects(tq))
    assert_csr_sets(want, got)
    counts = np.diff(np_of(got.offsets))
    own = kuhn_cell_of(p, m, cells_per_unit)
    off, idx = np_of(got.offsets), np_of(got.indices)
    assert all(own[i] in idx[off[i]:off[i + 1]] for i in range(Q))
    if cells_per_unit == 1:
        assert (counts == 1).mean() > 0.9
    else:
        x = p.astype(np.float64) * cells_per_unit
        inner = np.all(np.abs(x - np.round(x)) > 1e-6, 1)
        assert (counts[inner] == 6).all()


@pytest.mark.parametrize("kind", ["segments", "tetrahedra", "kdops"])
def test_geometry_from_numpy_round_trips(kind):
    """convert.geometry_from_numpy of the new kinds, as a sequence and as
    a dict, and its field order."""
    arrays = value_arrays(kind, 20, 3)
    g = convert.geometry_from_numpy(kind, arrays, CPU)
    names = [f for f in vars(g)]
    g2 = convert.geometry_from_numpy(kind, dict(zip(names, arrays)), CPU)
    for a, t, t2 in zip(arrays, vars(g).values(), vars(g2).values()):
        np.testing.assert_array_equal(a, t.numpy())
        np.testing.assert_array_equal(a, t2.numpy())
    assert len(g) == 20 and g.dim == 3
    if kind == "kdops":
        assert g.index(slice(0, 3)).directions.shape == (7, 3)
    with pytest.raises(ValueError, match="takes"):
        convert.geometry_from_numpy(kind, arrays[:1], CPU)


# ---------------------------------------------------------------------------
# the card: both kernels against their twins
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    return torch.device("cuda", 0)


def _card_index(vkind, dim, n, dev):
    varr = value_arrays(vkind, n, dim)
    tv = convert.geometry_from_numpy(vkind, varr, dev)
    return BVH(tv, policy=ExecutionPolicy(device=dev,
                                          engine=_kernel_engine()))


CARD_SCENES = [(v, d, q) for v, d, q in SCENES
               if q in ("points", "spheres", "boxes", "segments")]


@pytest.mark.cuda
@pytest.mark.parametrize("vkind,dim,qkind", CARD_SCENES)
def test_callback_kernel_on_the_card(cuda_device, vkind, dim, qkind):
    """Every epilogue of the callback kernel (the 3-D records instance, or
    the generic one) against its twin run on the same card tensors, on
    generic and boundary queries; one launch a batch."""
    index = _card_index(vkind, dim, N, cuda_device)
    t = index.tree
    records = t.records if dim == 3 else None
    vrec = index.value_records if dim == 3 else None
    for boundary in (False, True):
        _, qarr = scene(vkind, dim, N, qkind, boundary)
        tq = convert.geometry_from_numpy(qkind, qarr, cuda_device)
        pred = TP.intersects(tq)
        for name in EPILOGUES:
            make = {"counting": lambda: CB.counting(),
                    "count_with_limit": lambda: CB.count_with_limit(3),
                    "min_distance": lambda: CB.min_distance(),
                    "collect_first_k": lambda: CB.collect_first_k(5),
                    "collect_hits": lambda: CB.collect_hits(16)}[name]
            cb, s0 = make()
            s0b = _bcast_state(s0, Q, cuda_device)
            before = TK.bvh_traverse_callback.launches
            got = TK.bvh_traverse_callback(
                *(getattr(t, f) for f in TREE), index.values, pred, cb, s0b,
                records=records, value_records=vrec)
            assert TK.bvh_traverse_callback.launches == before + 1
            want = TK.bvh_traverse_callback_ref(
                *(getattr(t, f) for f in TREE), index.values, pred, cb, s0b)
            assert_states(want, got)


@pytest.mark.cuda
@pytest.mark.parametrize("vkind,dim", KNN_KINDS)
def test_fine_knn_kernel_on_the_card(cuda_device, vkind, dim):
    """The fine kNN kernel against its twin on the same card tensors:
    point queries at k = 1, 10 (registers) and 40 (the heap), sphere and
    box queries (their node keys) at k = 10, and k > N, ties and padding
    included; one launch a call."""
    cases = [(N, "points", k) for k in (1, 10, 40)] + [
        (N, "spheres", 10), (N, "boxes", 10), (7, "points", 10)]
    for n, qkind, k in cases:
        index = _card_index(vkind, dim, n, cuda_device)
        t = index.tree
        _, qarr = scene(vkind, dim, N, qkind)
        tq = convert.geometry_from_numpy(qkind, qarr, cuda_device)
        before = BT.bvh_traverse_fine_knn.launches
        got = BT.bvh_traverse_fine_knn(
            *(getattr(t, f) for f in KNN_TREE), index.values, tq, k=k,
            records=t.records if dim == 3 else None,
            value_records=index.value_records if dim == 3 else None)
        assert BT.bvh_traverse_fine_knn.launches == before + 1
        want = BT.bvh_traverse_fine_knn_ref(
            *(getattr(t, f) for f in KNN_TREE), index.values, tq, k=k)
        assert_states(want, got)


@pytest.mark.cuda
@pytest.mark.parametrize("vkind,dim", [("triangles", 3), ("segments", 2),
                                       ("tetrahedra", 3), ("kdops", 3)])
def test_bvh_query_launches_the_kernels(cuda_device, vkind, dim):
    """``BVH.query`` on the card: an Intersects batch launches the
    callback kernel twice (count, fill) and a Nearest batch the fine kNN
    kernel once; the loop walk never runs; results equal the twins'."""
    index = _card_index(vkind, dim, N, cuda_device)
    _, qarr = scene(vkind, dim, N, "spheres")
    tq = convert.geometry_from_numpy("spheres", qarr, cuda_device)
    cb0 = TK.bvh_traverse_callback.launches
    kn0, walks = BT.bvh_traverse_fine_knn.launches, TT.knn_walk.calls
    res = index.query(TP.intersects(tq))
    dists, idxs = index._knn_impl(TP.nearest(tq, 5), index.policy)
    assert TK.bvh_traverse_callback.launches == cb0 + 2
    assert BT.bvh_traverse_fine_knn.launches == kn0 + 1
    assert TT.knn_walk.calls == walks
    cpu = BVH.from_tree(index.values.to(CPU), index.tree.to(CPU),
                        policy=_policy(_kernel_engine()))
    want = cpu.query(TP.intersects(tq.to(CPU)))
    assert_csr_sets((None, want.indices, want.offsets),
                    (None, res.indices, res.offsets))
    assert_states(cpu._knn_impl(TP.nearest(tq.to(CPU), 5), cpu.policy),
                  (dists, idxs))
