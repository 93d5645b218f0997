"""The fine kNN kernel's algorithm (``csrc/fine_knn.cu``) on the CPU: a
Python transcription of its nearest-first walk (the slack delta on the
node keys, the fine distance as the list key, the tie pass, the
certificate and the rope walk's re-walk of the flagged queries) held to
the rope-walk twin (``bvh_traverse_fine_knn_ref``, the reference's loop
walk bit for bit, held there by ``test_torch_geometry_knn.py``) on small
seeded scenes: Spheres, Triangles, Segments, Tetrahedra and KDOPs values
under Points, Boxes and Spheres queries at k = 1, 4, 10 and 33, with
duplicate values (ties at the k-th distance), NaN and +-inf. A
constructed straddle (an anomalous leaf, whose fine distance rounds below
its box key, and a second value whose distance lies between the two)
shows that the certificate is needed: without it the transcription's list
differs from the twin's, with it the query is flagged and re-walked.
Last, delta itself against ``core.geometry``'s "walk" functions, in
float64, on slivers, zero-length segments, queries on axis lines through
vertices and coordinates offset to 1e3. Tolerance 0 everywhere: lists
are compared bit for bit, ties and (inf, -1) padding included. No JAX.
"""
import math

import numpy as np
import pytest
import torch

from test_torch_geometry_query import (  # noqa: F401
    CPU, kdop_arrays, one_torch_thread, query_arrays, value_arrays)
from repro_torch import BVH, ExecutionPolicy, convert
from repro_torch.core import geometry as TG
from repro_torch.core import predicates as TP
from repro_torch.core.access import value_at
from repro_torch.kernels import bvh_traverse as BT

INF = math.inf
#: the scenes' values and queries: small, since the twin is a host loop
N = 48
Q = 16
VALUE_KINDS = ("spheres", "triangles", "segments", "tetrahedra", "kdops")
QUERY_KINDS = ("points", "boxes", "spheres")
KS = (1, 4, 10, 33)


# ---------------------------------------------------------------------------
# the transcription
# ---------------------------------------------------------------------------

def slack(values, queries, tree):
    """(Q,) float64 delta of csrc/fine_knn.cu's note (FineWalk::slack):
    d >= kb - delta for every leaf and query."""
    dim = values.dim
    qc = TG.centroid(queries).double().numpy()
    if isinstance(queries, TG.Boxes):
        ql, qh = queries.lo.double().numpy(), queries.hi.double().numpy()
    else:
        ql = qh = qc
    root = np.concatenate([tree.node_lo[0].double().numpy(),
                           tree.node_hi[0].double().numpy()])
    with np.errstate(invalid="ignore"):
        m = np.maximum(np.abs(qc).max(1), np.abs(root).max())
        inv = np.maximum(ql - qh, 0.0).sum(1)
    rq = (np.maximum(-queries.radius.double().numpy(), 0.0)
          if isinstance(queries, TG.Spheres) else 0.0)
    rv = (max(0.0, -float(values.radius.min()))
          if isinstance(values, TG.Spheres) else 0.0)
    extra = 2.0 * (inv + rq + dim * rv)
    base = 2.0 ** -17 * dim * m + 2.0 ** -64
    if isinstance(values, (TG.Tetrahedra, TG.KDOPs)):
        return np.where(extra == 0.0, 0.0, base + extra)
    return base + extra


def node_keys(tree, queries):
    """(Q, 2N-1) node keys (predicates.node_min_distance, the rope walk's)
    and (Q, N) fine distances by sorted position (predicates.leaf_distance
    in the "walk" order), float32, as the kernel computes them."""
    q, m, n = len(queries), tree.node_lo.shape[0], tree.num_leaves
    pred = TP.nearest(queries, 1)
    rows = torch.arange(q).repeat_interleave(m)
    nodes = torch.arange(m).repeat(q)
    keys = TP.node_min_distance(TP.take(pred, rows), tree.node_lo[nodes],
                                tree.node_hi[nodes]).reshape(q, m)
    rows = torch.arange(q).repeat_interleave(n)
    orig = tree.leaf_perm.to(torch.int64).repeat(q)
    return keys.numpy(), rows, orig, pred


def leaf_distances(values, pred, rows, orig, q, n):
    d = TP.leaf_distance(TP.take(pred, rows), value_at(values, orig), "walk")
    return d.reshape(q, n).numpy()


def _less(a, b):
    """knn_list.cuh's key order with kLaterFirst: (d, code descending)."""
    return a[0] < b[0] or (a[0] == b[0] and a[1] > b[1])


def nearest_first(keys, d, left, rope, n, k, delta):
    """One query of fine_nf_kernel: (entries [(d, 2 pos + anomalous)]
    ascending, padded with (inf, -1), lost, lost_anom, node visits)."""
    best = [(np.float32(INF), -1)] * k
    lost = lost_anom = INF
    slack2 = 2.0 * delta
    leaf0 = n - 1
    visits = 0

    def passes(key):                  # NaN fails both
        return key <= float(best[k - 1][0]) + slack2 and key < INF

    def offer(c, kb):
        nonlocal best, lost, lost_anom
        if not passes(kb):
            return
        pos = c - leaf0
        dd = d[pos]
        anom = bool(dd < kb)
        if dd < best[k - 1][0]:
            ed, ec = best[k - 1]
            lost = min(lost, float(ed))
            if ec & 1:
                lost_anom = min(lost_anom, float(ed))
            entry = (dd, 2 * pos + int(anom))
            at = sum(_less(e, entry) for e in best)
            best = best[:at] + [entry] + best[at:k - 1]
        else:
            if not np.isnan(dd):     # fminf drops NaN
                lost = min(lost, float(dd))
            if anom:
                lost_anom = min(lost_anom, float(dd))

    stack = []
    visits += 1
    go = passes(keys[0])
    link = left[0]
    while go:
        lc = link
        rc = rope[lc]                 # a left child's rope: its sibling
        visits += 2
        for c in (lc, rc):
            if c >= leaf0:
                offer(c, keys[c])
        go_l = lc < leaf0 and passes(keys[lc])
        go_r = rc < leaf0 and passes(keys[rc])
        if go_l and go_r:
            near, far = (lc, rc) if keys[lc] <= keys[rc] else (rc, lc)
            stack.append((keys[far], left[far]))
            link = left[near]
        elif go_l or go_r:
            link = left[lc] if go_l else left[rc]
        else:
            go = False
            while stack:
                key, lk = stack.pop()
                if passes(key):
                    link, go = lk, True
                    break
    return best, lost, lost_anom, visits


def flagged(best, lost, lost_anom, keys, n, k, delta):
    """fine_flagged: an anomalous leaf with d <= D and kb >= lost."""
    dk = float(best[k - 1][0])
    flag = lost_anom <= dk and lost_anom < INF
    for dd, code in best:
        if code >= 0 and code & 1 and float(dd) + delta >= lost:
            flag |= bool(keys[n - 1 + (code >> 1)] >= lost)
    return flag


def tie_pass(best, lost, keys, d, left, rope, n, k):
    """fine_tie_pass_and_put: [(d, sorted position or -1)] of the k slots."""
    dk = best[k - 1][0]
    if not (lost == dk and dk != INF):
        return [(e[0], e[1] >> 1) for e in best]
    below = sum(e[0] < dk for e in best)
    m = k - below
    seen, ties, ring = 0, 0, [0] * m
    node, leaf0 = 0, n - 1
    while node != -1 and seen < k:
        kb = keys[node]
        if not kb <= dk:
            node = rope[node]
        elif node < leaf0:
            node = left[node]
        else:
            if d[node - leaf0] <= dk:
                seen += 1
                if d[node - leaf0] == dk:
                    ring[ties % m] = node - leaf0
                    ties += 1
            node = rope[node]
    out = [(e[0], e[1] >> 1) for e in best[:below]]
    out += [(dk, ring[(ties - 1 - j) % m]) for j in range(m)]
    return out


def model(tree, values, queries, k, certificate=True):
    """(dists, idxs) (Q, k) of the kernel's algorithm, the rows of the
    flagged queries from the rope walk (the twin: fine_rope_kernel walks
    its node sequence); with certificate=False the nearest-first lists
    as they are. Also (flagged rows, node visits of all queries)."""
    n, q = tree.num_leaves, len(queries)
    keys, rows, orig, pred = node_keys(tree, queries)
    d = leaf_distances(values, pred, rows, orig, q, n)
    left = tree.left_child.numpy()
    left = np.concatenate([left, np.full(n, -1, left.dtype)])
    rope = tree.rope.numpy()
    perm = tree.leaf_perm.numpy()
    delta = slack(values, queries, tree)
    dists = np.full((q, k), np.float32(INF), np.float32)
    idxs = np.full((q, k), -1, np.int32)
    flags, visits = [], 0
    for i in range(q):
        best, lost, lost_anom, v = nearest_first(keys[i], d[i], left, rope,
                                                 n, k, delta[i])
        visits += v
        if certificate and flagged(best, lost, lost_anom, keys[i], n, k,
                                   delta[i]):
            flags.append(i)
            continue
        for j, (dd, pos) in enumerate(tie_pass(best, lost, keys[i], d[i],
                                               left, rope, n, k)):
            dists[i, j] = dd
            idxs[i, j] = -1 if pos < 0 else perm[pos]
    if flags:
        sub = queries.index(torch.tensor(flags))
        wd, wi = twin(tree, values, sub, k)
        dists[flags], idxs[flags] = wd, wi
    return dists, idxs, flags, visits


def twin(tree, values, queries, k, stats=None):
    d, i = BT.bvh_traverse_fine_knn_ref(
        tree.node_lo, tree.node_hi, tree.rope, tree.left_child,
        tree.leaf_perm, values, queries, k=k, stats=stats)
    return d.numpy(), i.numpy()


# ---------------------------------------------------------------------------
# scenes
# ---------------------------------------------------------------------------

def make_values(vkind, n, seed=1):
    """value_arrays' scenes in 3-D (a quarter duplicates: ties)."""
    return convert.geometry_from_numpy(vkind, value_arrays(vkind, n, 3,
                                                           seed), CPU)


def make_queries(qkind, q, seed=2):
    return convert.geometry_from_numpy(qkind, query_arrays(qkind, 3, q,
                                                           seed), CPU)


def index_of(values):
    return BVH(values, policy=ExecutionPolicy(device=CPU))


def assert_model_is_twin(values, queries, k):
    index = index_of(values)
    tree = index.tree
    stats = {}
    want = twin(tree, index.values, queries, k, stats)
    got_d, got_i, flags, visits = model(tree, index.values, queries, k)
    np.testing.assert_array_equal(got_d.view(np.int32),
                                  want[0].view(np.int32))
    np.testing.assert_array_equal(got_i, want[1])
    return flags, visits, stats["visits"]


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("qkind", QUERY_KINDS)
@pytest.mark.parametrize("vkind", VALUE_KINDS)
def test_transcription_equals_the_rope_walk(vkind, qkind, k):
    """The kernel's algorithm gives the twin's lists bit for bit, ties
    and (inf, -1) padding included; flags stay rare on generic scenes and
    never arise where delta is 0 (Tetrahedra, KDOPs)."""
    flags, _, _ = assert_model_is_twin(make_values(vkind, N),
                                       make_queries(qkind, Q), k)
    if vkind in ("tetrahedra", "kdops"):
        assert flags == []
    assert len(flags) <= Q // 4


@pytest.mark.parametrize("vkind", VALUE_KINDS)
def test_nearest_first_visits_fewer_nodes(vkind):
    """The point of the design: nearest first visits fewer nodes than the
    rope walk, whose first k leaves lie far from the query."""
    values = make_values(vkind, 400)
    queries = make_queries("points", Q)
    _, visits, rope_visits = assert_model_is_twin(values, queries, 10)
    assert visits < rope_visits


def _poisoned(vkind, how):
    """A scene with a NaN or +-inf coordinate in one value and in one
    query (a NaN sphere radius, an infinite vertex)."""
    arrays = value_arrays(vkind, N, 3)
    qarr = query_arrays("points", 3, Q)
    bad = np.float32(np.nan if how == "nan" else np.inf)
    arrays[0][N // 2, 0] = bad
    if how == "inf":
        arrays[0][3, 2] = -bad
    qarr[0][Q // 2, 1] = bad
    return (convert.geometry_from_numpy(vkind, arrays, CPU),
            convert.geometry_from_numpy("points", qarr, CPU))


@pytest.mark.parametrize("how", ["nan", "inf"])
@pytest.mark.parametrize("vkind", VALUE_KINDS)
def test_transcription_with_nan_and_inf(vkind, how):
    """NaN and +-inf in the values and the queries: a NaN key prunes in
    both walks, an infinite scene makes delta infinite (no pruning by tau,
    the lists still the twin's)."""
    values, queries = _poisoned(vkind, how)
    for k in (1, 10):
        assert_model_is_twin(values, queries, k)


def test_spheres_with_a_negative_radius():
    """A negative radius inverts the sphere's box, whose key then exceeds
    the fine distance by a share of |r|: delta's rneg term keeps the
    lists the twin's."""
    arrays = value_arrays("spheres", N, 3)
    arrays[1][5] = -0.08
    arrays[1][17] = -0.02
    values = convert.geometry_from_numpy("spheres", arrays, CPU)
    for qkind in ("points", "spheres"):
        for k in (1, 10):
            assert_model_is_twin(values, make_queries(qkind, Q), k)


# ---------------------------------------------------------------------------
# a constructed straddle
# ---------------------------------------------------------------------------

def straddle_instances(count, seed=0):
    """(a, b, c, q) (count, 3) float32 of anomalous triangles (c, b, a)
    for the points q: a is the triangle's box's lo corner, q lies below
    it, and the edges ending at a (the segments' fma(1, a - x, x), with
    a - x inexact: b and c lie more than 2a away) round the vertex toward
    q, so that the fine distance d falls below the box key kb. The point
    a itself, as a degenerate triangle, lies at distance kb from q in the
    same float order. Found by a seeded search in the walk's order."""
    rng = np.random.default_rng(seed)
    m = 8 * count
    a = rng.uniform(0.05, 0.1, (m, 3)).astype(np.float32)
    b = (a + rng.uniform(0.2, 0.6, (m, 3))).astype(np.float32)
    c = (a + rng.uniform(0.2, 0.6, (m, 3))).astype(np.float32)
    q = (a - rng.uniform(0.0005, 0.02, (m, 3))).astype(np.float32)
    t = [torch.from_numpy(x) for x in (a, b, c, q)]
    pred = TP.nearest(TG.Points(t[3]), 1)
    tri = TG.Triangles(t[2], t[1], t[0])
    d = TP.leaf_distance(pred, tri, "walk")
    box = TG.to_boxes(tri)
    kb = TP.node_min_distance(pred, box.lo, box.hi)
    dp = TP.leaf_distance(pred, TG.Triangles(t[0], t[0], t[0]), "walk")
    keep = ((d < kb) & (dp == kb)).numpy()
    assert keep.sum() >= count
    return [x[keep][:count] for x in (a, b, c, q)]


def test_a_straddle_needs_the_certificate():
    """Triangle A = (c, b, a) is anomalous for the query, and B, the point
    a, lies at d_B = kb_A and first in the leaf order (its centroid lies
    below A's in every coordinate). The rope walk admits B, then rejects
    A, whose box key is not below tau; nearest first keeps A, the nearer
    by fine distance: without the certificate its list differs from the
    twin's. The certificate flags the query (A is anomalous and its box
    key is at least lost = d_B), and its re-walk is the twin's."""
    a, b, c, q = (x[0] for x in straddle_instances(1))
    values = TG.Triangles(*(torch.from_numpy(np.stack(v)) for v in
                            ((a, c), (a, b), (a, a))))
    queries = TG.Points(torch.from_numpy(q[None]))
    index = index_of(values)
    tree = index.tree
    assert tree.leaf_perm.tolist() == [0, 1]
    want = twin(tree, index.values, queries, 1)
    assert want[1].tolist() == [[0]]
    bare = model(tree, index.values, queries, 1, certificate=False)
    assert bare[1].tolist() == [[1]] and bare[0][0, 0] < want[0][0, 0]
    got = model(tree, index.values, queries, 1)
    assert got[2] == [0]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("k", [1, 4, 10])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_transcription_on_straddle_scenes(seed, k):
    """Forty straddles in one scene (anomalous triangles and their near
    vertices as points, overlapping), queries below the near vertices:
    where the bare nearest-first list differs from the twin's the query
    is flagged, and the lists with the re-walk are the twin's."""
    a, b, c, q = straddle_instances(40, seed)
    values = TG.Triangles(*(torch.from_numpy(np.concatenate(v))
                            for v in ((c, a), (b, a), (a, a))))
    queries = TG.Points(torch.from_numpy(q[:Q]))
    index = index_of(values)
    tree = index.tree
    want = twin(tree, index.values, queries, k)
    bare = model(tree, index.values, queries, k, certificate=False)
    got = model(tree, index.values, queries, k)
    np.testing.assert_array_equal(got[0].view(np.int32),
                                  want[0].view(np.int32))
    np.testing.assert_array_equal(got[1], want[1])
    differ = np.flatnonzero((bare[1] != want[1]).any(1)
                            | (bare[0] != want[0]).any(1))
    assert set(differ.tolist()) <= set(got[2])
    if k == 1:
        assert len(differ) >= 1


# ---------------------------------------------------------------------------
# delta against the walk's functions
# ---------------------------------------------------------------------------

def _adversarial(kind, m, rng, offset):
    """m values of `kind` near `offset`: slivers (a vertex within 1e-7 of
    the opposite edge), zero-length segments and point triangles, and a
    quarter wide ones whose far vertices lie more than twice as far from
    0 as the near one (the segments' fma(1, a - x, x) then rounds)."""
    base = offset + rng.uniform(0, 1, (m, 3))
    if kind == "spheres":
        return [base, rng.uniform(0.0, 0.2, m)]
    a = base
    b = a + rng.uniform(-0.1, 0.1, (m, 3))
    wide = slice(3, None, 4)
    a[wide] = offset + rng.uniform(0.05, 0.1, a[wide].shape)
    b[wide] = a[wide] + rng.uniform(0.2, 0.6, a[wide].shape)
    if kind == "segments":
        b[::4] = a[::4]                                   # zero length
        return [b, a]
    t = rng.uniform(0, 1, (m, 1))
    c = a + t * (b - a) + rng.normal(0, 1e-7, (m, 3))     # slivers
    c[1::4] = a[1::4] + rng.uniform(-0.1, 0.1, c[1::4].shape)
    c[2::4] = b[2::4] = a[2::4]                           # a point
    c[wide] = a[wide] + rng.uniform(0.2, 0.6, a[wide].shape)
    return [c, b, a]


def _queries_on_axes(verts, rng, q):
    """Points on the axis lines through the values' vertices (two
    coordinates a vertex's, one moved), points off a vertex's corner, and
    points just below the near vertices of the wide values."""
    v = np.concatenate(verts)[rng.integers(0, sum(len(x) for x in verts),
                                           q)]
    p = v.copy()
    axis = rng.integers(0, 3, q)
    p[np.arange(q), axis] += rng.uniform(-0.2, 0.2, q)
    p[::3] = v[::3] + rng.uniform(-0.05, 0.05, p[::3].shape)
    near = verts[-1][3::4]
    p[1::3][:len(near)] = (near[:len(p[1::3])]
                           - rng.uniform(0.0005, 0.02, (len(p[1::3]), 3))
                           [:len(near)])
    return p


@pytest.mark.parametrize("offset", [0.0, 1e3])
@pytest.mark.parametrize("kind", ["triangles", "segments", "spheres"])
def test_delta_bounds_how_far_a_fine_distance_rounds_below_its_box(kind,
                                                                   offset):
    """kb - d <= delta on every (query, value) pair, the float32 values of
    the walk's functions compared in float64, delta from the pair's own
    magnitudes (the kernel's root box holds the value's, so its delta is
    at least this one). The bound is not empty: anomalous pairs (d < kb)
    occur near 0 (at 1e3 every difference of the near vertices is exact),
    and the largest gap stays within the note's bound in units of u M."""
    rng = np.random.default_rng(11 if offset else 12)
    m = 64
    arrays = [np.asarray(x, np.float32)
              for x in _adversarial(kind, m, rng, offset)]
    verts = arrays if kind != "spheres" else arrays[:1]
    pts = np.asarray(_queries_on_axes(verts, rng, 96), np.float32)
    values = convert.geometry_from_numpy(kind, arrays, CPU)
    rows = torch.arange(len(pts)).repeat_interleave(m)
    cols = torch.arange(m).repeat(len(pts))
    pred = TP.nearest(TG.Points(torch.from_numpy(pts)[rows]), 1)
    vals = value_at(values, cols)
    box = TG.to_boxes(vals)
    d = TP.leaf_distance(pred, vals, "walk").double().numpy()
    kb = TP.node_min_distance(pred, box.lo, box.hi).double().numpy()
    mag = np.maximum(np.abs(pts[rows.numpy()]).max(1),
                     np.maximum(np.abs(box.lo.numpy()),
                                np.abs(box.hi.numpy())).max(1))
    delta = 2.0 ** -17 * 3 * mag + 2.0 ** -64
    gap = kb - d
    assert (gap <= delta).all(), float((gap / delta).max())
    if kind != "spheres" and offset == 0.0:
        assert (gap > 0).any()
    # the bound's margin: the largest gap in units of u M stays far below
    # the 384 u M of delta (52 u M is the note's bound in 3-D)
    assert float((gap / (2.0 ** -24 * mag)).max()) <= 52


# ---------------------------------------------------------------------------
# the kernel on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 4, 33])
def test_straddles_on_the_card(cuda_device, k):
    """The kernel on straddle scenes: the flagged queries are counted on
    the card (at k = 1 every straddle's query), their rows come from the
    rope walk, and every list is the twin's bit for bit."""
    a, b, c, q = straddle_instances(40)
    arrays = [np.concatenate(v) for v in ((c, a), (b, a), (a, a))]
    host = TG.Triangles(*map(torch.from_numpy, arrays))
    values = TG.Triangles(*(torch.from_numpy(x).to(cuda_device)
                            for x in arrays))
    index = BVH(values, policy=ExecutionPolicy(device=cuda_device))
    t = index.tree
    got = BT.bvh_traverse_fine_knn(
        t.node_lo, t.node_hi, t.rope, t.left_child, t.leaf_perm, values,
        TG.Points(torch.from_numpy(q).to(cuda_device)), k=k,
        records=t.records, value_records=index.value_records)
    flagged = int(BT.bvh_traverse_fine_knn.flagged.item())
    want = BT.bvh_traverse_fine_knn_ref(
        *(x.cpu() for x in (t.node_lo, t.node_hi, t.rope, t.left_child,
                            t.leaf_perm)), host,
        TG.Points(torch.from_numpy(q)), k=k)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])
    if k == 1:
        assert flagged >= 1
