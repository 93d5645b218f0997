"""BVH traversal kernels: spatial count + fill, and k-nearest.

The kernels, each with its plain PyTorch twin beside it:

  * ``bvh_traverse_spatial``: Intersects queries in the unified
    (q_lo, q_hi, r) form (a point is a box with r = 0, a sphere a point
    box with r > 0). A node matches when the squared box-to-box distance
    is <= r*r and its ``range_last`` passes the ``min_pos`` pair filter;
    with ``fine_sqrt`` (Points values) a leaf also needs sqrt(d2) <= r.
    Returns full counts and the first `capacity` matched original indices
    in traversal order, -1 padded.
  * ``bvh_traverse_knn``: k nearest leaves by squared point-to-box
    distance, pruned strictly against the running k-th best, with a
    sorted insert that places ties after equal entries; sqrt at the end.
    Since the rope walk reaches leaves in ascending sorted-leaf position,
    its list is the k smallest leaves by the key (d2, position), padded
    with (inf, -1): that key is the contract, whatever the visit order.
  * ``bvh_traverse_ray_knn``: the first k hits along each ray
    (``RayNearest``): the same rope walk with the ray parameter t as the
    key, the slab-entry t of a node box (+inf on a miss) and the hit t of
    a leaf (``predicates.leaf_distance`` with ``fused=True``), over Points,
    Boxes, Spheres or 3-D Triangles values. Its twin is
    ``core.traversal.knn_walk``, the reference's ``traverse_knn``, which
    the reference compiles for ``RayNearest`` with no kernel of its own.
  * ``bvh_traverse_fine_knn``: k nearest Spheres, Triangles, Segments,
    Tetrahedra or KDOPs values by their FINE distance from the query
    centroids (``predicates.leaf_distance`` in the "walk" order), keyed
    at a node by ``predicates.node_min_distance``: the rope walk of the
    reference's compiled ``traverse_knn`` (``core.traversal.knn_walk``,
    its twin), which the reference runs for these values with no kernel
    of its own.
  * ``bvh_traverse_knn_exclude``: k nearest Points queries over Points or
    Boxes values outside the query's label (``Nearest.exclude``, EMST's
    component exclusion), keyed like the reference's loop walk
    (``traversal.traverse_knn``), which the reference compiles for it with
    no kernel of its own: the fine distance sqrt(d2) of the node test, +inf
    for a leaf whose label is the query's and for a node whose leaves all
    carry it (:func:`node_labels`). Pruning such a node changes nothing,
    since no leaf below it is a candidate; its twin prunes them too.

A CPU tensor takes the twin (``*_ref``), which walks every query's cursor
step by step until all are -1, the node sequence of the rope walk. A CUDA
tensor launches ``csrc/bvh_traverse.cu``; any other device raises. The
spatial kernel runs the rope walk, one thread per query; in 3-D it reads
the tree's node records (:func:`pack_nodes`, ``LBVH.records``: two
16-byte loads a node, the leaf's original index in the second),
``range_last`` only where a query's ``min_pos`` is >= 0, and nothing
more at a leaf (the node test at a leaf is the leaf test); other dims
read the flat arrays. A caller may give the order in which its threads
take the queries (the engine gives the tree's leaf order when the
queries are centred on the indexed points, ``bvh_callback.query_order``);
outputs stay in the caller's rows. The kNN kernel
walks nearest first with a stack and orders its list by (d2, position)
(``csrc/knn_list.cuh``), which gives the twin's lists bit for bit in
another visit order; in 3-D it reads the tree's packed node records
(:func:`pack_nodes`, kept as ``LBVH.records``), and a caller may give the
order in which its threads take the queries (:func:`knn_order`: the
tree's leaf order when the queries are the indexed points); outputs stay
in the caller's rows. The ray kNN kernel (``csrc/ray_knn.cu``), one thread a
ray, walks the twin's node sequence over Spheres and Triangles (and in
other dims), so its lists are the twin's by construction, and over
Points and Boxes in 3-D walks nearest first with the point kNN kernel's
stack and tie pass; in 3-D it reads the node records and, for Spheres
and Triangles, the leaves' value records (:func:`pack_values`, kept as
``BVH.value_records``). The fine kNN kernel (``csrc/fine_knn.cu``) walks
nearest first, one thread a query, with the fine distance as the list key
and a slack on the node keys, and proves each list equal to the twin's
with a certificate; the rope walk re-walks the queries that fail it, on
the card, so the lists are the twin's bit for bit; in 3-D it reads the
node records and the value records of Spheres, Triangles and Segments (a
Tetrahedra or KDOPs leaf's distance is its node box's). The twins and the
kernels sum the per-dimension squares in the same fixed order
(``geometry.sum_sq_fused``: the first square, then one fused multiply-add
per further dimension, as XLA:CPU runs the reference kernels) and the
kernels allow no other contraction, so counts, buffers and distances
agree bit for bit; ray t too, the leaf tests taking the "walk" float
order (``csrc/ray_tests.cuh``). Under ``REPRO_SANITIZE`` each wrapper
checks its output contract (``sanitize.check_spatial`` / ``check_knn``).
"""
from __future__ import annotations

import ctypes

import torch

from ..core import geometry as G
from ..core import predicates as P
from ..core import traversal
from ..core.geometry import sqrt, sum_sq_fused
from . import _build, sanitize

__all__ = ["bvh_traverse_spatial", "bvh_traverse_knn", "bvh_traverse_ray_knn",
           "bvh_traverse_knn_exclude", "bvh_traverse_fine_knn",
           "bvh_traverse_fine_knn_rope",
           "bvh_traverse_spatial_ref", "bvh_traverse_knn_ref",
           "bvh_traverse_ray_knn_ref", "bvh_traverse_knn_exclude_ref",
           "bvh_traverse_fine_knn_ref", "node_labels", "pack_nodes",
           "pack_values", "knn_order", "RAY_TARGETS", "FINE_KNN_VALUES",
           "FINE_KNN_RECORDS",
           "KNN_MAX_K", "MAX_DIM", "STACK_DEPTH", "MIXED"]

#: largest k the kNN kernel takes (its largest template bucket)
KNN_MAX_K = 256
#: largest dimension the kernels take (query coordinates live in registers)
MAX_DIM = 16
#: entries of the kNN walks' stack (kStack of csrc/knn_walk.cuh): the
#: walk stacks internal nodes only, at most one per depth 1..95, and the
#: tree's internal nodes lie at depths 0..95 (csrc/bvh_traverse.cu's note)
STACK_DEPTH = 96
#: value geometries the ray walks take (Triangles in 3-D only)
RAY_TARGETS = (G.Points, G.Boxes, G.Spheres, G.Triangles)
#: value geometries of the fine kNN walk (the kNN kernel takes Points and
#: Boxes, whose fine distance is their box distance)
FINE_KNN_VALUES = (G.Spheres, G.Triangles, G.Segments, G.Tetrahedra,
                   G.KDOPs)
#: those whose value records the fine kNN walk reads in 3-D (a
#: tetrahedron's or a k-DOP's distance is its node box's)
FINE_KNN_RECORDS = (G.Spheres, G.Triangles, G.Segments)
#: the tree arrays the kNN kernels take, in their C entries' order
_TREE = ("node_lo", "node_hi", "rope", "left_child", "leaf_perm")
#: node_labels' label of an internal node whose leaves carry more than one
#: label; an internal node labelled MIXED is never excluded, so a label of
#: -1 is only ever excluded leaf by leaf
MIXED = -1


# ---------------------------------------------------------------------------
# plain twins
# ---------------------------------------------------------------------------

def bvh_traverse_spatial_ref(node_lo, node_hi, rope, left_child, range_last,
                             leaf_perm, q_lo, q_hi, radius, *,
                             capacity: int = 1, fine_sqrt: bool = False,
                             min_pos=None, stats: dict | None = None):
    """Batched rope walk with the kernel's semantics. `stats`, when given,
    receives ``visits``: the node visits of all queries together."""
    q = q_lo.shape[0]
    n = leaf_perm.shape[0]
    dev = q_lo.device
    r = radius.to(torch.float32)
    r2 = r * r
    mp = (torch.full((q,), -1, dtype=torch.int32, device=dev)
          if min_pos is None else min_pos)
    rope = rope.to(torch.int64)
    left = left_child.to(torch.int64)
    perm = leaf_perm.to(torch.int32)
    node = torch.zeros((q,), dtype=torch.int64, device=dev)
    cnt = torch.zeros((q,), dtype=torch.int32, device=dev)
    buf = torch.full((q, capacity), -1, dtype=torch.int32, device=dev)
    visits = 0
    while True:
        act = torch.nonzero(node != -1).squeeze(1)
        if act.numel() == 0:
            break
        visits += act.numel()
        nd = node[act]
        lo, hi = node_lo[nd], node_hi[nd]
        g = torch.clamp_min(torch.maximum(q_lo[act] - hi, lo - q_hi[act]), 0.0)
        d2 = sum_sq_fused(g)
        overlap = (d2 <= r2[act]) & (range_last[nd] > mp[act])
        is_leaf = nd >= n - 1
        hit = is_leaf & overlap
        if fine_sqrt:
            hit = hit & (sqrt(d2) <= r[act])
        hq = act[hit]
        c = cnt[hq].to(torch.int64)
        keep = c < capacity
        buf[hq[keep], c[keep]] = perm[nd[hit][keep] - (n - 1)]
        cnt[hq] += 1
        descend = overlap & ~is_leaf
        node[act] = torch.where(descend, left[torch.clamp_max(nd, n - 2)],
                                rope[nd])
    if stats is not None:
        stats["visits"] = visits
    return cnt, buf


def _rope_knn(node_lo, node_hi, rope, left_child, leaf_perm, queries, k,
              key, stats):
    """The kNN rope walk of the kernels' twins: (keys, idxs) (Q, k)
    ascending, (+inf, -1) padded. ``key(nodes, rows, d2)`` maps the
    squared point-to-box distances (the fused order) of the visited nodes
    to the walk's key; a node is entered, and a leaf admitted, while its
    key is strictly below the running k-th, and a leaf is placed before
    the equal keys."""
    q = queries.shape[0]
    n = leaf_perm.shape[0]
    dev = queries.device
    rope = rope.to(torch.int64)
    left = left_child.to(torch.int64)
    perm = leaf_perm.to(torch.int32)
    node = torch.zeros((q,), dtype=torch.int64, device=dev)
    keys = torch.full((q, k), float("inf"), dtype=torch.float32, device=dev)
    idxs = torch.full((q, k), -1, dtype=torch.int32, device=dev)
    ar = torch.arange(k, device=dev)
    visits = 0
    while True:
        act = torch.nonzero(node != -1).squeeze(1)
        if act.numel() == 0:
            break
        visits += act.numel()
        nd = node[act]
        qc = queries[act]
        g = torch.clamp_min(torch.maximum(node_lo[nd] - qc, qc - node_hi[nd]),
                            0.0)
        kk = key(nd, act, sum_sq_fused(g))
        promising = kk < keys[act, k - 1]             # strict prune
        is_leaf = nd >= n - 1
        ok = is_leaf & promising
        rows = act[ok]
        if rows.numel():
            dd = kk[ok][:, None]
            oi = perm[nd[ok] - (n - 1)][:, None]
            cur_d, cur_i = keys[rows], idxs[rows]
            at = (cur_d < dd).sum(1, keepdim=True)    # ties land after
            shift_d = torch.cat([dd, cur_d[:, :-1]], 1)
            shift_i = torch.cat([oi, cur_i[:, :-1]], 1)
            keys[rows] = torch.where(ar < at, cur_d,
                                     torch.where(ar == at, dd, shift_d))
            idxs[rows] = torch.where(ar < at, cur_i,
                                     torch.where(ar == at, oi, shift_i))
        descend = promising & ~is_leaf
        node[act] = torch.where(descend, left[torch.clamp_max(nd, n - 2)],
                                rope[nd])
    if stats is not None:
        stats["visits"] = visits
    return keys, idxs


def bvh_traverse_knn_ref(node_lo, node_hi, rope, left_child, leaf_perm,
                         queries, *, k: int, stats: dict | None = None):
    """Batched kNN rope walk with the kernel's semantics, keyed by d2;
    (dists, idxs) (Q, k) ascending, (inf, -1) padded."""
    d2s, idxs = _rope_knn(node_lo, node_hi, rope, left_child, leaf_perm,
                          queries, k, lambda nd, act, d2: d2, stats)
    return sqrt(d2s), idxs


def node_labels(leaf_labels, leaf_perm, range_first, range_last):
    """(2N-1,) int32 node labels of an LBVH for the exclusion walk: a
    leaf's is its value's label, an internal node's the one label its
    leaves all carry, else ``MIXED``. With ``ls`` the labels in sorted-leaf
    order and ``brk[p]`` the count of label changes up to position p, the
    node covering [range_first, range_last] is uniform iff ``brk`` is equal
    at both ends: plain tensor operations, no walk."""
    n = leaf_perm.shape[0]
    ls = leaf_labels[leaf_perm.to(torch.int64)].to(torch.int32)
    brk = torch.zeros((n,), dtype=torch.int32, device=ls.device)
    brk[1:] = torch.cumsum(ls[1:] != ls[:-1], 0, dtype=torch.int32)
    first = range_first.to(torch.int64)
    last = range_last[:n - 1].to(torch.int64)
    inner = torch.where(brk[last] == brk[first], ls[first], MIXED)
    return torch.cat([inner.to(torch.int32), ls])


def bvh_traverse_knn_exclude_ref(node_lo, node_hi, rope, left_child,
                                 leaf_perm, range_first, range_last, queries,
                                 query_labels, leaf_labels, *, k: int,
                                 stats: dict | None = None):
    """The exclusion kernel's twin: the rope walk keyed by sqrt(d2) (the
    reference loop walk's fine distance) and +inf where the node's label
    (:func:`node_labels`) excludes it: a leaf whose label is the query's,
    an internal node whose leaves all carry it. (dists, idxs) (Q, k)
    ascending, (inf, -1) padded."""
    n = leaf_perm.shape[0]
    labels = node_labels(leaf_labels, leaf_perm, range_first, range_last)
    ql = query_labels.to(torch.int32)

    def key(nd, act, d2):
        lab = labels[nd]
        out = (lab == ql[act]) & ((nd >= n - 1) | (lab != MIXED))
        return torch.where(out, float("inf"), sqrt(d2))

    return _rope_knn(node_lo, node_hi, rope, left_child, leaf_perm, queries,
                     k, key, stats)


def bvh_traverse_ray_knn_ref(node_lo, node_hi, rope, left_child, leaf_perm,
                             values, rays, *, k: int,
                             stats: dict | None = None):
    """The ray kNN kernel's plain twin: the batched k-nearest walk of
    ``RayNearest(rays, k)`` (``core.traversal.knn_walk``); (t, idxs)
    (R, k) ascending, (inf, -1) padded. `stats`, when given, receives
    ``visits``: the node visits of all rays together."""
    return traversal.knn_walk(node_lo, node_hi, rope, left_child, leaf_perm,
                              values, P.RayNearest(rays, k), k, stats=stats)


def bvh_traverse_fine_knn_ref(node_lo, node_hi, rope, left_child, leaf_perm,
                              values, queries, *, k: int,
                              stats: dict | None = None):
    """The fine kNN kernel's plain twin: the batched k-nearest walk of
    ``Nearest(queries, k)`` (``core.traversal.knn_walk``); (dists, idxs)
    (Q, k) ascending, (inf, -1) padded. `stats`, when given, receives
    ``visits``: the node visits of all queries together."""
    return traversal.knn_walk(node_lo, node_hi, rope, left_child, leaf_perm,
                              values, P.Nearest(queries, k), k, stats=stats)


# ---------------------------------------------------------------------------
# what the kNN kernels read besides the tree
# ---------------------------------------------------------------------------

def pack_nodes(node_lo, node_hi, rope, left_child, leaf_perm):
    """(2N-1, 8) int32 node records of a 3-D tree: node k is (lo.xyz,
    rope) then (hi.xyz, left child for an internal node, leaf_perm of the
    leaf's position for a leaf), the floats bit-cast to int32."""
    link = torch.cat([left_child, leaf_perm])
    return torch.cat([node_lo.view(torch.int32), rope[:, None],
                      node_hi.view(torch.int32), link[:, None]], 1)


#: int32 columns of a value record row (pack_values): four per vertex or
#: sphere, the first vertex's fourth the original index
_RECORD_COLS = {G.Spheres: 4, G.Segments: 8, G.Triangles: 12,
                G.Tetrahedra: 16}


def pack_values(values, leaf_perm):
    """The 16-byte value records of a 3-D tree's leaves in sorted-leaf
    order, which the 3-D walks read in place of a ``leaf_perm`` gather, as
    int32 (the floats bit-cast): Spheres (N, 4), (c.xyz, r) per leaf;
    Segments (N, 8), Triangles (N, 12) and Tetrahedra (N, 16), one record
    (v.xyz, 0) per vertex, the first holding the original index in place of
    the 0. None for Points, Boxes and KDOPs, whose leaf test is their box,
    the node test at the leaf, and in other dims. One gather of the values
    and one concatenation: 16 bytes a sphere or vertex."""
    if values.dim != 3 or type(values) not in _RECORD_COLS:
        return None
    perm = leaf_perm.to(torch.int64)
    if isinstance(values, G.Spheres):
        return torch.cat([values.center[perm].view(torch.int32),
                          values.radius[perm].view(torch.int32)[:, None]], 1)
    zero = torch.zeros((perm.shape[0], 1), dtype=torch.int32,
                       device=perm.device)
    verts = [getattr(values, f) for f in ("a", "b", "c", "d")
             if hasattr(values, f)]
    cols = []
    for j, v in enumerate(verts):
        cols += [v[perm].view(torch.int32),
                 leaf_perm.to(torch.int32)[:, None] if j == 0 else zero]
    return torch.cat(cols, 1)


def knn_order(queries, values_coords, leaf_perm):
    """(Q,) int32 order in which the kNN kernel's threads take the queries:
    the tree's `leaf_perm` (the stable sort of the points' 64-bit Morton
    codes in the tree's root box) when the queries are the indexed points
    themselves (the same tensor as `values_coords`), else None (the
    caller's order). Outputs stay in the caller's rows either way."""
    if values_coords is None:
        return None
    same = (queries.data_ptr() == values_coords.data_ptr()
            and queries.shape == values_coords.shape
            and queries.stride() == values_coords.stride())
    return leaf_perm if same else None


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _device_of(t: torch.Tensor, what: str) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: no kernel for device {t.device}")
    return t.device.type


def _args(dev, what, **tensors):
    """Validate dtype/device and return contiguous tensors (float32 boxes
    and queries, int32 tree indices)."""
    out = {}
    for name, t in tensors.items():
        want = torch.float32 if name in ("node_lo", "node_hi", "q_lo", "q_hi",
                                         "radius", "queries") else torch.int32
        if t.device != dev:
            raise ValueError(f"{what}: {name} is on {t.device}, not {dev}")
        if t.dtype != want:
            raise ValueError(f"{what}: {name} must be {want}, got {t.dtype}")
        out[name] = t.contiguous()
    return out


def _check_tree(what, n, dim, node_lo, node_hi, rope, left_child, leaf_perm):
    m = 2 * n - 1
    if n < 2:
        raise ValueError(f"{what}: the kernel needs a tree of N >= 2 leaves")
    if not 1 <= dim <= MAX_DIM:
        raise ValueError(f"{what}: dim {dim} outside [1, {MAX_DIM}]")
    if (node_lo.shape != (m, dim) or node_hi.shape != (m, dim)
            or rope.shape != (m,) or left_child.shape != (n - 1,)):
        raise ValueError(f"{what}: tree arrays do not describe {n} leaves "
                         f"in {dim} dimensions")


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _ptr(t):
    return None if t is None else t.data_ptr()


_SPATIAL_ARGS = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 5
                 + [ctypes.c_void_p] * 3)
_KNN_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3


def bvh_traverse_spatial(node_lo, node_hi, rope, left_child, range_last,
                         leaf_perm, q_lo, q_hi, radius, *, capacity: int = 1,
                         fine_sqrt: bool = False, min_pos=None, records=None,
                         order=None):
    """(counts (Q,) int32, idx_buf (Q, capacity) int32) for Q spatial
    queries over an LBVH's arrays. See the module docstring for the
    semantics. `records`: the tree's :func:`pack_nodes` records where the
    caller keeps them (``LBVH.records``); a 3-D call on the card makes
    them otherwise. `order`: a (Q,) int32 permutation of the queries in
    which the 3-D kernel's threads take them, or None; each row must
    appear once, since a row it leaves out is never written
    (``REPRO_SANITIZE`` checks it). Neither changes a result."""
    what = "bvh_traverse_spatial"
    if capacity < 1:
        raise ValueError(f"{what}: capacity must be >= 1, got {capacity}")
    if _device_of(q_lo, what) == "cpu":
        counts, buf = bvh_traverse_spatial_ref(
            node_lo, node_hi, rope, left_child, range_last, leaf_perm, q_lo,
            q_hi, radius, capacity=capacity, fine_sqrt=fine_sqrt,
            min_pos=min_pos)
    else:
        counts, buf = _spatial_launch(
            what, node_lo, node_hi, rope, left_child, range_last, leaf_perm,
            q_lo, q_hi, radius, capacity, fine_sqrt, min_pos, records, order)
    sanitize.check_spatial(counts, buf, n=leaf_perm.shape[0], kernel=what)
    return counts, buf


def _check_order(what, order, q, dev):
    if order is not None and (order.shape != (q,) or order.dtype != torch.int32
                              or order.device != dev
                              or not order.is_contiguous()):
        raise ValueError(f"{what}: order must be a contiguous ({q},) int32 "
                         f"permutation on {dev}")
    sanitize.check_order(order, q=q, kernel=what)


def _spatial_launch(what, node_lo, node_hi, rope, left_child, range_last,
                    leaf_perm, q_lo, q_hi, radius, capacity, fine_sqrt,
                    min_pos, records, order):
    dev = q_lo.device
    q, dim = q_lo.shape
    n = leaf_perm.shape[0]
    extra = {} if min_pos is None else {"min_pos": min_pos.to(torch.int32)}
    a = _args(dev, what, node_lo=node_lo, node_hi=node_hi, rope=rope,
              left_child=left_child, range_last=range_last,
              leaf_perm=leaf_perm, q_lo=q_lo, q_hi=q_hi, radius=radius,
              **extra)
    _check_tree(what, n, dim, a["node_lo"], a["node_hi"], a["rope"],
                a["left_child"], a["leaf_perm"])
    if (a["q_hi"].shape != (q, dim) or a["radius"].shape != (q,)
            or ("min_pos" in a and a["min_pos"].shape != (q,))
            or a["range_last"].shape != (2 * n - 1,)):
        raise ValueError(f"{what}: query arrays must be (Q, dim) and (Q,)")
    if dim == 3:
        records = _kept_records(what, [a[f] for f in _TREE], None, records,
                                None, dev, False)[0]
    elif order is not None:
        raise ValueError(f"{what}: an order is taken in 3-D only")
    else:
        records = None
    _check_order(what, order, q, dev)
    counts = torch.empty((q,), dtype=torch.int32, device=dev)
    buf = torch.empty((q, capacity), dtype=torch.int32, device=dev)
    if q == 0:
        return counts, buf
    fn = _build.function("bvh_traverse", "bvh_spatial_launch", _SPATIAL_ARGS)
    with torch.cuda.device(dev):
        err = fn(*(a[k].data_ptr() for k in (
                     "node_lo", "node_hi", "rope", "left_child", "range_last",
                     "leaf_perm")), _ptr(records), _ptr(order),
                 *(a[k].data_ptr() for k in ("q_lo", "q_hi", "radius")),
                 _ptr(a.get("min_pos")), n, q, dim, capacity, int(fine_sqrt),
                 counts.data_ptr(), buf.data_ptr(), _stream(dev))
    _build.check("bvh_traverse", err, what)
    bvh_traverse_spatial.launches += 1
    return counts, buf


def bvh_traverse_knn(node_lo, node_hi, rope, left_child, leaf_perm, queries,
                     *, k: int, records=None, order=None):
    """(dists, idxs) (Q, k) float32/int32, ascending, (inf, -1) padded,
    for Q query points. `records`: the tree's :func:`pack_nodes` records
    where the caller keeps them (``LBVH.records``); a 3-D call on the card
    makes them otherwise. `order`: a (Q,) permutation of the queries in
    which the kernel's threads take them (:func:`knn_order`), or None;
    each row must appear once (``REPRO_SANITIZE`` checks it). Neither
    changes a result."""
    what = "bvh_traverse_knn"
    if k < 1:
        raise ValueError(f"{what}: k must be >= 1, got {k}")
    if _device_of(queries, what) == "cpu":
        dists, idxs = bvh_traverse_knn_ref(node_lo, node_hi, rope,
                                           left_child, leaf_perm, queries, k=k)
    else:
        dists, idxs = _knn_launch(what, node_lo, node_hi, rope, left_child,
                                  leaf_perm, queries, k, records, order)
    sanitize.check_knn(dists, idxs, n=leaf_perm.shape[0], kernel=what)
    return dists, idxs


def _knn_launch(what, node_lo, node_hi, rope, left_child, leaf_perm, queries,
                k, records, order, labels=None):
    """Launch the kNN kernel, or with `labels` = (range_first, range_last,
    query_labels, leaf_labels) its exclusion instance."""
    if k > KNN_MAX_K:
        raise ValueError(f"{what}: k={k} above the kernel's cap {KNN_MAX_K}")
    dev = queries.device
    q, dim = queries.shape
    n = leaf_perm.shape[0]
    extra = {} if labels is None else dict(zip(
        ("range_first", "range_last", "query_labels", "leaf_labels"), labels))
    a = _args(dev, what, node_lo=node_lo, node_hi=node_hi, rope=rope,
              left_child=left_child, leaf_perm=leaf_perm, queries=queries,
              **extra)
    _check_tree(what, n, dim, a["node_lo"], a["node_hi"], a["rope"],
                a["left_child"], a["leaf_perm"])
    if labels is not None and (
            a["range_first"].shape != (n - 1,)
            or a["range_last"].shape != (2 * n - 1,)
            or a["query_labels"].shape != (q,)
            or a["leaf_labels"].shape != (n,)):
        raise ValueError(f"{what}: ranges (N-1,) and (2N-1,), labels (Q,) "
                         "and (N,) expected")
    records = None if dim != 3 else _kept_records(
        what, [a[f] for f in _TREE], None, records, None, dev, False)[0]
    _check_order(what, order, q, dev)
    dists = torch.empty((q, k), dtype=torch.float32, device=dev)
    idxs = torch.empty((q, k), dtype=torch.int32, device=dev)
    if q == 0:
        return dists, idxs
    ptrs = [a[f].data_ptr() for f in _TREE] + [_ptr(records), _ptr(order),
                                               a["queries"].data_ptr()]
    if labels is None:
        fn = _build.function("bvh_traverse", "bvh_knn_launch", _KNN_ARGS)
    else:
        fn = _build.function("bvh_traverse", "bvh_knn_exclude_launch",
                             _KNN_EXCLUDE_ARGS)
        nodes = node_labels(a["leaf_labels"], a["leaf_perm"],
                            a["range_first"], a["range_last"])
        ptrs += [nodes.data_ptr(), a["query_labels"].data_ptr()]
    with torch.cuda.device(dev):
        err = fn(*ptrs, n, q, dim, k, dists.data_ptr(), idxs.data_ptr(),
                 _stream(dev))
    _build.check("bvh_traverse", err, what)
    if labels is None:
        bvh_traverse_knn.launches += 1
    else:
        bvh_traverse_knn_exclude.launches += 1
    return dists, idxs


_KNN_EXCLUDE_ARGS = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 4
                     + [ctypes.c_void_p] * 3)


def bvh_traverse_knn_exclude(node_lo, node_hi, rope, left_child, leaf_perm,
                             range_first, range_last, queries, query_labels,
                             leaf_labels, *, k: int, records=None,
                             order=None):
    """(dists, idxs) (Q, k) float32/int32, ascending, (inf, -1) padded:
    the k nearest of Q query points among the tree's leaves (Points, or
    Boxes by their point-to-box distance) whose label differs from the
    query's, ``leaf_labels[idx] != query_labels[q]`` (int32, leaf labels
    in original index order). The fine distance is the key, as in the
    reference's loop walk, so the lists are its lists bit for bit, ties
    included. It takes dims 1..``MAX_DIM`` and k <= ``KNN_MAX_K``; a
    ``Nearest.exclude`` of any other shape (other queries or values, a
    custom getter, larger dims or k) takes ``traversal.knn_walk``, which
    counts its calls (``knn_walk.calls``). `records` and `order` as for
    :func:`bvh_traverse_knn`; the node labels are made per call."""
    what = "bvh_traverse_knn_exclude"
    if k < 1:
        raise ValueError(f"{what}: k must be >= 1, got {k}")
    if _device_of(queries, what) == "cpu":
        dists, idxs = bvh_traverse_knn_exclude_ref(
            node_lo, node_hi, rope, left_child, leaf_perm, range_first,
            range_last, queries, query_labels, leaf_labels, k=k)
    else:
        dists, idxs = _knn_launch(
            what, node_lo, node_hi, rope, left_child, leaf_perm, queries, k,
            records, order,
            labels=(range_first, range_last, query_labels, leaf_labels))
    sanitize.check_knn(dists, idxs, n=leaf_perm.shape[0], kernel=what)
    return dists, idxs


_RAY_KIND = {G.Points: 0, G.Boxes: 1, G.Spheres: 2, G.Triangles: 3}
_RAY_KNN_ARGS = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 5
                 + [ctypes.c_void_p] * 3)


def bvh_traverse_ray_knn(node_lo, node_hi, rope, left_child, leaf_perm,
                         values, rays, *, k: int, records=None,
                         value_records=None):
    """(t, idxs) (R, k) float32/int32: the first k hits of each of the
    rays `rays` (a ``Rays`` array) among `values` (Points, Boxes, Spheres
    or 3-D Triangles, the tree's leaves), ascending in t, (inf, -1)
    padded. `records` (:func:`pack_nodes`, ``LBVH.records``) and
    `value_records` (:func:`pack_values`, ``BVH.value_records``): kept
    by the caller, else a 3-D call on the card makes them; neither
    changes a result."""
    what = "bvh_traverse_ray_knn"
    if k < 1:
        raise ValueError(f"{what}: k must be >= 1, got {k}")
    if (type(values) not in RAY_TARGETS or type(rays) is not G.Rays
            or (type(values) is G.Triangles and values.dim != 3)
            or rays.dim != values.dim):
        raise ValueError(f"{what}: rays against Points, Boxes, Spheres or "
                         "3-D Triangles values of the rays' dimension")
    if _device_of(rays.origin, what) == "cpu":
        t, idxs = bvh_traverse_ray_knn_ref(node_lo, node_hi, rope,
                                           left_child, leaf_perm, values,
                                           rays, k=k)
    else:
        t, idxs = _ray_knn_launch(what, node_lo, node_hi, rope, left_child,
                                  leaf_perm, values, rays, k, records,
                                  value_records)
    sanitize.check_knn(t, idxs, n=leaf_perm.shape[0], kernel=what)
    return t, idxs


_FINE_KIND = {G.Spheres: 2, G.Triangles: 3, G.Segments: 5, G.Tetrahedra: 6,
              G.KDOPs: 7}
_FINE_KNN_ARGS = ([ctypes.c_void_p] * 16 + [ctypes.c_int] * 5
                  + [ctypes.c_void_p] * 4)
_FINE_ROPE_ARGS = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p] * 3)


def bvh_traverse_fine_knn(node_lo, node_hi, rope, left_child, leaf_perm,
                          values, queries, *, k: int, records=None,
                          value_records=None):
    """(dists, idxs) (Q, k) float32/int32, ascending, (inf, -1) padded: the
    k nearest of `values` (Spheres, Triangles, Segments, Tetrahedra or
    KDOPs, the tree's leaves) by their FINE distance from the centroids of
    `queries` (any geometry but Rays), the lists of the reference's loop
    walk (``traversal.traverse_knn``) bit for bit, ties included.
    `records` (:func:`pack_nodes`, ``LBVH.records``) and `value_records`
    (:func:`pack_values`, ``BVH.value_records``): kept by the caller, else
    a 3-D call on the card makes them; neither changes a result.

    On the card the kernel walks nearest first and the rope walk re-walks
    the queries whose certificate fails (``csrc/fine_knn.cu``); after a
    launch ``bvh_traverse_fine_knn.flagged`` holds their count, a (1,)
    int32 tensor on the card (None after a CPU call). Reading it
    synchronises; the wrapper never does."""
    what = "bvh_traverse_fine_knn"
    if k < 1:
        raise ValueError(f"{what}: k must be >= 1, got {k}")
    if (type(values) not in FINE_KNN_VALUES
            or type(queries) not in G.GEOMETRIES or type(queries) is G.Rays
            or queries.dim != values.dim):
        raise ValueError(f"{what}: queries of any geometry but Rays against "
                         "Spheres, Triangles, Segments, Tetrahedra or KDOPs "
                         "values of the queries' dimension")
    if _device_of(leaf_perm, what) == "cpu":
        dists, idxs = bvh_traverse_fine_knn_ref(
            node_lo, node_hi, rope, left_child, leaf_perm, values, queries,
            k=k)
        bvh_traverse_fine_knn.flagged = None
    else:
        dists, idxs = _fine_knn_launch(what, node_lo, node_hi, rope,
                                       left_child, leaf_perm, values, queries,
                                       k, records, value_records)
    sanitize.check_knn(dists, idxs, n=leaf_perm.shape[0], kernel=what)
    return dists, idxs


def _fine_query(queries):
    """(q_lo, q_hi, center, radius) of the node key and the leaf distance:
    a Boxes query's box, a Spheres query's centre and radius, any other
    query's centroid (``predicates.node_min_distance``); radius None but
    for Spheres."""
    center = G.centroid(queries)
    if isinstance(queries, G.Boxes):
        return queries.lo, queries.hi, center, None
    if isinstance(queries, G.Spheres):
        return center, center, center, queries.radius
    return center, center, center, None


def bvh_traverse_fine_knn_rope(node_lo, node_hi, rope, left_child,
                               leaf_perm, values, queries, *, k: int,
                               records=None, value_records=None):
    """The rope walk alone on the card (``fine_rope_kernel`` over every
    query, the twin's node sequence): the order the nearest-first walk of
    :func:`bvh_traverse_fine_knn` is held to bit for bit on the card at
    sizes the host twin cannot reach. CUDA tensors only; counts no launch
    (the main path never calls it)."""
    what = "bvh_traverse_fine_knn_rope"
    if _device_of(leaf_perm, what) != "cuda":
        raise ValueError(f"{what}: CUDA tensors only")
    return _fine_knn_launch(what, node_lo, node_hi, rope, left_child,
                            leaf_perm, values, queries, k, records,
                            value_records, rope_walk=True)


def _fine_knn_launch(what, node_lo, node_hi, rope, left_child, leaf_perm,
                     values, queries, k, records, value_records,
                     rope_walk=False):
    if k > KNN_MAX_K:
        raise ValueError(f"{what}: k={k} above the kernel's cap {KNN_MAX_K}")
    dev = leaf_perm.device
    n = leaf_perm.shape[0]
    dim = values.dim
    a = _args(dev, what, node_lo=node_lo, node_hi=node_hi, rope=rope,
              left_child=left_child, leaf_perm=leaf_perm)
    _check_tree(what, n, dim, a["node_lo"], a["node_hi"], a["rope"],
                a["left_child"], a["leaf_perm"])
    q_lo, q_hi, center, radius = _fine_query(queries)
    q = len(queries)
    geo = {}
    for name, t in (("q_lo", q_lo), ("q_hi", q_hi), ("center", center),
                    ("radius", radius)):
        if t is not None:
            if t.device != dev or t.dtype != torch.float32:
                raise ValueError(f"{what}: queries must be float32 on {dev}")
            geo[name] = t.contiguous()
    vals = [t for f, t in vars(values).items() if f != "directions"]
    if len(values) != n or any(t.device != dev or t.dtype != torch.float32
                               for t in vals):
        raise ValueError(f"{what}: {n} float32 values on {dev} expected")
    va = vb = vc = vr = None
    if dim == 3:
        records, value_records = _kept_records(
            what, [a[f] for f in _TREE], values, records, value_records, dev,
            isinstance(values, FINE_KNN_RECORDS))
    else:
        records = value_records = None
        if isinstance(values, G.Spheres):
            va, vr = values.center.contiguous(), values.radius.contiguous()
        elif isinstance(values, (G.Triangles, G.Segments)):
            va, vb = values.a.contiguous(), values.b.contiguous()
            vc = getattr(values, "c", None)
            vc = None if vc is None else vc.contiguous()
    dists = torch.empty((q, k), dtype=torch.float32, device=dev)
    idxs = torch.empty((q, k), dtype=torch.int32, device=dev)
    if q == 0:
        return dists, idxs
    ptrs = [*(a[f].data_ptr() for f in _TREE), _ptr(records),
            _ptr(value_records), _ptr(va), _ptr(vb), _ptr(vc), _ptr(vr),
            geo["q_lo"].data_ptr(), geo["q_hi"].data_ptr(),
            geo["center"].data_ptr(), _ptr(geo.get("radius"))]
    sizes = (n, q, dim, _FINE_KIND[type(values)], k)
    if rope_walk:
        fn = _build.function("fine_knn", "fine_knn_rope_launch",
                             _FINE_ROPE_ARGS)
        with torch.cuda.device(dev):
            err = fn(*ptrs, *sizes, dists.data_ptr(), idxs.data_ptr(),
                     _stream(dev))
        _build.check("fine_knn", err, what)
        return dists, idxs
    # the slack's term of a negative sphere radius (csrc/fine_knn.cu's
    # note), on the card: max(0, -min radius), NaN kept
    rneg = (torch.clamp_min(-values.radius.amin(), 0.0).reshape(1)
            if isinstance(values, G.Spheres) else None)
    flagged = torch.empty((q + 1,), dtype=torch.int32, device=dev)
    fn = _build.function("fine_knn", "fine_knn_launch", _FINE_KNN_ARGS)
    with torch.cuda.device(dev):
        err = fn(*ptrs, _ptr(rneg), *sizes, dists.data_ptr(),
                 idxs.data_ptr(), flagged.data_ptr(), _stream(dev))
    _build.check("fine_knn", err, what)
    bvh_traverse_fine_knn.launches += 1
    bvh_traverse_fine_knn.flagged = flagged[:1]
    return dists, idxs


def _check_records(what, rec, rows, cols, dev):
    """Raise unless `rec` are contiguous, 16-byte aligned (rows, cols)
    int32 records on `dev` (pack_nodes', pack_values')."""
    if (rec.shape != (rows, cols) or rec.dtype != torch.int32
            or rec.device != dev or not rec.is_contiguous()
            or rec.data_ptr() % 16):
        raise ValueError(f"{what}: records must be contiguous, 16-byte "
                         f"aligned ({rows}, {cols}) int32 on {dev}")


def _kept_records(what, tree, values, records, value_records, dev, reads):
    """(records, value records) a 3-D launch reads: the caller's kept
    ones, checked, else packed here. `tree` is (node_lo, node_hi, rope,
    left_child, leaf_perm); value records only where the call `reads`
    them, else None."""
    n = tree[4].shape[0]
    if records is None:
        records = pack_nodes(*tree)
    _check_records(what, records, 2 * n - 1, 8, dev)
    if not reads:
        return records, None
    if value_records is None:
        value_records = pack_values(values, tree[4])
    _check_records(what, value_records, n, _RECORD_COLS[type(values)], dev)
    return records, value_records


def _ray_knn_launch(what, node_lo, node_hi, rope, left_child, leaf_perm,
                    values, rays, k, records, value_records):
    if k > KNN_MAX_K:
        raise ValueError(f"{what}: k={k} above the kernel's cap {KNN_MAX_K}")
    dev = rays.origin.device
    q, dim = rays.origin.shape
    n = leaf_perm.shape[0]
    a = _args(dev, what, node_lo=node_lo, node_hi=node_hi, rope=rope,
              left_child=left_child, leaf_perm=leaf_perm)
    _check_tree(what, n, dim, a["node_lo"], a["node_hi"], a["rope"],
                a["left_child"], a["leaf_perm"])
    geo = {}
    for name, g in (("values", values), ("rays", rays)):
        for field, t in vars(g).items():
            if t.device != dev or t.dtype != torch.float32:
                raise ValueError(f"{what}: {name}.{field} must be float32 "
                                 f"on {dev}")
            geo[f"{name}.{field}"] = t.contiguous()
    if len(values) != n or rays.direction.shape != (q, dim):
        raise ValueError(f"{what}: {n} values and (R, {dim}) rays expected")
    center = radius = None
    if dim == 3:
        records, value_records = _kept_records(
            what, [a[f] for f in _TREE], values, records, value_records, dev,
            isinstance(values, (G.Spheres, G.Triangles)))
    else:
        records = value_records = None
        if isinstance(values, G.Spheres):
            center, radius = geo["values.center"], geo["values.radius"]
    t = torch.empty((q, k), dtype=torch.float32, device=dev)
    idxs = torch.empty((q, k), dtype=torch.int32, device=dev)
    if q == 0:
        return t, idxs
    fn = _build.function("ray_knn", "ray_knn_launch", _RAY_KNN_ARGS)
    with torch.cuda.device(dev):
        err = fn(*(a[f].data_ptr() for f in _TREE),
                 _ptr(records), _ptr(value_records), _ptr(center),
                 _ptr(radius), geo["rays.origin"].data_ptr(),
                 geo["rays.direction"].data_ptr(), n, q, dim,
                 _RAY_KIND[type(values)], k, t.data_ptr(), idxs.data_ptr(),
                 _stream(dev))
    _build.check("ray_knn", err, what)
    bvh_traverse_ray_knn.launches += 1
    return t, idxs


bvh_traverse_spatial.launches = 0
bvh_traverse_knn.launches = 0
bvh_traverse_knn_exclude.launches = 0
bvh_traverse_ray_knn.launches = 0
bvh_traverse_fine_knn.launches = 0
bvh_traverse_fine_knn.flagged = None
