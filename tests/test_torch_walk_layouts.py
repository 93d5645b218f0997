"""PyTorch port vs the JAX package: the plain steps around the callback
kernel's and ``ray_box_nearest``'s launches on the card (CPU; the
kernels themselves run in the ``cuda`` tests).

  * ``bvh_callback.query_order``: the walk order of queries centred on
    the indexed points is the tree's own ``leaf_perm``, a permutation and
    a stable sort of the reference's 64-bit Morton codes of the points
    in the tree's root box; other queries keep the caller's order;
  * a walk in a Morton order of the query centres with the rows restored
    gives the reference's final states;
  * ``bvh_callback.pack_nodes``: the 3-D node records unpack bit for bit,
    the int32 fields through the float32 view included;
  * ``bvh_callback.min_where_weights``: one weight per value gives the
    min_where states of flags and weights;
  * the leaf test the 3-D instance takes from the node test: over a
    point's box [p, p] the squared sphere-box distance is the squared
    centre distance bit for bit;
  * ``ray_box.merge_key`` / ``merge_decode`` and ``plan``: the split box
    axis merged by a minimum over keys gives the twin's (t, idx) on ties,
    misses and hits at t = inf;
  * ``traversal.walk``'s node-visit count.
"""
import numpy as np
import pytest
import torch

from test_torch_callbacks import (EPILOGUES, TREE_ARGS, _assert_states_equal,
                                  _factories, _scene)
from test_torch_parity import CPU, np_of, one_torch_thread  # noqa: F401
from test_torch_ray_box import case as ray_case
from repro.core import morton as JM
from repro.core import traversal as JT
from repro.core.index import _bcast_state as j_bcast_state
from repro.kernels.ops import ray_box_nearest as j_ray_box_nearest
from repro_torch.core import callbacks as CB
from repro_torch.core import geometry as TG
from repro_torch.core import lbvh as TL
from repro_torch.core import predicates as TP
from repro_torch.core import traversal as TT
from repro_torch.core.geometry import fma
from repro_torch.core.index import _bcast_state
from repro_torch.kernels import bvh_callback as TK
from repro_torch.kernels import bvh_traverse as TV
from repro_torch.kernels import ray_box as TR


def _centres(geom):
    return {"points": lambda g: g.coords, "spheres": lambda g: g.center,
            "boxes": lambda g: 0.5 * (g.lo + g.hi)}[
        {TG.Points: "points", TG.Spheres: "spheres", TG.Boxes: "boxes"}[
            type(geom)]](geom)


def _reference_order(centres, scene_lo, scene_hi):
    """Stable argsort of the reference's 64-bit Morton codes (hi, lo)."""
    hi, lo = JM.morton64(np_of(centres), np_of(scene_lo), np_of(scene_hi))
    key = (np.asarray(hi).astype(np.uint64) << np.uint64(32)) | \
        np.asarray(lo).astype(np.uint64)
    return np.argsort(key, kind="stable").astype(np.int32)


# ---------------------------------------------------------------------------
# the walk order
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("qkind", ["points", "boxes", "spheres"])
@pytest.mark.parametrize("vkind", ["points", "boxes"])
def test_leaf_order_is_a_stable_morton_sort_and_other_queries_keep_theirs(
        vkind, qkind):
    """The tree's leaf order, the walk order of queries centred on the
    indexed points, is a permutation and the stable sort of the
    reference's Morton codes of the value centres in their bounding box
    (the root box, for points); queries that are not
    the indexed points get no order (the caller's)."""
    _, tree, (_, tv), (_, tp) = _scene(vkind, qkind)
    assert TK.query_order(tp, tv, tree.leaf_perm) is None
    order = tree.leaf_perm
    n = len(tv)
    assert order.dtype == torch.int32 and order.shape == (n,)
    assert sorted(order.tolist()) == list(range(n))
    c = _centres(tv)
    want = _reference_order(c, c.amin(0), c.amax(0))
    np.testing.assert_array_equal(np_of(order), want)


@pytest.mark.parametrize("dim", [2, 3, 5])
def test_query_order_of_the_indexed_points_is_the_leaf_order(dim):
    """DBSCAN's queries are spheres around the indexed points (the same
    tensor): the order is leaf_perm itself, the stable Morton sort of the
    points; a copy of the points is not recognised and keeps its order."""
    g = torch.Generator().manual_seed(dim)
    pts = torch.rand((700, dim), generator=g)
    pts[::7] = pts[3]                                 # duplicate codes
    tree = TL.build(TG.Boxes(pts, pts))
    values = TG.Points(pts)
    preds = TP.intersects(TG.Spheres(pts, torch.full((700,), 0.05)))
    assert TK.query_order(preds, values, tree.leaf_perm) is tree.leaf_perm
    copy = TP.intersects(TG.Spheres(pts.clone(), torch.full((700,), 0.05)))
    assert TK.query_order(copy, values, tree.leaf_perm) is None
    np.testing.assert_array_equal(
        np_of(tree.leaf_perm), _reference_order(pts, tree.node_lo[0],
                                                tree.node_hi[0]))


@pytest.mark.parametrize("vkind", ["points", "boxes", "spheres"])
@pytest.mark.parametrize("name", EPILOGUES)
def test_walk_in_query_order_restores_the_reference_states(name, vkind):
    """Queries walked in the Morton order of their centres, rows put back:
    every epilogue's final states equal the reference walk's in the
    callers' order."""
    jtree, tree, (jv, tv), (jp, tp) = _scene(vkind)
    (jcb, js0), (tcb, ts0) = _factories(name)
    q = len(tp)
    want = JT.traverse(jtree, jv, jp, jcb, j_bcast_state(js0, q))
    order = torch.from_numpy(_reference_order(
        _centres(tp.geom), tree.node_lo[0], tree.node_hi[0])).to(torch.int64)
    assert not torch.equal(order, torch.arange(q))
    s0 = _bcast_state(ts0, q, CPU)
    s0p = TT._map(lambda a: a[order], s0)
    got = TK.bvh_traverse_callback_ref(
        *(getattr(tree, f) for f in TREE_ARGS), tv, TP.take(tp, order), tcb,
        s0p)

    def restore(a):
        out = torch.empty_like(a)
        out[order] = a
        return out

    _assert_states_equal(want, TT._map(restore, got))


# ---------------------------------------------------------------------------
# node records, min_where's weights, the reused leaf test
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 3, 1000])
def test_packed_node_records_unpack_bit_for_bit(n):
    g = torch.Generator().manual_seed(n)
    lo = torch.rand((n, 3), generator=g)
    lo[0, 1] = -0.0                                   # a signed zero
    tree = TL.build(TG.Boxes(lo, lo + 0.1 * torch.rand((n, 3), generator=g)))
    rec = TK.pack_nodes(tree.node_lo, tree.node_hi, tree.rope,
                        tree.left_child, tree.leaf_perm)
    assert rec.dtype == torch.int32 and rec.shape == (2 * n - 1, 8)
    assert rec.is_contiguous()
    lo_u = rec[:, 0:3].contiguous().view(torch.float32)
    hi_u = rec[:, 4:7].contiguous().view(torch.float32)
    rope, left, perm = rec[:, 3], rec[:n - 1, 7], rec[n - 1:, 7]
    for got, want in ((lo_u, tree.node_lo), (hi_u, tree.node_hi)):
        assert got.dtype == torch.float32
        assert torch.equal(got.view(torch.int32),
                           want.contiguous().view(torch.int32))
    for got, want in ((rope, tree.rope), (left, tree.left_child),
                      (perm, tree.leaf_perm)):
        assert got.dtype == torch.int32 and torch.equal(got, want)
    # the ints pass through the float32 view the kernel reads: rope -1 is
    # a NaN bit pattern there, and comes back as -1
    as_float = rec.view(torch.float32)
    assert bool(torch.isnan(as_float[:, 3][tree.rope == -1]).all())
    assert torch.equal(as_float.view(torch.int32), rec)
    assert torch.equal(as_float[:, 7].contiguous().view(torch.int32),
                       torch.cat([tree.left_child, tree.leaf_perm]))


@pytest.mark.parametrize("vkind", ["points", "boxes", "spheres"])
def test_min_where_weights_give_the_min_where_states(vkind):
    """where(flags, weights, big) with every flag set gives the states of
    flags and weights: the reference's min_where states."""
    jtree, tree, (jv, tv), (jp, tp) = _scene(vkind)
    (jcb, js0), (tcb, ts0) = _factories("min_where")
    q = len(tp)
    want = JT.traverse(jtree, jv, jp, jcb, j_bcast_state(js0, q))
    w = TK.min_where_weights(tcb)
    assert w.dtype == torch.int32 and w.shape == tcb.weights.shape
    assert torch.equal(w, torch.where(tcb.flags, tcb.weights, tcb.big))
    one, s0 = CB._min_where(torch.ones_like(tcb.flags), w, tcb.big)
    got = TK.bvh_traverse_callback_ref(
        *(getattr(tree, f) for f in TREE_ARGS), tv, tp, one,
        _bcast_state(s0, q, CPU))
    _assert_states_equal(want, got)


def test_point_box_distance_is_the_centre_distance():
    """Over a leaf box [p, p], max(max(p - q, q - p), 0) squared and summed
    in the fused order is the centre distance (q - p) squared and summed,
    bit for bit: signed zeros, equal coordinates, subnormals, infinities
    and NaN included."""
    g = torch.Generator().manual_seed(0)
    p = torch.rand((4000, 3), generator=g)
    q = p + 1e-3 * torch.randn((4000, 3), generator=g)
    q[::5] = p[::5]
    edge = torch.tensor([0.0, -0.0, 1e-45, -1e-45, 1e-38, float("inf"),
                         -float("inf"), float("nan"), 3e38, -3e38])
    e = torch.cartesian_prod(edge, edge)
    p = torch.cat([p, torch.stack([e[:, 0]] * 3, 1)])
    q = torch.cat([q, torch.stack([e[:, 1]] * 3, 1)])

    def fused(d):
        s = d[:, 0] * d[:, 0]
        for c in (1, 2):
            s = fma(d[:, c], d[:, c], s)
        return s

    box = fused(torch.clamp_min(torch.maximum(p - q, q - p), 0.0))
    centre = fused(q - p)
    nan = torch.isnan(centre)
    assert torch.equal(torch.isnan(box), nan) and bool(nan.any())
    assert torch.equal(box[~nan].view(torch.int32),
                       centre[~nan].view(torch.int32))


# ---------------------------------------------------------------------------
# ray_box_nearest's split box axis and merge keys
# ---------------------------------------------------------------------------

def _inf_hit_case():
    """Rays whose slabs overflow: entry and exit both +inf, a hit at
    t = inf that the twin reports as a miss."""
    o = np.zeros((4, 3), np.float32)
    d = np.full((4, 3), 1e-29, np.float32)
    lo = np.full((3, 3), 1e10, np.float32)
    hi = np.full((3, 3), 2e10, np.float32)
    return o, d, lo, hi


@pytest.mark.parametrize("splits", [1, 2, 3, 7])
@pytest.mark.parametrize("r,b,seed", [(50, 403, 4), (37, 1001, 37), (8, 9, 1)])
def test_merge_over_a_split_box_axis_is_the_reference(r, b, seed, splits):
    """Each range's twin answer, encoded, merged by a minimum and decoded,
    equals the reference over all boxes: ties (duplicated boxes) go to the
    lowest index across ranges, misses stay (inf, -1)."""
    o, d, lo, hi = ray_case(r, b, seed=seed)
    wt, wi = map(np.asarray, j_ray_box_nearest(o, d, lo, hi))
    to, td, tl, th = (torch.from_numpy(a) for a in (o, d, lo, hi))
    chunk = -(-b // splits)
    keys = torch.full((r,), TR.NO_HIT, dtype=torch.int64)
    for s in range(0, b, chunk):
        t, i = TR.ray_box_nearest_ref(to, td, tl[s:s + chunk], th[s:s + chunk])
        keys = torch.minimum(keys, TR.merge_key(t, torch.where(i >= 0, i + s, i)))
    gt, gi = TR.merge_decode(keys)
    assert gt.dtype == torch.float32 and gi.dtype == torch.int32
    np.testing.assert_array_equal(np_of(gt), wt)
    np.testing.assert_array_equal(np_of(gi), wi)
    assert (wi >= 0).any() and (wi < 0).any()


def test_merge_key_round_trips_ties_misses_and_inf():
    o, d, lo, hi = _inf_hit_case()
    wt, wi = map(np.asarray, j_ray_box_nearest(o, d, lo, hi))
    assert np.isinf(wt).all() and (wi == -1).all()
    _, tall = TG.ray_box(*(torch.from_numpy(a)[:, None] for a in (o, d)),
                         torch.from_numpy(lo)[None], torch.from_numpy(hi)[None])
    assert bool(torch.isinf(tall).all())              # hits at t = inf
    t = torch.tensor([0.0, 0.5, 0.5, float("inf"), 3e38, 1e-45])
    i = torch.tensor([0, 7, 2, -1, 2**31 - 1, 5], dtype=torch.int32)
    keys = TR.merge_key(t, i)
    assert int(keys[3]) == TR.NO_HIT
    assert int(keys[0]) < int(keys[5]) < int(keys[2]) < int(keys[1]) \
        < int(keys[4]) < TR.NO_HIT
    gt, gi = TR.merge_decode(keys)
    assert torch.equal(gt.view(torch.int32), t.view(torch.int32))
    assert torch.equal(gi, i)
    gt, gi = TR.merge_decode(TR.merge_key(*TR.ray_box_nearest_ref(
        *(torch.from_numpy(a) for a in (o, d, lo, hi)))))
    np.testing.assert_array_equal(np_of(gt), wt)
    np.testing.assert_array_equal(np_of(gi), wi)


@pytest.mark.parametrize("r,b", [(1, 0), (1, 1), (131, 255), (1 << 17, 1 << 20),
                                 (1 << 20, 1 << 12), (5000, 4097)])
def test_plan_covers_the_box_axis(r, b):
    splits, chunk = TR.plan(r, b, 132)
    assert splits >= 1 and chunk >= TR.TILE and chunk % TR.TILE == 0
    assert splits * chunk >= b and (splits - 1) * chunk < max(b, 1)
    blocks = -(-r // (TR.THREADS * TR.RAYS_PER_THREAD)) * splits
    if (r, b) == (1 << 17, 1 << 20):
        assert blocks >= 132 * 8


# ---------------------------------------------------------------------------
# node visits of the callback twin
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vkind", ["points", "boxes"])
def test_walk_counts_node_visits_as_the_spatial_twin(vkind):
    """Counting has no early exit, so the callback twin visits the nodes
    of the spatial kernel's twin, query for query; count_with_limit stops
    early and visits fewer."""
    _, tree, (_, tv), (_, tp) = _scene(vkind)
    args = [getattr(tree, f) for f in TREE_ARGS]
    q = len(tp)
    stats, limited, spatial = {}, {}, {}
    cb, s0 = CB.counting()
    TK.bvh_traverse_callback_ref(*args, tv, tp, cb, _bcast_state(s0, q, CPU),
                                 stats=stats)
    cb, s0 = CB.count_with_limit(2)
    TK.bvh_traverse_callback_ref(*args, tv, tp, cb, _bcast_state(s0, q, CPU),
                                 stats=limited)
    c = tp.geom.center
    TV.bvh_traverse_spatial_ref(tree.node_lo, tree.node_hi, tree.rope,
                                tree.left_child, tree.range_last,
                                tree.leaf_perm, c, c, tp.geom.radius,
                                stats=spatial)
    assert stats["visits"] == spatial["visits"] > q
    assert 0 < limited["visits"] < stats["visits"]
    empty = {}
    TT.walk(*args, tv, TP.take(tp, torch.arange(0)), cb,
            _bcast_state(s0, 0, CPU), stats=empty)
    assert empty == {"visits": 0}


def test_lbvh_keeps_its_node_records():
    """LBVH.records: pack_nodes' records of a 3-D tree, made once and kept
    with the tree (a moved or refitted tree makes its own); None in other
    dims."""
    g = torch.Generator().manual_seed(5)
    pts = torch.rand((300, 3), generator=g)
    tree = TL.build(TG.Boxes(pts, pts))
    rec = tree.records
    assert rec is tree.records
    assert torch.equal(rec, TK.pack_nodes(tree.node_lo, tree.node_hi,
                                          tree.rope, tree.left_child,
                                          tree.leaf_perm))
    moved = tree.to("cpu")
    assert moved.records is not rec and torch.equal(moved.records, rec)
    refit = TL.refit(tree, TG.Boxes(pts + 1.0, pts + 1.0))
    assert not torch.equal(refit.records, rec)
    flat = TL.build(TG.Boxes(pts[:, :2], pts[:, :2]))
    assert flat.records is None
