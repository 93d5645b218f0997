"""Rope-walk traversal with the callback fused into the walk's epilogue:
``bvh_traverse_callback``, with its plain twin ``bvh_traverse_callback_ref``.

The kernel (``csrc/bvh_callback.cu``) runs the epilogues of
``core.callbacks`` (counting, count_with_limit, min_distance,
collect_first_k, collect_hits, and DBSCAN's min_where) for Intersects
predicates over Points, Boxes or Spheres against values of those three
geometries, and for the ray predicates (RayIntersect,
RayOrderedIntersect, RayNearest) against Points, Boxes, Spheres or 3-D
Triangles values, up to ``MAX_DIM`` dimensions; :func:`expressible` says
whether a call is one of those, and the wrapper raises on a geometry that
is not float32 or a state that is not the epilogue's layout. A ray hit
hands the epilogue its parameter t (``collect_*`` store it,
``min_distance`` reduces it). Its per-query final states equal the
twin's bit for bit. The twin is ``core.traversal.walk`` with the
epilogue's torch body: the reference pins its kernel bit-identical to
that walk.

A CPU tensor takes the twin; a CUDA tensor launches the kernel (one
thread per query, the state held in registers or written straight to the
(Q, cap) outputs); any other device raises. The kernel's launch count is
``bvh_traverse_callback.launches``. Under ``REPRO_SANITIZE`` the final
states are checked for NaN (``sanitize.check_state_tree``).

Before a launch the wrapper takes, with plain tensor ops: a walk order
for Intersects queries centred on the indexed points (DBSCAN's), the
tree's leaf order, which is their Morton order (:func:`query_order`), so
a warp walks 32 neighbouring queries through the same nodes; the packed
node records of a 3-D tree (:func:`pack_nodes`, read by the ``dim = 3``
instances, spatial and ray; ``LBVH.records`` keeps them with the tree);
for a 3-D ray call over Spheres or Triangles, the leaves' value records
in sorted-leaf order (``bvh_traverse.pack_values``; ``BVH.value_records``
keeps them with the index); and min_where's one weight per value
(:func:`min_where_weights`). None of them changes a state: each query's
node sequence and arithmetic stay the twin's.
"""
from __future__ import annotations

import ctypes

import torch

from ..core import callbacks as CB
from ..core import geometry as G
from ..core import predicates as P
from ..core import traversal
from . import _build, sanitize
from .bvh_traverse import (MAX_DIM, RAY_TARGETS, _check_tree, _device_of,
                           _kept_records, _ptr, _stream, pack_nodes)

__all__ = ["bvh_traverse_callback", "bvh_traverse_callback_ref",
           "expressible", "query_order", "pack_nodes", "min_where_weights"]

_KIND = {G.Points: 0, G.Boxes: 1, G.Spheres: 2, G.Triangles: 3, G.Rays: 4}
_SPATIAL = (G.Points, G.Boxes, G.Spheres)
_EPILOGUE = {"counting": 0, "count_with_limit": 1, "min_distance": 2,
             "collect_first_k": 3, "collect_hits": 4, "min_where": 5}


def _state_leaves(state0):
    return list(state0) if isinstance(state0, (tuple, list)) else [state0]


def expressible(values, predicates, callback) -> bool:
    """Is this a call the kernel runs: an epilogue callback, and either
    Intersects over Points/Boxes/Spheres against values of those, or a ray
    predicate against Points/Boxes/Spheres/Triangles values, in at most
    MAX_DIM dimensions (triangles: 3)? Dtypes and the state's layout are
    not asked here: the wrapper raises on those."""
    if not isinstance(callback, CB.Epilogue):
        return False
    if isinstance(predicates, P.Intersects):
        kinds_ok = (type(predicates.geom) in _SPATIAL
                    and type(values) in _SPATIAL)
    elif isinstance(predicates, P.RAY_KINDS):
        kinds_ok = (type(predicates.rays) is G.Rays
                    and type(values) in RAY_TARGETS
                    and (type(values) is not G.Triangles or values.dim == 3))
    else:
        return False
    return kinds_ok and 1 <= values.dim <= MAX_DIM


def _check_call(what, n, values, predicates, callback, state0):
    """Raise ValueError unless the kernel can run the call on these dtypes
    and this state layout."""
    if not expressible(values, predicates, callback):
        raise ValueError(f"{what}: the kernel runs the epilogues of "
                         "core.callbacks for Intersects over Points/Boxes/"
                         "Spheres values and for ray predicates over "
                         "Points/Boxes/Spheres/Triangles (3-D) values, in "
                         f"at most {MAX_DIM} dimensions")
    geom = P.geometry_of(predicates)
    if geom.dim != values.dim:
        raise ValueError(f"{what}: predicates in {geom.dim} "
                         f"dimensions against values in {values.dim}")
    for name, g in (("values", values), ("predicates", geom)):
        for field, a in vars(g).items():
            if a.dtype != torch.float32:
                raise ValueError(f"{what}: {name}.{field} must be float32, "
                                 f"got {a.dtype}")
    leaves = _state_leaves(state0)
    layout = [((len(predicates),) + shp, dt) for shp, dt in callback.layout()]
    got = [(tuple(a.shape), a.dtype) if isinstance(a, torch.Tensor) else a
           for a in leaves]
    if got != layout:
        raise ValueError(f"{what}: a {callback.kind} state must be "
                         f"{layout}, got {got}")
    if callback.kind == "min_where" and not (
            callback.flags.shape == callback.weights.shape == (n,)):
        raise ValueError(f"{what}: min_where needs flags and weights of the "
                         f"tree's {n} values")


def bvh_traverse_callback_ref(node_lo, node_hi, rope, left_child, range_last,
                              leaf_perm, values, predicates, callback, state0,
                              *, min_pos=None, stats: dict | None = None):
    """The kernel's plain twin: the batched walk with the epilogue's body.
    `stats`, when given, receives ``visits``: the node visits of all
    queries together."""
    return traversal.walk(node_lo, node_hi, rope, left_child, range_last,
                          leaf_perm, values, predicates, callback, state0,
                          min_pos=min_pos, stats=stats)


def _centred_on_values(predicates, values):
    """Are the predicates' centres the indexed points themselves (the same
    tensor as ``values.coords``)?"""
    geom = P.geometry_of(predicates)
    if not (isinstance(values, G.Points)
            and isinstance(geom, (G.Points, G.Spheres))):
        return False
    c, v = G.centroid(geom), values.coords
    return (c.data_ptr() == v.data_ptr() and c.shape == v.shape
            and c.stride() == v.stride())


def query_order(predicates, values, leaf_perm):
    """(Q,) int32 walk order of Intersects predicates centred on the
    indexed points (the same tensor as ``values.coords``, as in DBSCAN):
    the tree's `leaf_perm`, which is the stable sort of their 64-bit
    Morton codes in the tree's root box; None for other predicates, which
    are walked in the caller's order. The engine gives the 3-D spatial
    kernel the same order (``bvh_traverse.bvh_traverse_spatial``)."""
    return leaf_perm if _centred_on_values(predicates, values) else None


def min_where_weights(callback):
    """min_where's one int32 per value: where(flags, weights, big)."""
    return torch.where(callback.flags, callback.weights,
                       callback.big).to(torch.int32)


def _geom_ptrs(g, dev, what):
    """(a, b, c, r) contiguous tensors of a geometry array on `dev` (None
    where the kind has no such field): coords; lo, hi; center, radius;
    a, b, c; origin, direction."""
    arrays = {G.Points: lambda: (g.coords, None, None, None),
              G.Boxes: lambda: (g.lo, g.hi, None, None),
              G.Spheres: lambda: (g.center, None, None, g.radius),
              G.Triangles: lambda: (g.a, g.b, g.c, None),
              G.Rays: lambda: (g.origin, g.direction, None, None)}[type(g)]()
    out = []
    for a in arrays:
        if a is not None:
            if a.device != dev:
                raise ValueError(f"{what}: geometry is on {a.device}, "
                                 f"not {dev}")
            a = a.contiguous()
        out.append(a)
    return out


_ARGS = ([ctypes.c_void_p] * 17 + [ctypes.c_int] * 8
         + [ctypes.c_void_p] * 5)


def bvh_traverse_callback(node_lo, node_hi, rope, left_child, range_last,
                          leaf_perm, values, predicates, callback, state0, *,
                          min_pos=None, records=None, value_records=None):
    """Per-query final states (the structure of `state0`, batched (Q, ...))
    of an epilogue callback over the matches of `predicates` in the tree.
    `records`: the tree's :func:`pack_nodes` records where the caller
    keeps them (``LBVH.records``); `value_records`: a ray call's
    :func:`~.bvh_traverse.pack_values` records of Spheres or Triangles
    values (``BVH.value_records``); a 3-D call on the card makes them
    otherwise; neither changes a state. Raises when :func:`expressible`
    does not hold, on a geometry that is not float32, or on a state that
    is not the epilogue's layout."""
    what = "bvh_traverse_callback"
    _check_call(what, leaf_perm.shape[0], values, predicates, callback, state0)
    if _device_of(node_lo, what) == "cpu":
        final = bvh_traverse_callback_ref(
            node_lo, node_hi, rope, left_child, range_last, leaf_perm, values,
            predicates, callback, state0, min_pos=min_pos)
    else:
        final = _callback_launch(what, node_lo, node_hi, rope, left_child,
                                 range_last, leaf_perm, values, predicates,
                                 callback, state0, min_pos, records,
                                 value_records)
    sanitize.check_state_tree(final, kernel=what)
    return final


def _callback_launch(what, node_lo, node_hi, rope, left_child, range_last,
                     leaf_perm, values, predicates, callback, state0,
                     min_pos, records, value_records):
    dev = node_lo.device
    q = len(predicates)
    n = leaf_perm.shape[0]
    dim = values.dim
    tree = [node_lo, node_hi, rope, left_child, range_last, leaf_perm]
    for name, t, dt in zip(("node_lo", "node_hi", "rope", "left_child",
                            "range_last", "leaf_perm"), tree,
                           (torch.float32,) * 2 + (torch.int32,) * 4):
        if t.device != dev or t.dtype != dt:
            raise ValueError(f"{what}: {name} must be {dt} on {dev}")
    tree = [t.contiguous() for t in tree]
    _check_tree(what, n, dim, tree[0], tree[1], tree[2], tree[3], tree[5])
    if tree[4].shape != (2 * n - 1,) or len(values) != n:
        raise ValueError(f"{what}: range_last and values must match the "
                         f"tree's {n} leaves")
    pgeom = P.geometry_of(predicates)
    pa, pb, _, pr = _geom_ptrs(pgeom, dev, what)
    va, vb, vc, vr = _geom_ptrs(values, dev, what)
    mp = (torch.full((q,), -1, dtype=torch.int32, device=dev)
          if min_pos is None else min_pos.to(device=dev, dtype=torch.int32)
          .contiguous())
    leaves = _state_leaves(state0)
    for a in leaves:
        if a.device != dev:
            raise ValueError(f"{what}: state is on {a.device}, not {dev}")
    out = [torch.empty_like(a, memory_format=torch.contiguous_format).copy_(a)
           for a in leaves]
    weights = None
    param, early_exit = 0, 0
    kind = callback.kind
    if kind == "count_with_limit":
        param = callback.limit
    elif kind == "collect_first_k":
        param, early_exit = callback.k, int(callback.early_exit)
    elif kind == "collect_hits":
        param = callback.capacity
    elif kind == "min_where":
        if callback.flags.device != dev or callback.weights.device != dev:
            raise ValueError(f"{what}: min_where arrays must be on {dev}")
        weights = min_where_weights(callback)
    spatial = isinstance(predicates, P.Intersects)
    order = query_order(predicates, values, tree[5]) if spatial else None
    if dim == 3:
        records, value_records = _kept_records(
            what, tree[:4] + tree[5:], values, records, value_records, dev,
            not spatial)
    else:
        records = value_records = None
    if q:
        fn = _build.function("bvh_callback", "bvh_callback_launch", _ARGS)
        with torch.cuda.device(dev):
            err = fn(*(t.data_ptr() for t in tree), _ptr(records),
                     _ptr(value_records), _ptr(order), _ptr(pa), _ptr(pb),
                     _ptr(pr), _ptr(va), _ptr(vb), _ptr(vc), _ptr(vr),
                     mp.data_ptr(), n, q, dim,
                     _KIND[type(pgeom)], _KIND[type(values)], _EPILOGUE[kind],
                     param, early_exit,
                     *(_ptr(a) for a in (out + [None, None])[:3]),
                     _ptr(weights), _stream(dev))
        _build.check("bvh_callback", err, what)
        bvh_traverse_callback.launches += 1
    return type(state0)(out) if isinstance(state0, (tuple, list)) else out[0]


bvh_traverse_callback.launches = 0
