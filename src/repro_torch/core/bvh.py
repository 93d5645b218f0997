"""ArborX API v2 ``BVH``, an :class:`~repro_torch.core.index.Index`.

``BVH(values, indexable_getter=..., policy=...)`` places the values on
the policy's device (the CUDA card by default), builds the LBVH there and
answers ``query()``. This class implements the backend SPI: count, fill,
kNN and callbacks routed by the QueryEngine to brute force, the
traversal kernels or the general walk, plus the N < 2 linear-scan paths.
On the loop route, count and fill run the ``counting`` and
``collect_hits`` callbacks, which the callback kernel serves where it
can (Intersects over Spheres, Triangles, Segments, Tetrahedra and KDOPs
values, and every ray predicate, for two). ``Nearest`` over Spheres,
Triangles, Segments, Tetrahedra or KDOPs values takes the fine kNN
kernel where the engine routes it there (the default getter, k <=
``KNN_MAX_K``), else the general k-nearest walk. ``RayNearest``
takes the ray kNN kernel where the engine routes it there (Points,
Boxes, Spheres or 3-D Triangles values, k <= ``KNN_MAX_K``), else the
general k-nearest walk; both give the same (t, idx) bit for bit. The
3-D ray walks on the card read the leaves' value records, made at first
use and kept with the index (:attr:`BVH.value_records`). A ``Nearest``
with ``exclude`` takes the exclusion walk whatever the engine's route,
as the reference pins its loop walk: the exclusion kernel
(``kernels.bvh_traverse.bvh_traverse_knn_exclude``) for Points queries
over Points or Boxes values, ``traversal.knn_walk`` for other shapes,
and brute force with the labels masked for N < 2.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from ..kernels import bvh_traverse as BT
from . import callbacks as CB
from . import engine as E
from . import geometry as G
from . import lbvh
from . import predicates as P
from . import traversal as T
from .access import default_indexable_getter
from .index import (ExecutionPolicy, Index, _bcast_state, _is_legacy_space,
                    _warn_deprecated, resolve_device)

__all__ = ["BVH"]


class BVH(Index):
    def __init__(self, values, indexable_getter=default_indexable_getter,
                 *_legacy, policy: ExecutionPolicy | None = None, engine=None,
                 bits: int = 64):
        if _is_legacy_space(values):
            _warn_deprecated(
                "BVH.__init__", "BVH(space, values, ...) is deprecated; "
                "use BVH(values, indexable_getter=..., policy="
                "ExecutionPolicy(device=space))")
            space, values = values, indexable_getter
            indexable_getter = _legacy[0] if _legacy \
                else default_indexable_getter
            policy = (policy or ExecutionPolicy()).override(device=space)
        elif _legacy:
            raise TypeError("BVH() takes at most 2 positional arguments "
                            "(values, indexable_getter)")
        self._init_common(values, indexable_getter, policy, engine)
        if self._n >= 2:
            self.tree = lbvh.build(self._boxes, bits=bits)
        else:
            self.tree = None  # degenerate; queries take the linear scan

    @classmethod
    def from_tree(cls, values, tree, indexable_getter=default_indexable_getter,
                  *_legacy, policy: ExecutionPolicy | None = None,
                  engine=None):
        """Wrap an existing LBVH over (possibly moved) values without
        rebuilding. The caller guarantees `tree` bounds the values."""
        if _is_legacy_space(values):
            _warn_deprecated(
                "BVH.from_tree", "BVH.from_tree(space, values, tree) is "
                "deprecated; use BVH.from_tree(values, tree, policy=...)")
            space, values, tree = values, tree, indexable_getter
            indexable_getter = _legacy[0] if _legacy \
                else default_indexable_getter
            policy = (policy or ExecutionPolicy()).override(device=space)
        elif _legacy:
            raise TypeError("BVH.from_tree() takes at most 3 positional "
                            "arguments (values, tree, indexable_getter)")
        obj = cls.__new__(cls)
        obj._init_common(values, indexable_getter, policy, engine)
        if tree is not None and tree.device != obj.device:
            tree = tree.to(obj.device)
        obj.tree = tree     # on its device already: its kept records too
        return obj

    def _init_common(self, values, indexable_getter, policy, engine):
        self.policy = policy or ExecutionPolicy()
        if engine is not None:
            self.policy = self.policy.override(engine=engine)
        self.device = resolve_device(self.policy.device)
        self.values = values.to(self.device)
        self._getter = indexable_getter
        self._boxes = indexable_getter(self.values)
        self._n = len(self._boxes)
        # the spatial and kNN kernels' leaf test is the box test: exact only
        # for values whose fine test is their bounding-box test; the
        # callback and fine kNN kernels test each value geometry exactly,
        # but their node boxes must still be the values' own bounding
        # boxes
        default = indexable_getter is default_indexable_getter
        self.kernel_values_ok = default and isinstance(
            self.values, (G.Points, G.Boxes))
        self.kernel_callback_ok = default and not isinstance(self.values,
                                                             G.Rays)
        self._bf = None

    def _brute(self):
        """Brute-force sibling index over the same values."""
        if self._bf is None:
            from .brute_force import BruteForce
            self._bf = BruteForce(self.values, self._getter, policy=self.policy)
        return self._bf

    @functools.cached_property
    def value_records(self):
        """The 16-byte value records of Spheres, Segments, Triangles or
        Tetrahedra values in the tree's sorted-leaf order that the 3-D
        walks read (``kernels.bvh_traverse.pack_values``), made at first
        use and kept with the index; None for other values, other dims and
        N < 2."""
        from ..kernels.bvh_traverse import pack_values
        if self.tree is None:
            return None
        return pack_values(self.values, self.tree.leaf_perm)

    # --- container interface -----------------------------------------------
    def size(self) -> int:
        return self._n

    def bounds(self) -> G.Boxes:
        if self.tree is None:
            if self._n:
                return G.merge_boxes(self._boxes)
            return G.Boxes(torch.zeros((1, 0), device=self.device),
                           torch.zeros((1, 0), device=self.device))
        return G.Boxes(self.tree.node_lo[:1], self.tree.node_hi[:1])

    # --- backend SPI ------------------------------------------------------
    def _query_callback_impl(self, predicates, callback, state0, pol):
        """Per-query final states: the fused kernel runs the callback in
        the walk's epilogue where it can, the general walk otherwise; the
        states are bit-identical either way."""
        if self.tree is None:
            return _degenerate_callback(self.values, self._n, predicates,
                                        callback, state0, self.device)
        return pol.resolve_engine().run_callback(self, predicates, callback,
                                                 state0)

    def _count_impl(self, predicates, pol):
        if self.tree is not None:
            engine = pol.resolve_engine()
            route = engine.route_spatial(self, predicates, policy=pol)
            if route == E.ROUTE_BRUTEFORCE:
                return self._brute()._count_impl(predicates, pol)
            if route == E.ROUTE_KERNEL:
                return engine.kernel_count(self, predicates)
        cb, s0 = CB.counting()
        return self._query_callback_impl(
            predicates, cb, _bcast_state(s0, len(predicates), self.device), pol)

    def _fill_impl(self, predicates, capacity, pol):
        """(counts, idx_buf (Q, capacity)): full counts and the first
        `capacity` matched indices per query (the match SET per query is
        route-independent, the buffer order is not)."""
        if self.tree is not None:
            engine = pol.resolve_engine()
            route = engine.route_spatial(self, predicates, policy=pol)
            if route == E.ROUTE_BRUTEFORCE:
                return self._brute()._fill_impl(predicates, capacity, pol)
            if route == E.ROUTE_KERNEL:
                return engine.kernel_fill(self, predicates, capacity)
        cb, s0 = CB.collect_hits(capacity)
        count, idxs, _ = self._query_callback_impl(
            predicates, cb, _bcast_state(s0, len(predicates), self.device), pol)
        return count, idxs

    def _csr_exact(self, predicates, pol):
        """Brute-force route, no capacity: one-pass CSR."""
        if (self.tree is not None
                and pol.resolve_engine().route_spatial(self, predicates, policy=pol)
                == E.ROUTE_BRUTEFORCE):
            return self._brute()._csr_exact(predicates, pol)
        return None

    def _knn_impl(self, predicates, pol):
        if isinstance(predicates, P.Nearest) and predicates.exclude is not None:
            if self.tree is None:
                return self._brute()._knn_impl(predicates, pol)
            return self._knn_exclude(predicates)
        if self.tree is None:
            return _degenerate_knn(self.values, self._n, predicates, self.device)
        engine = pol.resolve_engine()
        route = engine.route_knn(self, predicates, policy=pol)
        if route == E.ROUTE_BRUTEFORCE:
            return self._brute()._knn_impl(predicates, pol)
        if route == E.ROUTE_KERNEL:
            return engine.kernel_knn(self, predicates)
        return T.traverse_knn(self.tree, self.values, predicates,
                              predicates.k)

    def _knn_exclude(self, predicates):
        """(dists, idxs) of a ``Nearest.exclude`` batch: the exclusion
        kernel where it takes the batch (on the card a 3-D tree's kept
        node records, and the leaf order when the queries are the indexed
        points), else the general k-nearest walk."""
        t, k = self.tree, predicates.k
        query_labels, leaf_labels = predicates.exclude
        if (self.kernel_values_ok and isinstance(predicates.geom, G.Points)
                and t.dim <= BT.MAX_DIM and k <= BT.KNN_MAX_K):
            queries = predicates.geom.coords.to(torch.float32)
            records = order = None
            if t.node_lo.is_cuda:
                records = t.records
                coords = (self.values.coords
                          if isinstance(self.values, G.Points) else None)
                order = BT.knn_order(queries, coords, t.leaf_perm)
            return BT.bvh_traverse_knn_exclude(
                t.node_lo, t.node_hi, t.rope, t.left_child, t.leaf_perm,
                t.range_first, t.range_last, queries, query_labels,
                leaf_labels, k=k, records=records, order=order)
        plain = dataclasses.replace(predicates, exclude=None)
        return T.traverse_knn(t, self.values, plain, k,
                              exclude_labels=query_labels,
                              leaf_labels=leaf_labels)


# --- degenerate N in {0, 1}: linear scan ---------------------------------

def _degenerate_callback(values, n, predicates, callback, state0, dev):
    """The callback applied where the one value (if any) matches, with
    the ray parameter t for ray predicates (the reference's eager scan)."""
    q = len(predicates)
    if n == 0 or q == 0:
        return state0
    zero = torch.zeros((q,), dtype=torch.int32, device=dev)
    val = T.value_at(values, zero.to(torch.int64))
    fine, t = P.leaf_test(predicates, val)
    new, _ = callback(state0, predicates, val, zero, t)
    return T.tree_select(fine, new, state0)


def _degenerate_knn(values, n, predicates, dev):
    q, k = len(predicates), predicates.k
    dists = torch.full((q, k), float("inf"), device=dev)
    idxs = torch.full((q, k), -1, dtype=torch.int32, device=dev)
    if n == 0 or q == 0:
        return dists, idxs
    d = P.leaf_distance(P.lift(predicates), values)[:, 0]
    dists[:, 0] = d
    idxs[:, 0] = torch.where(torch.isfinite(d), 0, -1).to(torch.int32)
    return dists, idxs
