"""``DistributedTree``: distributed search over a ``torch.distributed``
process group, an :class:`~repro_torch.core.index.Index`, as
``repro.core.distributed``.

ArborX's ``DistributedTree`` takes an MPI communicator, and so does this
one: a process group (``core.comm``), one process per rank. Where the
reference runs one program per shard of a (mesh, axis) pair, every rank
here runs the same calls on its own part of the data:

  * **data stay on their rank.** Rank r passes only its block of values,
    the global rows [r * n_local, (r + 1) * n_local); every rank's block
    has the same length n_local >= 2 (the reference's "N divisible by
    the shard count, at least 2 per shard");
  * **queries are split the same way.** Each rank passes its own block
    of the predicate batch, all of one length, and gets back its own
    queries' results, with global indices;
  * **checks are decided together**, after one small collective
    (``comm.agree``), so every rank raises together and none waits in a
    collective alone.

Structure (the paper's §2.3):

  * each rank builds a LOCAL ``BVH`` over its block, with the card's
    build kernels;
  * the ranks' scene boxes, the (R, dim) top boxes, are all-gathered at
    build (``top_lo`` / ``top_hi``);
  * a query's predicates are all-gathered, answered against every
    rank's local tree, and the per-rank partial results return to the
    rank that asked (``all_to_all``), which merges them: kNN lists by a
    stable sort on distance (ties go to the lower rank), CSR buffers
    valid-first;
  * CALLBACKS RUN ON THE RANK THAT OWNS THE DATA: only the reduced
    states cross the network. ``QueryResult.values`` is None unless
    ``policy.ship_values`` asks for the matched values.

The local steps take the local tree's walk kernels, never brute force,
as the reference pins its compiled walks: kNN through the kNN kernel
(Points, Boxes), the fine kNN kernel (other values) or the ray kNN
kernel (``RayNearest``); counts, CSR fill and callbacks through the
callback kernel where it runs the callback, else the general walk.

Not supported distributed, raised on every rank before any collective:
``RayOrderedIntersect`` (its collect state cannot cross ranks),
``query(out=)`` without ``ship_values`` (the values stay remote) and
``Nearest.exclude``.
"""
from __future__ import annotations

import copy
import dataclasses

import torch

from ..telemetry import tracer as TEL
from . import callbacks as CB
from . import comm
from . import geometry as G
from . import predicates as P
from .access import as_geometry, default_indexable_getter, value_at
from .bvh import BVH
from .index import (ExecutionPolicy, Index, _bcast_state, _warn_deprecated,
                    resolve_device)
from .lbvh import build as lbvh_build
from .route_table import RouteRule, RouteTable

__all__ = ["DistributedTree", "ship_values_baseline"]

#: the local steps' route table: the walk kernels, never brute force
_WALK_TABLE = RouteTable(rules={"default": RouteRule(bf_max_work=-1)})


class DistributedTree(Index):
    """Distributed BVH over the ranks of `group` (None: the default
    group); `values` is this rank's block (any values container with a
    leading axis of n_local, or a raw (n_local, dim) array, read as
    Points under the default getter)."""

    def __init__(self, group, values,
                 indexable_getter=default_indexable_getter, *,
                 policy: ExecutionPolicy | None = None):
        self._init_meta(group, values, indexable_getter, policy)
        # the (R, dim) top boxes and a flag of the local build in one
        # collective: a build that failed on one rank raises on all
        dim, boxes = self.dim, self.local._boxes
        error = None
        try:
            tree = self.local.tree = lbvh_build(boxes)
            row = torch.cat([tree.node_lo[0], tree.node_hi[0],
                             tree.node_lo.new_ones((1,))])
        except Exception as err:
            error = err
            row = torch.zeros((2 * dim + 1,), dtype=boxes.lo.dtype,
                              device=self.device)
        top = comm.stack(self.group, row)
        comm.raise_together(self.group, (top[:, -1] == 0).cpu(), error,
                            "the local build")
        self.top_lo = top[:, :dim].contiguous()
        self.top_hi = top[:, dim:2 * dim].contiguous()

    @classmethod
    def from_local_trees(cls, group, values, tree, top_lo, top_hi,
                         indexable_getter=default_indexable_getter, *,
                         policy: ExecutionPolicy | None = None):
        """Wrap this rank's PREBUILT local tree (an ``LBVH`` over `values`)
        and the (R, dim) top boxes: the swap-in constructor of the
        distributed refit (``ShardedIndexStore``), with no sort, no build
        and no exchange of the top boxes. A tree of another leaf count,
        one whose node count is not 2 n_local - 1, or top boxes of another
        shape raise a ValueError on every rank rather than serve a torn
        index."""
        obj = cls.__new__(cls)
        r = comm.size(comm.group_of(group))

        def refusal(n_local, dim):
            if tree.num_leaves != n_local:
                return (f"the local tree covers {tree.num_leaves} leaves but "
                        f"this rank's block has {n_local} values; rebuild "
                        "instead of wrapping a stale tree")
            nodes = int(tree.node_lo.shape[0])
            if nodes != 2 * n_local - 1:
                return (f"the local tree holds {nodes} nodes but a block of "
                        f"{n_local} values needs {2 * n_local - 1} (= 2n - "
                        "1); was it built over a different block?")
            want = (r, dim)
            if tuple(top_lo.shape) != want or tuple(top_hi.shape) != want:
                return (f"top bounds must be per-rank scene boxes of shape "
                        f"{want}; got {tuple(top_lo.shape)} / "
                        f"{tuple(top_hi.shape)}")
            return None

        obj._init_meta(group, values, indexable_getter, policy, refusal)
        obj.local.tree = tree.to(obj.device)
        obj.top_lo = top_lo.to(obj.device)
        obj.top_hi = top_hi.to(obj.device)
        return obj

    @staticmethod
    def _adapt_values(values, indexable_getter):
        """A raw (n, dim) array as Points under the default getter (as the
        reference's access traits adapt it); other values pass through."""
        if indexable_getter is default_indexable_getter and not isinstance(
                values, G.GEOMETRIES + (dict, tuple, list)):
            return as_geometry(torch.as_tensor(values))
        return values

    def _init_meta(self, group, values, indexable_getter, policy,
                   refusal=None):
        """The group, the policy, this rank's values and the local index
        shell (its tree comes after), then one collective of every rank's
        block length, dimension and refusal: every rank raises together
        on unequal blocks, fewer than 2 values a rank, or a refusal."""
        self.group = comm.group_of(group)
        self.R = comm.size(self.group)
        self.rank = comm.rank(self.group)
        self.policy = policy or ExecutionPolicy()
        self.device = resolve_device(self.policy.device)
        comm.check_device(self.group, self.device)
        values = self._adapt_values(values, indexable_getter)
        self.local = BVH.from_tree(
            values, None, indexable_getter,
            policy=self.policy.override(route_table=_WALK_TABLE))
        self.values = self.local.values
        self._getter = indexable_getter
        n_local, dim = self.local.size(), int(self.local._boxes.dim)
        error = refusal(n_local, dim) if refusal is not None else None
        table = comm.agree(self.group, [n_local, dim, error is not None],
                           self.device)
        if bool(table[:, 2].any()):
            bad = [r for r in range(self.R) if table[r, 2]]
            raise ValueError(error or f"rank(s) {bad} refused their local "
                             "trees: see the error raised there")
        lengths = table[:, 0].tolist()
        if len(set(lengths)) != 1 or len(set(table[:, 1].tolist())) != 1:
            raise ValueError(
                "every rank must pass a block of the same length and "
                f"dimension; got lengths {lengths}, dims "
                f"{table[:, 1].tolist()}")
        if n_local < 2:
            raise ValueError(
                f"DistributedTree needs >= 2 values per rank (got "
                f"{n_local} on each of {self.R} ranks); use BVH for "
                "degenerate sizes")
        self.n_local = n_local
        self.dim = dim

    def _with_group(self, group) -> "DistributedTree":
        """This index with its query collectives on `group`, a group of
        the same ranks in the same order (the store's serving group)."""
        other = copy.copy(self)
        other.group = group
        return other

    @property
    def tree(self):
        """This rank's local LBVH."""
        return self.local.tree

    # --- container interface ---------------------------------------------
    def size(self) -> int:
        return self.R * self.n_local

    def bounds(self) -> G.Boxes:
        """The scene box over every rank's values: the top boxes folded in
        rank order by ``torch.minimum`` / ``torch.maximum``, which keep
        the earlier rank's zero when +0 and -0 tie. So does the
        reference's ``jnp.min`` / ``jnp.max`` over its top boxes, which
        are sharded over the mesh: a cross-device reduce, not the
        single-device one that orders -0 below +0 (``G.min_zeros``)."""
        lo = comm.fold(self.top_lo, torch.minimum)
        hi = comm.fold(self.top_hi, torch.maximum)
        return G.Boxes(lo[None], hi[None])

    # --- the stages (also the sharded executor's) -------------------------
    def _check_q(self, predicates, width: int = 0) -> int:
        """This rank's Q, after one small collective that makes every rank
        raise on unequal blocks or widths (k, capacity). Q = 0 on every
        rank then returns empty results with no further collective."""
        nq = len(predicates)
        table = comm.agree(self.group, [nq, width], self.device)
        if len(set(table[:, 0].tolist())) != 1 or \
                len(set(table[:, 1].tolist())) != 1:
            raise ValueError(
                "every rank must pass a predicate block of the same length "
                f"(and k or capacity); got Q {table[:, 0].tolist()}, width "
                f"{table[:, 1].tolist()}")
        return nq

    def _gather(self, tree):
        """Every rank's block of predicates or states, in rank order."""
        return comm.all_gather(self.group, tree)

    def _globalize(self, idx):
        """Local indices as global rows (-1 stays -1)."""
        off = self.rank * self.n_local
        return torch.where(idx >= 0, idx + off, -1).to(torch.int32)

    def _local_knn(self, preds_all, pol):
        """(dists, global idxs) (Q_all, k) against this rank's tree."""
        d, i = self.local._knn_impl(preds_all, self._walk(pol))
        return d, self._globalize(i)

    def _local_fill(self, preds_all, capacity, pol):
        """(counts, global idxs (Q_all, capacity)) of this rank's matches,
        through a ``collect_hits`` pass."""
        cb, s0 = CB.collect_hits(capacity)
        s0 = _bcast_state(s0, len(preds_all), self.device)
        count, idxs, _ = self.local._query_callback_impl(
            preds_all, cb, s0, self._walk(pol))
        return count, self._globalize(idxs)

    def _exchange(self, parts):
        """(Q_all, ...) partial results (a tuple of tensors or containers)
        -> (R, Q_all / R, ...): row s holds rank s's partials of this
        rank's queries."""
        return comm.all_to_all(self.group, comm.tree_map(
            lambda t: t.reshape((self.R, t.shape[0] // self.R)
                                + t.shape[1:]), parts))

    def _staged(self, kind, inputs, local, merge):
        """gather -> local -> exchange -> merge, each stage under its
        ``distributed.<stage>`` span (fenced when telemetry is on):
        `inputs` (a tuple) all-gathered, ``local(*gathered)`` this rank's
        partials (a tuple), ``merge(*rows)`` this rank's results."""
        with TEL.span("distributed.gather", kind=kind) as sp:
            gathered = sp.fence(self._gather(inputs))
        with TEL.span("distributed.local", kind=kind) as sp:
            partial = sp.fence(local(*gathered))
        with TEL.span("distributed.exchange", kind=kind) as sp:
            rows = sp.fence(self._exchange(partial))
        with TEL.span("distributed.merge", kind=kind) as sp:
            return sp.fence(merge(*rows))

    @staticmethod
    def _walk(pol):
        return pol.override(route_table=_WALK_TABLE)

    # --- backend SPI ------------------------------------------------------
    def _knn_impl(self, predicates, pol):
        """Nearest / RayNearest: every rank answers every query, and the
        R * k candidates of each query merge on the rank that asked."""
        if getattr(predicates, "exclude", None) is not None:
            raise NotImplementedError(
                "Nearest.exclude is not supported on DistributedTree")
        k = predicates.k
        if self._check_q(predicates, k) == 0:
            return (torch.zeros((0, k), device=self.device),
                    torch.full((0, k), -1, dtype=torch.int32,
                               device=self.device))
        return self._staged(
            "ray" if isinstance(predicates, P.RayNearest) else "knn",
            (predicates,), lambda p: self._local_knn(p, pol),
            lambda d, gi: merge_knn(d, gi, k))

    def _query_callback_impl(self, predicates, callback, state0, pol):
        """The callback runs on the rank that owns the data, seeded with
        the gathered state0; each rank then folds every rank's states of
        its own queries in rank order: their sum (``combine=None``, which
        ``psum`` adds in that order) or ``pol.combine``. A non-sum
        combine must be idempotent in state0, which seeds every rank."""
        if self._check_q(predicates) == 0:
            return state0
        return self._staged(
            "callback", (predicates, state0),
            lambda p, s0: (self.local._query_callback_impl(
                p, callback, s0, self._walk(pol)),),
            lambda rows: comm.fold(rows, pol.combine or comm._add))

    def _count_impl(self, predicates, pol):
        # counts always sum, whatever combine the policy carries
        cb, s0 = CB.counting()
        return self._query_callback_impl(
            predicates, cb, _bcast_state(s0, len(predicates), self.device),
            dataclasses.replace(pol, combine=None))

    def _fill_impl(self, predicates, capacity, pol):
        """Every rank collects up to `capacity` of its matches; the (R,
        capacity) buffers of a query meet on the rank that asked and pack
        valid-first. Counts are global, so the base class's doubling retry
        (sized by ``_most`` over every rank) leaves no rank clamping."""
        if self._check_q(predicates, capacity) == 0:
            return (torch.zeros((0,), dtype=torch.int32, device=self.device),
                    torch.full((0, capacity), -1, dtype=torch.int32,
                               device=self.device))
        return self._staged(
            "fill", (predicates,),
            lambda p: self._local_fill(p, capacity, pol),
            lambda count, gi: merge_fill(count, gi, capacity))

    def _most(self, counts) -> int:
        local = int(counts.max()) if counts.numel() else 0
        return int(comm.agree(self.group, [local], self.device).max())

    def _query_ordered(self, predicates, pol):
        raise NotImplementedError(
            "RayOrderedIntersect is single-node only (the collect state "
            "cannot cross ranks); gather values locally or use RayNearest")

    def _query_out(self, predicates, out_fn, pol):
        if not pol.ship_values:
            raise NotImplementedError(
                "DistributedTree cannot run output queries: matched values "
                "stay on the owning rank (use callback=, or "
                "policy.override(ship_values=True))")
        return super()._query_out(predicates, out_fn, pol)

    def _gather_values(self, flat_idx, pol=None):
        """None unless ``pol.ship_values``. Then each rank contributes the
        matched rows it owns of every rank's index list, zeros elsewhere,
        and a sum all-reduce in rank order delivers them, as the
        reference's ``psum``: a stored -0.0 arrives as +0.0 when R > 1."""
        if pol is None or not pol.ship_values:
            return None
        lengths = comm.agree(self.group, [flat_idx.shape[0]],
                             self.device)[:, 0].tolist()
        if sum(lengths) == 0:
            return value_at(self.values, flat_idx.to(torch.int64))
        with TEL.span("distributed.ship", rows=sum(lengths)) as sp:
            every = comm.all_gather_varlen(
                self.group, flat_idx.to(torch.int64), lengths)
            local = every - self.rank * self.n_local
            mine = (local >= 0) & (local < self.n_local)
            rows = value_at(self.values, local.clamp(0, self.n_local - 1))

            def masked(a):
                m = mine.reshape((-1,) + (1,) * (a.dim() - 1))
                return torch.where(m, a, torch.zeros((), dtype=a.dtype,
                                                     device=a.device))

            summed = comm.all_reduce_sum(self.group,
                                         comm.tree_map(masked, rows))
            start = sum(lengths[:self.rank])
            return sp.fence(comm.tree_map(
                lambda a: a[start:start + lengths[self.rank]], summed))


    # --- deprecation shims (the old per-kind methods) ---------------------
    # `queries` is this rank's block, as every query here takes it.
    def _as_queries(self, queries) -> torch.Tensor:
        return torch.as_tensor(queries, device=self.device)

    def query_knn(self, queries, k: int):
        """DEPRECATED: use ``query(nearest(Points(queries), k))``."""
        _warn_deprecated(
            "DistributedTree.query_knn", "query_knn(queries, k) is "
            "deprecated; use query(nearest(G.Points(queries), k=k)) and "
            "read .distances/.indices")
        res = self.query(P.nearest(G.Points(self._as_queries(queries)), k=k))
        return res.distances, res.indices

    def query_radius_count(self, queries, radius):
        """DEPRECATED: use ``query(intersects(Spheres(...)),
        callback=callbacks.counting())`` (or ``count``)."""
        _warn_deprecated(
            "DistributedTree.query_radius_count", "query_radius_count is "
            "deprecated; use count(intersects(G.Spheres(centers, radii)))")
        q = self._as_queries(queries)
        return self.count(P.intersects(G.Spheres(
            q, torch.full((q.shape[0],), radius, dtype=q.dtype,
                          device=q.device))))

    def query_ray_nearest(self, origins, directions, k: int = 1):
        """DEPRECATED: use ``query(RayNearest(Rays(o, d), k))``."""
        _warn_deprecated(
            "DistributedTree.query_ray_nearest", "query_ray_nearest is "
            "deprecated; use query(P.RayNearest(G.Rays(o, d), k))")
        res = self.query(P.RayNearest(G.Rays(
            self._as_queries(origins), self._as_queries(directions)), k))
        return res.distances, res.indices

    def query_callback(self, predicates_maker, callback, state0, queries,
                       combine=None):
        """DEPRECATED: use ``query(predicates, callback=(cb, state0),
        policy=policy.override(combine=...))`` with a real predicate
        batch."""
        _warn_deprecated(
            "DistributedTree.query_callback", "query_callback(maker, cb, "
            "state0, queries) is deprecated; build the predicate batch "
            "yourself and call query(predicates, callback=(cb, state0))")
        preds = predicates_maker(self._as_queries(queries))
        return self.query(preds, callback=(callback, state0),
                          policy=self.policy.override(combine=combine))

    def query_values_to_origin(self, queries, radius, capacity: int):
        """DEPRECATED alias of :func:`ship_values_baseline`."""
        _warn_deprecated(
            "DistributedTree.query_values_to_origin", "query_values_to_"
            "origin is deprecated; use query(predicates, policy=policy."
            "override(ship_values=True)) to ship matched values")
        return ship_values_baseline(self, queries, radius, capacity)


def ship_values_baseline(tree: DistributedTree, queries, radius,
                         capacity: int):
    """DEPRECATED fixed-capacity baseline of value shipping: every rank
    collects up to `capacity` matches of every query within `radius`
    (this rank's block of `queries`, all-gathered) and ships their
    COORDINATES back to the rank that asked, instead of reducing where
    the data live. Returns this rank's (q, R, capacity, dim) values (inf
    where no match) and (q, R) per-rank counts. Requires Points values.
    New code wants ``query(preds,
    policy=tree.policy.override(ship_values=True))``, which ships exactly
    the matched set for any values and any predicate kind."""
    _warn_deprecated(
        "ship_values_baseline", "ship_values_baseline is deprecated; use "
        "query(predicates, policy=policy.override(ship_values=True)) — "
        "QueryResult.values then carries the matched values. The helper "
        "remains only as the fixed-capacity HLO baseline for "
        "benchmarks/bench_distributed.py")
    if not isinstance(tree.values, G.Points):
        raise TypeError("ship_values_baseline requires Points values")
    q_local = tree._as_queries(queries)
    R, dim = tree.R, tree.dim
    qloc = tree._check_q(q_local, capacity)
    if qloc == 0:
        return (torch.zeros((0, R, capacity, dim), device=tree.device),
                torch.zeros((0, R), dtype=torch.int32, device=tree.device))
    q_all = comm.all_gather(tree.group, q_local)
    preds = P.intersects(G.Spheres(q_all, torch.full(
        (q_all.shape[0],), radius, dtype=q_all.dtype, device=tree.device)))
    cb, s0 = CB.collect_hits(capacity)
    s0 = _bcast_state(s0, len(preds), tree.device)
    count, idxs, _ = tree.local._query_callback_impl(
        preds, cb, s0, tree._walk(tree.policy))
    vals = tree.values.coords[idxs.clamp_min(0).to(torch.int64)]
    vals = torch.where((idxs >= 0)[..., None], vals,
                       torch.full((), float("inf"), dtype=vals.dtype,
                                  device=vals.device))
    vals, count = comm.all_to_all(tree.group, (
        vals.reshape(R, qloc, capacity, dim),
        count.to(torch.int32).reshape(R, qloc)))
    return vals.permute(1, 0, 2, 3), count.permute(1, 0)


def merge_knn(d, gi, k: int):
    """(R, q, k) candidate lists of q queries -> their k nearest, (q, k):
    a stable sort on distance, so ties go to the lower rank."""
    r, q, _ = d.shape
    d = d.permute(1, 0, 2).reshape(q, r * k)
    gi = gi.permute(1, 0, 2).reshape(q, r * k)
    d, order = torch.sort(d, dim=1, stable=True)
    return d[:, :k], torch.gather(gi, 1, order[:, :k])


def merge_fill(count, gi, capacity: int):
    """(R, q) counts and (R, q, capacity) buffers -> the global counts
    (q,) and the first `capacity` matches of each query, valid first in
    rank order."""
    r, q, _ = gi.shape
    gi = gi.permute(1, 0, 2).reshape(q, r * capacity)
    _, order = torch.sort((gi < 0).to(torch.int32), dim=1, stable=True)
    buf = torch.gather(gi, 1, order[:, :capacity])
    return count.sum(0).to(torch.int32), buf
