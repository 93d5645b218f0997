"""Brute-force search index: tests every predicate against every value.
Exact by construction (up to the matrix expansion of Points-to-Points
kNN distances, as in the reference) and the BVH's oracle in tests.
Callbacks run over each query's matches in index order, with early exit.
Ray predicates match where the ray hits; RayNearest ranks by t.

Queries are taken in blocks of ``BLOCK_Q`` so the (Q, N) matrices stay
bounded. Float32 products run in full float32: TF32 would change the
distances and so the counts.
"""
from __future__ import annotations

import torch

from . import geometry as G
from . import predicates as P
from .access import default_indexable_getter
from .index import ExecutionPolicy, Index, QueryResult, resolve_device
from .traversal import _leaves, _map, value_at

__all__ = ["BruteForce", "pairwise_sq_distances"]

#: queries per block: a (BLOCK_Q, N) float32 matrix is 1 GiB at N = 2^20
BLOCK_Q = 256


def pairwise_sq_distances(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(Q, N) squared euclidean distances, ||x||^2 - 2 x.y^T + ||y||^2,
    with the product in full float32 (TF32 off for the call)."""
    x2 = (x * x).sum(-1, keepdim=True)
    y2 = (y * y).sum(-1, keepdim=True).T
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        xy = x @ y.T
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return torch.clamp_min(x2 - 2.0 * xy + y2, 0.0)


class BruteForce(Index):
    """Stores values; queries evaluate the predicate against every value."""

    def __init__(self, values, indexable_getter=default_indexable_getter, *,
                 policy: ExecutionPolicy | None = None):
        self.policy = policy or ExecutionPolicy()
        self.device = resolve_device(self.policy.device)
        self.values = values.to(self.device)
        self._getter = indexable_getter
        self._boxes = indexable_getter(self.values)
        self._n = len(self._boxes)

    def size(self) -> int:
        return self._n

    def bounds(self) -> G.Boxes:
        return G.merge_boxes(self._boxes)

    # --- backend SPI ------------------------------------------------------
    def _query_callback_impl(self, predicates, callback, state0, pol):
        """Apply `callback` on every match, in index order per query, until
        it reports done. Step j takes every live query's j-th match. The
        leaf tests take the order of the reference's compiled loop (squared
        sums fused; the "loop" order of ``geometry.ray_sphere``), and ray
        hits hand the callback their t."""
        q = len(predicates)
        dev = self.device
        state = _map(torch.clone, state0)
        if q == 0 or self._n == 0:
            return state
        mask, tmat = self._leaf_matrices(predicates, "loop")
        counts = mask.sum(-1)
        ar = torch.arange(self._n, device=dev)
        order = torch.sort(torch.where(mask, ar[None, :], self._n), dim=1).values
        done = torch.zeros((q,), dtype=torch.bool, device=dev)
        for j in range(int(counts.max())):
            act = torch.nonzero((counts > j) & ~done).squeeze(1)
            if act.numel() == 0:
                break
            idx = order[act, j]
            st = _map(lambda a: a[act], state)
            t = (torch.zeros((act.numel(),), dtype=torch.float32, device=dev)
                 if tmat is None else tmat[act, idx])
            new, cb_done = callback(st, P.take(predicates, act),
                                    value_at(self.values, idx),
                                    idx.to(torch.int32), t)
            for leaf, sel in zip(_leaves(state), _leaves(new)):
                leaf[act] = sel.to(leaf.dtype)
            done[act] = torch.as_tensor(cb_done, dtype=torch.bool,
                                        device=dev).expand(act.shape)
        return state

    def _count_impl(self, predicates, pol):
        return self._match_matrix(predicates).sum(-1).to(torch.int32)

    def _csr_exact(self, predicates, pol):
        """One-pass exact CSR from the (Q, N) match matrix (Intersects and
        RayIntersect)."""
        if not isinstance(predicates, (P.Intersects, P.RayIntersect)):
            return None
        mask = self._match_matrix(predicates)
        counts = mask.sum(-1).to(torch.int32)
        offsets = torch.cat([torch.zeros((1,), dtype=torch.int32,
                                         device=mask.device),
                             torch.cumsum(counts, 0)]).to(torch.int32)
        # nonzero is row-major: already CSR-ordered by query
        idx = torch.nonzero(mask)[:, 1].to(torch.int32)
        return QueryResult(values=value_at(self.values, idx.to(torch.int64)),
                           indices=idx, offsets=offsets)

    def _fill_impl(self, predicates, capacity, pol):
        """Full counts plus the first `capacity` matched indices per query
        (index order), -1 padded."""
        mask = self._match_matrix(predicates)
        counts = mask.sum(-1).to(torch.int32)
        n = mask.shape[1]
        ar = torch.arange(n, dtype=torch.int32, device=mask.device)
        key = torch.where(mask, ar[None, :], n)
        first = torch.sort(key, dim=1).values[:, :capacity]
        buf = torch.where(first < n, first, -1).to(torch.int32)
        if buf.shape[1] < capacity:
            pad = torch.full((buf.shape[0], capacity - buf.shape[1]), -1,
                             dtype=torch.int32, device=buf.device)
            buf = torch.cat([buf, pad], 1)
        return counts, buf

    def _knn_impl(self, predicates, pol):
        """(dists, idxs) (Q, k): exact k nearest by fine distance (ray
        predicates: by hit parameter t, misses (inf, -1)), ties to the lower
        index (a stable sort, as lax.top_k orders them), (inf, -1) padded
        past N. Under ``Nearest.exclude`` a pair of equal labels takes
        d = inf before the sort, so it comes back (inf, -1)."""
        k = predicates.k
        k_eff = min(k, self._n)

        def top(blk):
            d = self._distances(blk)
            if getattr(blk, "exclude", None) is not None:
                query_labels, leaf_labels = blk.exclude
                d = torch.where(leaf_labels[None, :] == query_labels[:, None],
                                float("inf"), d)
            d, i = torch.sort(d, dim=1, stable=True)
            return d[:, :k_eff], i[:, :k_eff].to(torch.int32)

        dists, idx = self._blocks(top, predicates)
        if k_eff < k:
            q = dists.shape[0]
            dists = torch.cat([dists, torch.full((q, k - k_eff), float("inf"),
                                                 device=dists.device)], 1)
            idx = torch.cat([idx, torch.full((q, k - k_eff), -1,
                                             dtype=torch.int32,
                                             device=idx.device)], 1)
        idx = torch.where(torch.isinf(dists), -1, idx)
        return dists, idx

    # -- internals -----------------------------------------------------------
    def _blocks(self, fn, predicates):
        """fn over blocks of BLOCK_Q queries, outputs joined on axis 0."""
        outs = [fn(P.take(predicates, slice(s, s + BLOCK_Q)))
                for s in range(0, max(len(predicates), 1), BLOCK_Q)]
        if isinstance(outs[0], tuple):
            return tuple(torch.cat(parts, 0) for parts in zip(*outs))
        return torch.cat(outs, 0)

    def _leaf_matrices(self, predicates, order: str = "eager"):
        """(Q, N) bool exact leaf tests in float order `order`, and for ray
        predicates the (Q, N) float32 hit parameters t (else None)."""
        if isinstance(predicates, P.RAY_KINDS):
            return self._blocks(
                lambda blk: P.leaf_ray_hit(P.lift(blk), self.values, order),
                predicates)
        return self._blocks(
            lambda blk: P.leaf_match_test(P.lift(blk), self.values, order),
            predicates), None

    def _match_matrix(self, predicates):
        """(Q, N) bool exact leaf tests, op by op as the reference's eager
        brute force."""
        return self._leaf_matrices(predicates)[0]

    def _distances(self, blk):
        """(B, N) fine distances of one block of Nearest queries (ray
        predicates: t)."""
        g = P.geometry_of(blk)
        if isinstance(g, G.Points) and isinstance(self.values, G.Points):
            return G.sqrt(pairwise_sq_distances(g.coords,
                                                    self.values.coords))
        return P.leaf_distance(P.lift(blk), self.values)
