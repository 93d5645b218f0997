"""Euclidean minimum spanning tree (§2.4), Borůvka-style, as
``repro.core.emst`` computes it (the GPU single-tree algorithm of
Prokopenko, Sao, Lebrun-Grandié 2023b).

Each Borůvka round:

  1. every point finds its nearest neighbour OUTSIDE its own component:
     one ``Nearest.exclude`` query over all N points, which ``BVH``
     answers with the exclusion walk (on the card the
     ``bvh_traverse_knn_exclude`` kernel, one launch a round);
  2. each component keeps its lexicographically minimal candidate edge
     (w, lo, hi) (``scatter_reduce_(..., "amin")`` three times), so that
     mutual picks are the same edge, and one representative lane (the
     least point index among the minimal ones);
  3. a mutual pick is kept once, by the lane of the smaller component id,
     and the kept edges go into the (N-1) buffer at prefix-sum slots (a
     slot past the buffer is dropped, as the reference's scatter drops
     it);
  4. components merge along every representative edge by hook-to-min and
     pointer jumping, until every such edge lies inside one component.

At most ceil(log2 N) rounds. The reference runs the rounds and the
union's loops as jitted while loops; here they are host loops over device
tensors, and each test is one host sync: a round's edge count, each union
step's "an edge still crosses components", each pointer jump's "a label
moved". ``stats`` receives the counts.
"""
from __future__ import annotations

import torch

from . import geometry as G
from . import predicates as P
from .bvh import BVH
from .index import ExecutionPolicy, placed

__all__ = ["emst"]


def _pointer_jump(labels, syncs):
    """labels = min(labels, labels[labels]) until no label moves."""
    while True:
        nxt = torch.minimum(labels, labels[labels.to(torch.int64)])
        syncs[0] += 1
        if not bool((nxt != labels).any()):
            return nxt
        labels = nxt


def _union_edges(comp, u, v, active, n, syncs):
    """Merge components along the active edges (u, v): hook each edge's
    larger root to its smaller one, then pointer-jump, until every active
    edge is internal to one component."""
    while True:
        ru, rv = comp[u], comp[v]
        act = active & (ru != rv)
        syncs[0] += 1
        if not bool(act.any()):
            return comp
        hooked = torch.cat([comp, comp.new_full((1,), n)])
        hooked.scatter_reduce_(0, torch.where(act, torch.maximum(ru, rv), n)
                               .to(torch.int64), torch.minimum(ru, rv), "amin")
        comp = _pointer_jump(hooked[:n], syncs)


def emst(coords, *, device=None, stats: dict | None = None):
    """EMST over (N, dim) coordinates (a tensor or an array), taken as
    float32 as the reference takes them; a tensor runs where it lives, an
    array on `device` (the CUDA card by default).

    Returns (edges_u, edges_v, edges_w): (N-1,) int32, int32, float32, the
    tree's edges (original point indices) and their euclidean lengths,
    -1 / -1 / inf in slots no round filled. `stats`, when given, receives
    ``rounds`` and ``host_syncs``.
    """
    coords = placed(coords, device)
    dev = coords.device
    n = coords.shape[0]
    pts = G.Points(coords)
    index = BVH(pts, policy=ExecutionPolicy(device=dev))
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    slots = max(n - 1, 0)
    # one spare slot past the buffer takes the edges the reference drops
    eu = torch.full((slots + 1,), -1, dtype=torch.int32, device=dev)
    ev = torch.full((slots + 1,), -1, dtype=torch.int32, device=dev)
    ew = torch.full((slots + 1,), float("inf"), dtype=torch.float32,
                    device=dev)
    comp = idx.clone()
    count, rounds, syncs = 0, 0, [0]
    while count < n - 1:
        rounds += 1
        # 1. the nearest neighbour outside the own component
        res = index.query(P.nearest(pts, k=1, exclude=(comp, comp)))
        d, j = res.distances[:, 0], res.indices[:, 0]
        has = j >= 0
        js = torch.clamp_min(j, 0)
        lo_pt = torch.minimum(idx, js)
        hi_pt = torch.maximum(idx, js)

        # 2. per-component lexicographic argmin over (w, lo, hi)
        c64 = comp.to(torch.int64)
        dd = torch.where(has, d, float("inf"))
        best_w = torch.full((n,), float("inf"), device=dev).scatter_reduce_(
            0, c64, dd, "amin")
        m1 = has & (dd == best_w[c64])

        def least(mask, value):
            return torch.full((n,), n, dtype=torch.int32, device=dev) \
                .scatter_reduce_(0, c64, torch.where(mask, value, n), "amin")

        best_lo = least(m1, lo_pt)
        m2 = m1 & (lo_pt == best_lo[c64])
        best_hi = least(m2, hi_pt)
        m3 = m2 & (hi_pt == best_hi[c64])
        # one representative lane per component: the least index in m3
        is_rep = m3 & (idx == least(m3, idx)[c64])

        # dedup mutual picks: keep the lane of the smaller component id
        other = comp[js.to(torch.int64)].to(torch.int64)
        keep = is_rep & ((comp < other) | (best_hi[other] != hi_pt)
                         | (best_lo[other] != lo_pt)
                         | (best_w[other] != dd))

        # 3. append the kept edges at prefix-sum slots
        pos = count + torch.cumsum(keep, 0) - 1
        tgt = torch.where(keep & (pos < slots), pos, slots)
        eu[tgt] = idx
        ev[tgt] = js
        ew[tgt] = d
        kept = int(keep.sum())
        syncs[0] += 1
        if kept == 0:
            raise ValueError("emst: a Borůvka round found no edge (NaN "
                             "coordinates?)")
        count += kept

        # 4. merge along ALL representative edges (kept and mutual twins)
        comp = _union_edges(comp, idx, js, is_rep, n, syncs)
    if stats is not None:
        stats["rounds"] = rounds
        stats["host_syncs"] = syncs[0]
    return eu[:slots], ev[:slots], ew[:slots]
