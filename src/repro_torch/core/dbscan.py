"""DBSCAN: FDBSCAN and FDBSCAN-DenseBox (Prokopenko et al. 2023a), as
``repro.core.dbscan`` computes them.

  1. Core points: count the neighbours within eps with early termination
     at min_pts (``callbacks.count_with_limit`` through
     ``query(callback=)``).
  2. Clusters: hook and pointer jumping. Every round, each core point
     takes the min label among its core neighbours (the ``_min_where``
     epilogue over the (N,) core flags and labels), then labels are
     compressed by repeated ``L = min(L, L[L])``; rounds repeat until no
     label changes. The reference's jitted while loops are host loops over
     device tensors here, one ``any()`` sync per step.

FDBSCAN-DenseBox first overlays a grid of cell side eps / sqrt(dim): every
point of a cell holding >= min_pts points is core, and the cell's points
start with one label (the cell's min index).

Labels: cluster id = min original index in the cluster; border points
take the min label among their core neighbours; noise = -1. So labels are
canonical and equal the reference's exactly.
"""
from __future__ import annotations

import numpy as np
import torch

from . import callbacks as CB
from . import geometry as G
from . import predicates as P
from .bvh import BVH
from .index import ExecutionPolicy, resolve_device

__all__ = ["dbscan", "core_points", "relabel_compact"]

_BIG = 2**31 - 1


def _neighbourhoods(pts: G.Points, eps) -> P.Intersects:
    n = len(pts)
    return P.intersects(G.Spheres(pts.coords, torch.full(
        (n,), eps, dtype=pts.coords.dtype, device=pts.coords.device)))


def core_points(index: BVH, pts: G.Points, eps: float, min_pts: int):
    """(N,) bool: at least min_pts neighbours within eps (self included),
    counted with early termination at min_pts."""
    counts = index.query(_neighbourhoods(pts, eps),
                         callback=CB.count_with_limit(min_pts))
    return counts >= min_pts


def _min_core_label_round(index, pts, eps, is_core, labels):
    """For every point, the min label among its core neighbours within
    eps (_BIG when it has none)."""
    return index.query(_neighbourhoods(pts, eps),
                       callback=CB._min_where(is_core, labels, _BIG))


def _pointer_jump_core(labels):
    """Compress labels read as pointers into point-index space to their
    fixpoint of ``L = min(L, L[L])``; _BIG (unassigned) entries stay."""
    n = labels.shape[0]
    inside = labels < n
    ar = torch.arange(n, dtype=labels.dtype, device=labels.device)
    safe = torch.where(inside, labels, ar)
    while True:
        nxt = torch.minimum(safe, safe[safe.to(torch.int64)])
        if not bool((nxt != safe).any()):
            break
        safe = nxt
    return torch.where(inside, safe, labels)


def _dense_cells(coords, eps, min_pts):
    """Grid preprocessing for FDBSCAN-DenseBox: (cell_label, cell_core),
    per point the min index of its cell when the cell is dense (else its
    own index), and whether the cell is dense.

    Cell indices are floor((coords - lo) / h) with h = eps / sqrt(dim),
    all in float32 in the reference's order; cells are ranked by a
    lexicographic sort of the per-dimension indices (stable sorts from
    the last key to the first)."""
    n, dim = coords.shape
    dev = coords.device
    h = np.float32(eps) / np.sqrt(np.float32(dim))
    lo = coords.amin(0)
    cell = torch.floor((coords - lo) / torch.tensor(h, device=dev)).to(torch.int32)

    perm = torch.arange(n, dtype=torch.int64, device=dev)
    for d in reversed(range(dim)):
        order = torch.sort(cell[perm, d], stable=True).indices
        perm = perm[order]
    cell_s = cell[perm]
    new_cell = torch.ones((n,), dtype=torch.bool, device=dev)
    new_cell[1:] = (cell_s[1:] != cell_s[:-1]).any(1)
    seg = torch.cumsum(new_cell.to(torch.int64), 0) - 1
    seg_count = torch.zeros((n,), dtype=torch.int64, device=dev).scatter_add_(
        0, seg, torch.ones_like(seg))
    perm32 = perm.to(torch.int32)
    seg_min = torch.full((n,), _BIG, dtype=torch.int32, device=dev).scatter_reduce_(
        0, seg, perm32, "amin")
    dense_s = seg_count[seg] >= min_pts
    label_s = torch.where(dense_s, seg_min[seg], perm32)
    cell_label = torch.empty((n,), dtype=torch.int32, device=dev)
    cell_label[perm] = label_s
    cell_core = torch.empty((n,), dtype=torch.bool, device=dev)
    cell_core[perm] = dense_s
    return cell_label, cell_core


def dbscan(coords, eps: float, min_pts: int, *, algorithm: str = "fdbscan",
           policy: ExecutionPolicy | None = None):
    """DBSCAN over (N, dim) coordinates (a tensor or an array), taken as
    float32 as the reference takes them.

    algorithm: "fdbscan" (sparse data) or "fdbscan-densebox" (dense
        regions).
    policy: where the index lives (the CUDA card by default).
    Returns (labels (N,) int32, is_core (N,) bool); labels[i] = -1 for
    noise, else the min original index in i's cluster.
    """
    if algorithm not in ("fdbscan", "fdbscan-densebox"):
        raise ValueError(f"unknown algorithm {algorithm!r}")
    policy = policy or ExecutionPolicy()
    coords = torch.as_tensor(coords, dtype=torch.float32,
                             device=resolve_device(policy.device))
    n = coords.shape[0]
    pts = G.Points(coords)
    index = BVH(pts, policy=policy)
    if algorithm == "fdbscan-densebox":
        cell_label, cell_core = _dense_cells(coords, eps, min_pts)
        is_core = cell_core | core_points(index, pts, eps, min_pts)
        labels = torch.where(is_core, cell_label, _BIG)
    else:
        is_core = core_points(index, pts, eps, min_pts)
        labels = torch.where(
            is_core, torch.arange(n, dtype=torch.int32, device=coords.device),
            _BIG)

    while True:
        m = _min_core_label_round(index, pts, eps, is_core, labels)
        new = torch.where(is_core, torch.minimum(labels, m), labels)
        new = torch.where(is_core, _pointer_jump_core(new), new)
        changed = bool((new != labels).any())
        labels = new
        if not changed:
            break

    border = _min_core_label_round(index, pts, eps, is_core, labels)
    labels = torch.where(is_core, labels, border)
    labels = torch.where(labels == _BIG, -1, labels)
    return labels, is_core


def relabel_compact(labels):
    """Renumber labels to 0..C-1 in order of their ids (noise stays -1).
    Host-side helper; returns a numpy array."""
    lab = labels.detach().cpu().numpy() if isinstance(labels, torch.Tensor) \
        else np.asarray(labels)
    out = np.full_like(lab, -1)
    uniq = np.unique(lab[lab >= 0])
    for c, u in enumerate(uniq):
        out[lab == u] = c
    return out
