"""LBVH construction: Morton sort, Karras ranges, Apetrei links, RMQ
AABBs and ropes in closed form, as in ``repro.core.lbvh`` (its fused
build with ``refit="rmq"``).

  1. Morton codes of the box centroids, stable sort;
  2. node ranges and splits: ``kernels.lbvh_build.karras_ranges`` (the
     CUDA kernel on the card, its plain twin on the CPU);
  3. links in O(1) per node from range and split;
  4. internal AABBs as range minima over a sparse table;
  5. ropes: rope(node covering [f, l]) = right_child(split_owner(l)).

Node numbering: internal 0..N-2 (root 0), leaves N-1..2N-2 (leaf id =
N-1 + sorted position); rope -1 ends the walk. Every field equals the
reference's node for node.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from ..kernels import lbvh_build as K
from . import morton as M
from .geometry import Boxes

__all__ = ["LBVH", "build", "refit", "sah_cost", "FIELDS"]

SENTINEL = -1


@dataclasses.dataclass(frozen=True)
class LBVH:
    """Flat LBVH; every field is a tensor on the index's device."""
    node_lo: torch.Tensor      # (2N-1, dim) float32 node AABB mins (internal | leaves)
    node_hi: torch.Tensor      # (2N-1, dim)
    left_child: torch.Tensor   # (N-1,) int32 node ids
    right_child: torch.Tensor  # (N-1,)
    rope: torch.Tensor         # (2N-1,) int32 escape pointers (-1 = done)
    range_last: torch.Tensor   # (2N-1,) int32 last sorted-leaf position in subtree
    leaf_perm: torch.Tensor    # (N,) int32 sorted leaf position -> original index
    range_first: torch.Tensor  # (N-1,) int32 first sorted-leaf position per internal node

    @property
    def num_leaves(self):
        return self.leaf_perm.shape[0]

    @property
    def dim(self):
        return self.node_lo.shape[-1]

    @property
    def device(self):
        return self.node_lo.device

    def to(self, device) -> "LBVH":
        return LBVH(*(getattr(self, f).to(device) for f in FIELDS))

    @functools.cached_property
    def records(self):
        """The (2N-1, 8) int32 node records of a 3-D tree that the 3-D
        instances of the spatial, callback and kNN kernels read
        (``kernels.bvh_traverse.pack_nodes``), made at first use and kept
        with the tree; None in other dims."""
        from ..kernels.bvh_traverse import pack_nodes
        if self.dim != 3:
            return None
        return pack_nodes(self.node_lo, self.node_hi, self.rope,
                          self.left_child, self.leaf_perm)


FIELDS = tuple(f.name for f in dataclasses.fields(LBVH))


def _max_log2(n: int) -> int:
    return max((n - 1).bit_length(), 1)


def build(boxes: Boxes, *, bits: int = 64) -> LBVH:
    """Build an LBVH over N >= 2 leaf boxes on the boxes' device, with the
    RMQ sparse-table refit (the reference's ``refit="rmq"``).

    bits: 32 or 64 (Morton code width; 64 is the ArborX 2.0 default)."""
    if bits not in (32, 64):
        raise ValueError(f"bits must be 32 or 64, got {bits}")
    leaf_lo_u, leaf_hi_u = boxes.lo, boxes.hi
    n, _ = leaf_lo_u.shape
    if n < 2:
        raise ValueError("LBVH requires N >= 2 (the BVH handles N in {0, 1})")
    dev = leaf_lo_u.device
    max_log2 = _max_log2(n)

    centroids = 0.5 * (leaf_lo_u + leaf_hi_u)
    scene_lo, scene_hi = centroids.amin(0), centroids.amax(0)
    morton = M.morton64 if bits == 64 else M.morton32
    codes = morton(centroids, scene_lo, scene_hi)
    perm0 = torch.arange(n, dtype=torch.int64, device=dev)
    codes_s, perm = M.sort_by_morton(codes, perm0)
    hi, lo, idx = M.combined_delta_key(codes_s, n)
    del codes, codes_s

    leaf_lo = leaf_lo_u[perm]
    leaf_hi = leaf_hi_u[perm]

    first, last, gamma = K.karras_ranges(hi, lo, idx, n, max_log2)
    del hi, lo, idx

    # Apetrei links: the child at gamma / gamma+1 is a leaf exactly when it
    # coincides with the range end
    left_child = torch.where(gamma == first, (n - 1) + gamma, gamma).to(torch.int32)
    right_child = torch.where(gamma + 1 == last, (n - 1) + gamma + 1,
                              gamma + 1).to(torch.int32)

    int_lo, int_hi = K.aabb_rmq(leaf_lo, leaf_hi, first, last, max_log2)
    node_lo = torch.cat([int_lo, leaf_lo], 0)
    node_hi = torch.cat([int_hi, leaf_hi], 0)
    del int_lo, int_hi

    # ropes in closed form: the splits are a bijection onto [0, N-2]
    split_owner = torch.zeros((n - 1,), dtype=torch.int64, device=dev)
    split_owner[gamma.to(torch.int64)] = torch.arange(n - 1, device=dev)
    leaf_pos = torch.arange(n, dtype=torch.int32, device=dev)
    range_last = torch.cat([last, leaf_pos]).to(torch.int32)
    safe_last = torch.clamp(range_last, 0, n - 2).to(torch.int64)
    rope = torch.where(range_last >= n - 1, SENTINEL,
                       right_child[split_owner[safe_last]]).to(torch.int32)

    return LBVH(node_lo, node_hi, left_child, right_child, rope, range_last,
                perm.to(torch.int32), first.to(torch.int32))


def refit(tree: LBVH, boxes: Boxes) -> LBVH:
    """Recompute every AABB for new leaf boxes (original index order, as
    the build input), keeping the topology: one RMQ pass, no sort."""
    n = tree.num_leaves
    if boxes.lo.shape[0] != n:
        raise ValueError(f"refit needs the same leaf count (tree has {n}, "
                         f"got {boxes.lo.shape[0]}); rebuild instead")
    perm = tree.leaf_perm.to(torch.int64)
    leaf_lo = boxes.lo[perm]
    leaf_hi = boxes.hi[perm]
    int_lo, int_hi = K.aabb_rmq(leaf_lo, leaf_hi, tree.range_first,
                                tree.range_last[:n - 1], _max_log2(n))
    return dataclasses.replace(tree, node_lo=torch.cat([int_lo, leaf_lo], 0),
                               node_hi=torch.cat([int_hi, leaf_hi], 0))


def _surface_measure(lo, hi):
    """(M,) surface measure: sum over faces of the product of the other
    extents; the interval length in 1-D."""
    e = torch.clamp_min(hi - lo, 0.0)
    d = e.shape[-1]
    if d == 1:
        return e[..., 0]
    total = torch.zeros(e.shape[:-1], dtype=e.dtype, device=e.device)
    for i in range(d):
        keep = torch.arange(d, device=e.device) != i
        total = total + torch.where(keep, e, 1.0).prod(dim=-1)
    return total


def sah_cost(tree: LBVH) -> torch.Tensor:
    """SAH-style quality: sum of internal-node surface measures over the
    root's. Lower is better; drifting leaves under refit inflate it."""
    n = tree.num_leaves
    areas = _surface_measure(tree.node_lo[:n - 1], tree.node_hi[:n - 1])
    tiny = torch.finfo(areas.dtype).tiny
    return areas.sum() / torch.clamp_min(areas[0], tiny)
