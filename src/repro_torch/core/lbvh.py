"""LBVH construction: Morton sort, Karras ranges, Apetrei links, AABBs
and ropes in closed form, as in ``repro.core.lbvh`` (its fused build).

  1. the sort key of each leaf: the Morton code of its box's centroid in
     the centroids' scene (``kernels.morton.morton_key``), stable sort;
  2. node ranges and splits: ``kernels.lbvh_build.karras_ranges``;
  3. the tail (``kernels.lbvh_build.lbvh_tail``): links in O(1) per node
     from range and split, every node's box, the ropes (rope(node covering
     [f, l]) = right_child(split_owner(l))) and, in 3-D, the node records
     the 3-D walks read.

Each step launches its CUDA kernel on the card (``csrc/morton.cu``,
``karras.cu``, ``lbvh_tail.cu``: the tail climbs bottom up, as ArborX
builds) and runs its plain twin on the CPU (the reference's quantize and
interleave, its Karras searches, its RMQ sparse table with
``refit="rmq"``).

Node numbering: internal 0..N-2 (root 0), leaves N-1..2N-2 (leaf id =
N-1 + sorted position); rope -1 ends the walk. Every field equals the
reference's node for node.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from ..kernels import lbvh_build as K
from ..kernels import morton as KM
from . import morton as M
from .geometry import Boxes, fma

__all__ = ["LBVH", "build", "refit", "refit_with_quality", "sah_cost",
           "FIELDS"]


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
        (``kernels.bvh_traverse.pack_nodes``): written by the build and the
        refit, made at first use for a tree made otherwise (``.to()``,
        ``convert.lbvh_from_numpy``), and kept with the tree; None in
        other dims."""
        from ..kernels.bvh_traverse import pack_nodes
        if self.dim != 3:
            return None
        return pack_nodes(self.node_lo, self.node_hi, self.rope,
                          self.left_child, self.leaf_perm)


FIELDS = tuple(f.name for f in dataclasses.fields(LBVH))


def _with_records(tree: LBVH, records) -> LBVH:
    """Keep the records the tail made where ``LBVH.records`` caches its
    value (the instance's ``__dict__``)."""
    if records is not None:
        tree.__dict__["records"] = records
    return tree


def build(boxes: Boxes, *, bits: int = 64) -> LBVH:
    """Build an LBVH over N >= 2 leaf boxes on the boxes' device (the
    reference's ``refit="rmq"`` tree; every refit gives the same floats).

    bits: 32 or 64 (Morton code width; 64 is the ArborX 2.0 default)."""
    if bits not in (32, 64):
        raise ValueError(f"bits must be 32 or 64, got {bits}")
    n = boxes.lo.shape[0]
    if n < 2:
        raise ValueError("LBVH requires N >= 2 (the BVH handles N in {0, 1})")
    key = KM.morton_key(boxes.lo, boxes.hi, bits)
    key, perm = torch.sort(key, stable=True)
    hi, lo, idx = M.key_lanes(key)
    del key
    first, last, gamma = K.karras_ranges(hi, lo, idx, n, K.max_log2(n))
    del hi, lo, idx
    *fields, records = K.lbvh_tail(first, last, gamma, perm, boxes.lo,
                                   boxes.hi)
    return _with_records(LBVH(*fields, first), records)


def refit(tree: LBVH, boxes: Boxes) -> LBVH:
    """Recompute every AABB (and the records) for new leaf boxes (original
    index order, as the build input), keeping the topology: no sort."""
    n = tree.num_leaves
    if boxes.lo.shape[0] != n:
        raise ValueError(f"refit needs the same leaf count (tree has {n}, "
                         f"got {boxes.lo.shape[0]}); rebuild instead")
    node_lo, node_hi, records = K.lbvh_refit(
        tree.left_child, tree.right_child, tree.rope, tree.range_first,
        tree.range_last, tree.leaf_perm, boxes.lo, boxes.hi)
    return _with_records(dataclasses.replace(tree, node_lo=node_lo,
                                             node_hi=node_hi), records)


def refit_with_quality(tree: LBVH, boxes: Boxes) -> tuple[LBVH, torch.Tensor]:
    """``(refit(tree, boxes), sah)`` in one call: the refit tree and the
    SAH cost of its node boxes (``sah_cost``), a 0-d tensor on the tree's
    device. ``service.IndexStore.update`` decides refit or rebuild on it."""
    new = refit(tree, boxes)
    return new, sah_cost(new)


def _surface_measure(lo, hi, fused: bool = False):
    """(M,) surface measure: sum over faces of the product of the other
    extents; the interval length in 1-D. The rounded products are summed
    in face order; in 3-D with `fused`, as the reference's jitted
    ``sah_cost`` computes them beside its windowed sum (M > 32), two of
    the three products are contracted into fused multiply-adds,
    fma(e0, e1, fma(e1, e2, e0 * e2))."""
    e = torch.clamp_min(hi - lo, 0.0)
    d = e.shape[-1]
    if d == 1:
        return e[..., 0]
    if d == 3 and fused:
        e0, e1, e2 = e.unbind(-1)
        return fma(e0, e1, fma(e1, e2, e0 * e2))
    total = torch.zeros(e.shape[:-1], dtype=e.dtype, device=e.device)
    for i in range(d):
        keep = torch.arange(d, device=e.device) != i
        total = total + torch.where(keep, e, 1.0).prod(dim=-1)
    return total


#: the window of XLA:CPU's tree reduction rewrite
_XLA_WINDOW = 32


def _xla_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum of a 1-d float32 tensor in XLA:CPU's order for ``jnp.sum``: up
    to 32 elements added in sequence from 0; a longer one padded with
    zeros (half the padding in front, the odd one behind) to whole
    windows of 32, each window summed in sequence, and the window sums
    summed the same way."""
    m = x.shape[0]
    if m <= _XLA_WINDOW:
        s = torch.zeros((), dtype=x.dtype, device=x.device)
        for j in range(m):
            s = s + x[j]
        return s
    w = -(-m // _XLA_WINDOW)
    pad = w * _XLA_WINDOW - m
    cols = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2))
    cols = cols.reshape(w, _XLA_WINDOW)
    s = torch.zeros((w,), dtype=x.dtype, device=x.device)
    for j in range(_XLA_WINDOW):
        s = s + cols[:, j]
    return _xla_sum(s)


def sah_cost(tree: LBVH) -> torch.Tensor:
    """SAH-style quality: sum of internal-node surface measures over the
    root's. Lower is better; drifting leaves under refit inflate it. In
    dims 1-3 it equals the reference's jitted ``sah_cost`` bit for bit:
    the per-node measures of its fusion, summed in XLA:CPU's order
    (:func:`_xla_sum`)."""
    n = tree.num_leaves
    areas = _surface_measure(tree.node_lo[:n - 1], tree.node_hi[:n - 1],
                             fused=n - 1 > _XLA_WINDOW)
    tiny = torch.finfo(areas.dtype).tiny
    return _xla_sum(areas) / torch.clamp_min(areas[0], tiny)
