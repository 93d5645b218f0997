"""Geometries: points, boxes and spheres, dimension-generic, as batched
float32 tensors.

A geometry array holds N geometries with coordinate tensors shaped
(N, dim). The formulas below repeat ``repro.core.geometry`` in the same
float32 operation order, so leaf tests agree bit for bit. A squared
distance sums its per-dimension terms in one of two fixed orders, because
the reference itself shows two on XLA:CPU: op by op (its brute force and
leaf tests) each square is rounded and added in turn (``sum_sq``); inside
its jitted traversal kernels XLA fuses each later square into the sum
with a fused multiply-add (``sum_sq_fused``, also the order of the
kernels in ``csrc/``). Triangles, segments, tetrahedra, rays and k-DOPs come in a later
slice.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = [
    "Points", "Boxes", "Spheres", "to_boxes", "centroid", "merge_boxes",
    "expand", "box_union", "fma", "sum_sq", "sum_sq_fused", "sqrt", "distance_point_point",
    "distance_point_box", "distance_point_box_sq", "distance_point_sphere",
    "intersects_box_box", "intersects_box_sphere", "intersects_box_point",
]


@dataclasses.dataclass(frozen=True)
class Points:
    """N points in `dim` dimensions: coords (N, dim)."""
    coords: torch.Tensor

    @property
    def dim(self):
        return self.coords.shape[-1]

    def __len__(self):
        return self.coords.shape[0]

    def to(self, device) -> "Points":
        return Points(self.coords.to(device))

    def index(self, i) -> "Points":
        return Points(self.coords[i])


@dataclasses.dataclass(frozen=True)
class Boxes:
    """Axis-aligned bounding boxes: lo/hi (N, dim)."""
    lo: torch.Tensor
    hi: torch.Tensor

    @property
    def dim(self):
        return self.lo.shape[-1]

    def __len__(self):
        return self.lo.shape[0]

    def to(self, device) -> "Boxes":
        return Boxes(self.lo.to(device), self.hi.to(device))

    def index(self, i) -> "Boxes":
        return Boxes(self.lo[i], self.hi[i])


@dataclasses.dataclass(frozen=True)
class Spheres:
    """Spheres: center (N, dim), radius (N,)."""
    center: torch.Tensor
    radius: torch.Tensor

    @property
    def dim(self):
        return self.center.shape[-1]

    def __len__(self):
        return self.center.shape[0]

    def to(self, device) -> "Spheres":
        return Spheres(self.center.to(device), self.radius.to(device))

    def index(self, i) -> "Spheres":
        return Spheres(self.center[i], self.radius[i])


GEOMETRIES = (Points, Boxes, Spheres)


def _check(geom):
    if not isinstance(geom, GEOMETRIES):
        raise NotImplementedError(
            f"{type(geom).__name__} is not ported yet: the PyTorch port "
            "handles Points, Boxes and Spheres; the other geometries come "
            "with the ray-tracing slice")


# ---------------------------------------------------------------------------
# bounding boxes
# ---------------------------------------------------------------------------

def to_boxes(geom) -> Boxes:
    """Axis-aligned bounding boxes of a geometry array."""
    _check(geom)
    if isinstance(geom, Boxes):
        return geom
    if isinstance(geom, Points):
        return Boxes(geom.coords, geom.coords)
    r = geom.radius[..., None]
    return Boxes(geom.center - r, geom.center + r)


def centroid(geom) -> torch.Tensor:
    """(N, dim) centroids of a geometry array."""
    _check(geom)
    if isinstance(geom, Points):
        return geom.coords
    if isinstance(geom, Spheres):
        return geom.center
    return 0.5 * (geom.lo + geom.hi)


def expand(boxes: Boxes, other: Boxes) -> Boxes:
    """Union of two box arrays elementwise."""
    return Boxes(torch.minimum(boxes.lo, other.lo),
                 torch.maximum(boxes.hi, other.hi))


def merge_boxes(boxes: Boxes) -> Boxes:
    """Reduce a box array into a single enclosing box (shape (1, dim))."""
    return Boxes(boxes.lo.amin(0, keepdim=True), boxes.hi.amax(0, keepdim=True))


def box_union(lo_a, hi_a, lo_b, hi_b):
    return torch.minimum(lo_a, lo_b), torch.maximum(hi_a, hi_b)


# ---------------------------------------------------------------------------
# distance and intersection tests (broadcast over leading axes)
# ---------------------------------------------------------------------------

def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 a * b + c (one rounding, IEEE fmaf).

    The product is exact in float64; the float64 sum is made round-to-odd
    from its exact TwoSum error, and a round-to-odd result at 53 bits
    rounds to the correct 24-bit result (Boldo & Melquiond 2008)."""
    p = a.to(torch.float64) * b.to(torch.float64)
    c = c.to(torch.float64)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, float("inf"), float("-inf"))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def sum_sq(d: torch.Tensor) -> torch.Tensor:
    """Sum of squares over the last axis, dimension 0 first, each square
    rounded before it is added: the order the reference's op-by-op (eager)
    brute force and leaf tests show on XLA:CPU."""
    s = d[..., 0] * d[..., 0]
    for c in range(1, d.shape[-1]):
        s = s + d[..., c] * d[..., c]
    return s


def sum_sq_fused(d: torch.Tensor) -> torch.Tensor:
    """Sum of squares over the last axis as d0*d0, then fma(dc, dc, sum)
    for c = 1, 2, ...: the order XLA:CPU gives the reference's jitted
    traversal kernels (it contracts the squares into fused multiply-adds),
    and the order of the kernels in ``csrc/``."""
    s = d[..., 0] * d[..., 0]
    for c in range(1, d.shape[-1]):
        s = fma(d[..., c], d[..., c], s)
    return s


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root (IEEE sqrtf). PyTorch's
    vectorized CPU sqrt is off by one ulp on about a quarter of float32
    inputs; the square root of the float64 value, rounded once to float32,
    is exact. CUDA's sqrt is already exact."""
    if x.device.type == "cpu":
        return torch.sqrt(x.to(torch.float64)).to(x.dtype)
    return torch.sqrt(x)


# `fused` picks the sum's order: False for the reference's op-by-op code
# (brute force, the N < 2 scans), True for what it runs jitted (the
# traversal walks and the brute-force callback loop)

def _ss(d: torch.Tensor, fused: bool) -> torch.Tensor:
    return sum_sq_fused(d) if fused else sum_sq(d)


def distance_point_point(p, q, fused: bool = False):
    return sqrt(_ss(p - q, fused))


def _box_gap(p, lo, hi):
    return torch.clamp_min(torch.maximum(lo - p, p - hi), 0.0)


def distance_point_box(p, lo, hi, fused: bool = False):
    """Euclidean distance from point to AABB (0 inside)."""
    return sqrt(_ss(_box_gap(p, lo, hi), fused))


def distance_point_box_sq(p, lo, hi, fused: bool = False):
    return _ss(_box_gap(p, lo, hi), fused)


def distance_point_sphere(p, c, r, fused: bool = False):
    return torch.clamp_min(distance_point_point(p, c, fused) - r, 0.0)


def intersects_box_box(lo_a, hi_a, lo_b, hi_b):
    return torch.all((lo_a <= hi_b) & (lo_b <= hi_a), dim=-1)


def intersects_box_sphere(lo, hi, c, r, fused: bool = False):
    return distance_point_box_sq(c, lo, hi, fused) <= r * r


def intersects_box_point(lo, hi, p):
    return torch.all((lo <= p) & (p <= hi), dim=-1)
