"""Geometries: points, boxes, spheres, triangles and rays,
dimension-generic (triangles: 3-D), as batched float32 tensors.

A geometry array holds N geometries with coordinate tensors shaped
(N, dim). The formulas below repeat ``repro.core.geometry`` in the same
float32 operation order, so leaf tests agree bit for bit. A squared
distance sums its per-dimension terms in one of two fixed orders, because
the reference itself shows two on XLA:CPU: op by op (its brute force and
leaf tests) each square is rounded and added in turn (``sum_sq``); inside
its jitted traversal kernels XLA fuses each later square into the sum
with a fused multiply-add (``sum_sq_fused``, also the order of the
kernels in ``csrc/``).

The ray tests (``ray_box``, ``ray_sphere``, ``ray_triangle``) follow the
same rule for their dot products: ``fused`` picks the reference's jitted
order (each product after the first fused into the running sum) or its
op-by-op order, and ``cross`` fuses as ``jnp.cross`` does in both (it
is jitted itself). ``ray_sphere`` takes one of three orders, because
XLA:CPU compiles the reference's three sphere contexts three ways (see
:func:`ray_sphere`). Segments, tetrahedra and k-DOPs are not ported;
spatial predicates over triangles (``point_in_triangle``,
``distance_point_triangle``) come in a later slice.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = [
    "Points", "Boxes", "Spheres", "Triangles", "Rays", "to_boxes", "centroid", "merge_boxes",
    "expand", "box_union", "fma", "sum_sq", "sum_sq_fused", "sqrt", "distance_point_point",
    "distance_point_box", "distance_point_box_sq", "distance_point_sphere",
    "intersects_box_box", "intersects_box_sphere", "intersects_box_point",
    "cross", "dot", "ray_box", "ray_sphere", "ray_triangle", "SPHERE_ORDERS",
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


@dataclasses.dataclass(frozen=True)
class Triangles:
    """Triangles: vertices a/b/c (N, dim)."""
    a: torch.Tensor
    b: torch.Tensor
    c: torch.Tensor

    @property
    def dim(self):
        return self.a.shape[-1]

    def __len__(self):
        return self.a.shape[0]

    def to(self, device) -> "Triangles":
        return Triangles(self.a.to(device), self.b.to(device),
                         self.c.to(device))

    def index(self, i) -> "Triangles":
        return Triangles(self.a[i], self.b[i], self.c[i])


@dataclasses.dataclass(frozen=True)
class Rays:
    """Rays: origin (N, dim), direction (N, dim) (need not be normalized)."""
    origin: torch.Tensor
    direction: torch.Tensor

    @property
    def dim(self):
        return self.origin.shape[-1]

    def __len__(self):
        return self.origin.shape[0]

    def to(self, device) -> "Rays":
        return Rays(self.origin.to(device), self.direction.to(device))

    def index(self, i) -> "Rays":
        return Rays(self.origin[i], self.direction[i])


GEOMETRIES = (Points, Boxes, Spheres, Triangles, Rays)


def _check(geom):
    if not isinstance(geom, GEOMETRIES):
        raise NotImplementedError(
            f"{type(geom).__name__} is not ported yet: the PyTorch port "
            "handles Points, Boxes, Spheres, Triangles and Rays; Segments, "
            "Tetrahedra and KDOPs are not ported")


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
    if isinstance(geom, Spheres):
        r = geom.radius[..., None]
        return Boxes(geom.center - r, geom.center + r)
    if isinstance(geom, Triangles):
        return Boxes(torch.minimum(torch.minimum(geom.a, geom.b), geom.c),
                     torch.maximum(torch.maximum(geom.a, geom.b), geom.c))
    raise TypeError(f"no bounding box rule for {type(geom).__name__}")


def centroid(geom) -> torch.Tensor:
    """(N, dim) centroids of a geometry array."""
    _check(geom)
    if isinstance(geom, Points):
        return geom.coords
    if isinstance(geom, Spheres):
        return geom.center
    b = to_boxes(geom)
    return 0.5 * (b.lo + b.hi)


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


# ---------------------------------------------------------------------------
# ray tests (ArborX 2.0 section 2.5): (hit, t) with t = inf on a miss
# ---------------------------------------------------------------------------

#: float orders of ray_sphere, one per way XLA:CPU compiles the reference
SPHERE_ORDERS = ("eager", "walk", "loop")


def dot(x: torch.Tensor, y: torch.Tensor, fused: bool) -> torch.Tensor:
    """Dot product over the last axis, dimension 0 first. The first
    product is added to +0 (the reference's reductions start there, which
    turns a -0 into +0); each later product is rounded and added
    (``fused=False``) or fused into the sum (``fused=True``)."""
    s = x[..., 0] * y[..., 0] + 0.0
    for c in range(1, x.shape[-1]):
        s = fma(x[..., c], y[..., c], s) if fused else s + x[..., c] * y[..., c]
    return s


def cross(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """3-D cross product over the last axis, each component
    ``fma(x_i, y_j, -(x_j * y_i))``: how XLA:CPU compiles ``jnp.cross``,
    which is jitted in eager code too."""
    x0, x1, x2 = x.unbind(-1)
    y0, y1, y2 = y.unbind(-1)
    return torch.stack([fma(x1, y2, -(x2 * y1)), fma(x2, y0, -(x0 * y2)),
                        fma(x0, y1, -(x1 * y0))], -1)


def _inf_like(t):
    return torch.full_like(t, float("inf"))


def ray_box(origin, direction, lo, hi):
    """Slab test: (hit, t_enter), t >= 0 only. A zero direction component
    (|d| < 1e-30) makes its slab (-inf, inf) when the origin lies inside
    it and a miss otherwise. No products are summed, so every path of the
    reference gives the same bits."""
    zero = direction.abs() < 1e-30
    inv = 1.0 / torch.where(zero, torch.ones_like(direction), direction)
    t0 = (lo - origin) * inv
    t1 = (hi - origin) * inv
    inside = (origin >= lo) & (origin <= hi)
    inf = _inf_like(t0)
    tmin_d = torch.where(zero, torch.where(inside, -inf, inf),
                         torch.minimum(t0, t1))
    tmax_d = torch.where(zero, torch.where(inside, inf, -inf),
                         torch.maximum(t0, t1))
    tmin = tmin_d.amax(-1)
    tmax = tmax_d.amin(-1)
    t_enter = torch.clamp_min(tmin, 0.0)
    hit = tmax >= t_enter
    return hit, torch.where(hit, t_enter, _inf_like(t_enter))


def ray_sphere(origin, direction, center, radius, order: str = "eager"):
    """Nearest non-negative root of |o + t d - c|^2 = r^2: (hit, t).

    ``order`` is the float order of one of the reference's contexts, as
    XLA:CPU compiles it (found bit for bit and read from its dumps):

      * "eager": op by op (brute force's match and distance matrices, the
        N < 2 scans): every product rounded, sums from dimension 0;
      * "walk": the jitted walks (``traverse``, ``traverse_knn``) and the
        callback kernel: d.d and (o-c).d fused, |o-c|^2 unfused,
        c = fma(-r, r, |o-c|^2), disc = fma(b, b, -(d.d * c)). The
        reference's walks round their last Q mod 8 lanes (and Q = 1) with
        scalar code that fuses |o-c|^2 too; its callback kernel pads
        every block to 8 lanes and never does;
      * "loop": the brute-force callback loop (``fori_loop``): all three
        dots fused, c = |o-c|^2 - r*r unfused, disc as "walk".
    """
    if order not in SPHERE_ORDERS:
        raise ValueError(f"order {order!r} is not one of {SPHERE_ORDERS}")
    fused = order != "eager"
    d2 = dot(direction, direction, fused)
    oc = origin - center
    b = dot(oc, direction, fused)
    s = dot(oc, oc, order == "loop")
    if order == "walk":
        c = fma(-radius, radius, s)
    else:
        c = s - radius * radius
    disc = b * b - d2 * c if order == "eager" else fma(b, b, -(d2 * c))
    sq = sqrt(torch.clamp_min(disc, 0.0))
    den = torch.clamp_min(d2, 1e-30)
    t0 = (-b - sq) / den
    t1 = (-b + sq) / den
    t = torch.where(t0 >= 0, t0, t1)
    hit = (disc >= 0) & (t >= 0)
    return hit, torch.where(hit, t, _inf_like(t))


def ray_triangle(origin, direction, a, b, c, fused: bool = False):
    """Moller-Trumbore, 3-D only: (hit, t). ``fused`` picks the jitted
    order of the four dot products (every jitted context of the
    reference compiles them alike) or the op-by-op one."""
    if origin.shape[-1] != 3:
        raise NotImplementedError("ray_triangle is 3-D only, got dimension "
                                  f"{origin.shape[-1]}")
    e1, e2 = b - a, c - a
    pvec = cross(direction, e2)
    det = dot(e1, pvec, fused)
    tiny = torch.where(det >= 0, 1e-12, -1e-12).to(det.dtype)
    inv_det = 1.0 / torch.where(det.abs() < 1e-12, tiny, det)
    tvec = origin - a
    u = dot(tvec, pvec, fused) * inv_det
    qvec = cross(tvec, e1)
    v = dot(direction, qvec, fused) * inv_det
    t = dot(e2, qvec, fused) * inv_det
    hit = ((det.abs() > 1e-12) & (u >= -1e-7) & (v >= -1e-7)
           & (u + v <= 1 + 1e-7) & (t >= 0))
    return hit, torch.where(hit, t, _inf_like(t))
