"""Geometries: points, boxes, spheres, triangles, segments,
tetrahedra (3-D), k-DOPs and rays, dimension-generic (ray tests against
triangles: 3-D), as batched float32 tensors.

A geometry array holds N geometries with coordinate tensors shaped (N,
dim) (a k-DOP's slabs (N, k/2), with one (k/2, dim) direction set shared
by all). The formulas below repeat ``repro.core.geometry`` in the same
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
:func:`ray_sphere`).

The point tests of segments, triangles and tetrahedra
(``distance_point_segment``, ``distance_point_triangle``,
``point_in_triangle``, ``point_in_tetrahedron``) take an ``order`` of
``ORDERS``, one per way XLA:CPU compiles the reference's contexts (see
:data:`ORDERS`). Bounding boxes order -0 below +0, as XLA's minimum and
maximum do (:func:`min_zeros`).
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = [
    "Points", "Boxes", "Spheres", "Triangles", "Segments", "Tetrahedra", "KDOPs",
    "Rays", "kdop_directions", "to_boxes", "centroid", "merge_boxes",
    "min_zeros", "max_zeros", "ORDERS", "distance_point_segment",
    "distance_point_triangle", "point_in_triangle", "point_in_tetrahedron",
    "expand", "box_union", "fma", "sum_sq", "sum_sq_fused", "sqrt", "distance_point_point",
    "distance_point_box", "distance_point_box_sq", "distance_point_sphere",
    "intersects_box_box", "intersects_box_sphere", "intersects_box_point",
    "cross", "dot", "ray_box", "ray_sphere", "ray_triangle",
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
class Segments:
    """Line segments: endpoints a/b (N, dim)."""
    a: torch.Tensor
    b: torch.Tensor

    @property
    def dim(self):
        return self.a.shape[-1]

    def __len__(self):
        return self.a.shape[0]

    def to(self, device) -> "Segments":
        return Segments(self.a.to(device), self.b.to(device))

    def index(self, i) -> "Segments":
        return Segments(self.a[i], self.b[i])


@dataclasses.dataclass(frozen=True)
class Tetrahedra:
    """Tetrahedra: vertices a/b/c/d (N, 3)."""
    a: torch.Tensor
    b: torch.Tensor
    c: torch.Tensor
    d: torch.Tensor

    @property
    def dim(self):
        return self.a.shape[-1]

    def __len__(self):
        return self.a.shape[0]

    def to(self, device) -> "Tetrahedra":
        return Tetrahedra(self.a.to(device), self.b.to(device),
                          self.c.to(device), self.d.to(device))

    def index(self, i) -> "Tetrahedra":
        return Tetrahedra(self.a[i], self.b[i], self.c[i], self.d[i])


def kdop_directions(dim: int, k: int, dtype=torch.float32,
                    device=None) -> torch.Tensor:
    """Slab directions of k-DOPs (Klosowski et al. 1998): 2-D k in {4, 8},
    3-D k in {6, 14, 18, 26}. (k/2, dim) integer (unnormalized)
    directions, the axes first; a k-DOP holds the min / max support along
    each."""
    if dim == 2:
        sets = {4: [(1, 0), (0, 1)], 8: [(1, 0), (0, 1), (1, 1), (1, -1)]}
    elif dim == 3:
        axes = [(1, 0, 0), (0, 1, 0), (0, 0, 1)]
        diag = [(1, 1, 1), (1, -1, 1), (1, 1, -1), (1, -1, -1)]
        edge = [(1, 1, 0), (1, -1, 0), (1, 0, 1), (1, 0, -1), (0, 1, 1),
                (0, 1, -1)]
        sets = {6: axes, 14: axes + diag, 18: axes + edge,
                26: axes + diag + edge}
    else:
        raise ValueError(f"kDOP only defined for dim 2/3, got {dim}")
    if k not in sets:
        raise ValueError(f"unsupported {dim}D kDOP k={k}")
    return torch.tensor(sets[k], dtype=dtype, device=device)


@dataclasses.dataclass(frozen=True)
class KDOPs:
    """k-DOPs: support intervals lo/hi (N, k/2) along the shared
    `directions` (k/2, dim), which ``index`` keeps whole."""
    lo: torch.Tensor
    hi: torch.Tensor
    directions: torch.Tensor

    @property
    def dim(self):
        return self.directions.shape[-1]

    def __len__(self):
        return self.lo.shape[0]

    def to(self, device) -> "KDOPs":
        return KDOPs(self.lo.to(device), self.hi.to(device),
                     self.directions.to(device))

    def index(self, i) -> "KDOPs":
        return KDOPs(self.lo[i], self.hi[i], self.directions)


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


GEOMETRIES = (Points, Boxes, Spheres, Triangles, Segments, Tetrahedra, KDOPs,
              Rays)


# ---------------------------------------------------------------------------
# bounding boxes
# ---------------------------------------------------------------------------

def min_zeros(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """torch.minimum with -0 below +0, as XLA's minimum (``torch.minimum``
    returns its first operand when they are zeros of two signs); NaN
    propagates."""
    tie = (a.view(torch.int32) | b.view(torch.int32)).view(torch.float32)
    return torch.where(a == b, tie, torch.minimum(a, b))


def max_zeros(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """torch.maximum with +0 above -0, as XLA's maximum; NaN propagates."""
    tie = (a.view(torch.int32) & b.view(torch.int32)).view(torch.float32)
    return torch.where(a == b, tie, torch.maximum(a, b))


def _vertex_box(*vs) -> Boxes:
    lo, hi = vs[0], vs[0]
    for v in vs[1:]:
        lo, hi = min_zeros(lo, v), max_zeros(hi, v)
    return Boxes(lo, hi)


def to_boxes(geom) -> Boxes:
    """Axis-aligned bounding boxes of a geometry array: a k-DOP's is its
    first `dim` slabs (the axes of every direction set)."""
    if isinstance(geom, Boxes):
        return geom
    if isinstance(geom, Points):
        return Boxes(geom.coords, geom.coords)
    if isinstance(geom, Spheres):
        r = geom.radius[..., None]
        return Boxes(geom.center - r, geom.center + r)
    if isinstance(geom, Triangles):
        return _vertex_box(geom.a, geom.b, geom.c)
    if isinstance(geom, Segments):
        return _vertex_box(geom.a, geom.b)
    if isinstance(geom, Tetrahedra):
        return _vertex_box(geom.a, geom.b, geom.c, geom.d)
    if isinstance(geom, KDOPs):
        return Boxes(geom.lo[..., :geom.dim], geom.hi[..., :geom.dim])
    raise TypeError(f"no bounding box rule for {type(geom).__name__}")


def centroid(geom) -> torch.Tensor:
    """(N, dim) centroids of a geometry array."""
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
# point tests of segments, triangles and tetrahedra
# ---------------------------------------------------------------------------

#: float orders of the point tests, one per way XLA:CPU compiles the
#: reference's contexts (found bit for bit by tests/test_torch_geometry.py):
#:
#:   * "eager": op by op (brute force's match and distance matrices, the
#:     N < 2 scans): every product rounded, dot products from dimension 0;
#:   * "walk": the jitted walks (``traverse``, ``traverse_knn``) and the
#:     callback kernel, whose dot products fuse each later product into the
#:     sum (:func:`dot` with ``fused``), except where a segment's own
#:     difference vectors are made in the same loop as the product: a
#:     segment's p.ab and ab.ab stay unfused, as do those of a triangle's
#:     edge (b, c) (its edges (a, b) and (a, c) reuse the triangle's own
#:     fused dot products, which XLA shares); a difference of products
#:     x * y - z * w fuses as fma(x, y, -(z * w)), a projection a + t ab
#:     as fma(t, ab, a);
#:     ``point_in_triangle`` rounds its five dot products product by
#:     product in "walk" (and fuses its differences);
#:   * "loop": the brute-force callback loop (``fori_loop``): every dot
#:     product fused, a segment's p.ab and ab.ab (a triangle's edge (b, c)
#:     too) and ``point_in_triangle``'s.
ORDERS = ("eager", "walk", "loop")


def _check_order(order):
    if order not in ORDERS:
        raise ValueError(f"order {order!r} is not one of {ORDERS}")


def _segment(p, a, b, dots_fused, fused):
    """|p - proj(p, [a, b])| in one float order: `dots_fused` for p.ab
    and ab.ab, `fused` for the rest."""
    ab = b - a
    den = torch.clamp_min(dot(ab, ab, dots_fused), 1e-30)
    t = torch.clamp(dot(p - a, ab, dots_fused) / den, 0.0, 1.0)
    proj = fma(t[..., None], ab, a) if fused else a + t[..., None] * ab
    return sqrt(_ss(p - proj, fused))


def distance_point_segment(p, a, b, order: str = "eager"):
    """Distance from p to the segment [a, b] (any dim), in the float order
    `order` (:data:`ORDERS`)."""
    _check_order(order)
    fused = order != "eager"
    return _segment(p, a, b, order == "loop", fused)


def _diff(x, y, z, w, fused):
    """x * y - z * w, fused as fma(x, y, -(z * w))."""
    return fma(x, y, -(z * w)) if fused else x * y - z * w


def _barycentric(p, a, b, c, dots_fused, fused):
    """(ab, ac, v, w): the projection of p on the triangle's plane is
    a + v ab + w ac; `dots_fused` for the five dot products, `fused` for
    the differences of products."""
    ab, ac, ap = b - a, c - a, p - a
    d1, d2 = dot(ab, ap, dots_fused), dot(ac, ap, dots_fused)
    d00, d01 = dot(ab, ab, dots_fused), dot(ab, ac, dots_fused)
    d11 = dot(ac, ac, dots_fused)
    denom = torch.clamp_min(_diff(d00, d11, d01, d01, fused), 1e-30)
    v = _diff(d11, d1, d01, d2, fused) / denom
    w = _diff(d00, d2, d01, d1, fused) / denom
    return ab, ac, v, w


def distance_point_triangle(p, a, b, c, order: str = "eager"):
    """Distance from p to the triangle (a, b, c) (any dim; exact in 2-D and
    3-D): to the projection on its plane where that falls inside, else to
    the nearest edge; in the float order `order` (:data:`ORDERS`)."""
    _check_order(order)
    fused, loop = order != "eager", order == "loop"
    ab, ac, v, w = _barycentric(p, a, b, c, fused, fused)
    inside = (v >= 0) & (w >= 0) & (v + w <= 1)
    if fused:
        proj = fma(w[..., None], ac, fma(v[..., None], ab, a))
    else:
        proj = a + v[..., None] * ab + w[..., None] * ac
    d_plane = sqrt(_ss(p - proj, fused))
    d_edges = torch.minimum(
        _segment(p, a, b, fused, fused),
        torch.minimum(_segment(p, b, c, loop, fused),
                      _segment(p, a, c, fused, fused)))
    return torch.where(inside, d_plane, d_edges)


def point_in_triangle(p, a, b, c, order: str = "eager"):
    """Does the projection of p on the triangle's plane fall inside it
    (barycentric coordinates within 1e-7)? Any dim. Its "walk" order
    rounds the five dot products one product at a time (XLA:CPU makes
    them apart from the differences, which it fuses), unlike
    :func:`distance_point_triangle`'s."""
    _check_order(order)
    _, _, v, w = _barycentric(p, a, b, c, order == "loop",
                                 order != "eager")
    return (v >= -1e-7) & (w >= -1e-7) & (v + w <= 1 + 1e-7)


def point_in_tetrahedron(p, a, b, c, d, order: str = "eager"):
    """Is p inside the tetrahedron (a, b, c, d) (3-D)? For each face, p and
    the opposite vertex lie on the same side: the product of their dot
    products with the face normal (``cross``) is >= -1e-9."""
    _check_order(order)
    fused = order != "eager"

    def same_side(v0, v1, v2, v3):
        n = cross(v1 - v0, v2 - v0)
        return dot(n, v3 - v0, fused) * dot(n, p - v0, fused) >= -1e-9

    return (same_side(a, b, c, d) & same_side(b, c, d, a)
            & same_side(c, d, a, b) & same_side(d, a, b, c))


# ---------------------------------------------------------------------------
# ray tests (ArborX 2.0 section 2.5): (hit, t) with t = inf on a miss
# ---------------------------------------------------------------------------

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
    _check_order(order)
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
