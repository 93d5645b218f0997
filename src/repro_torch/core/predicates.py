"""Predicates: ``intersects`` and ``nearest`` over every geometry, and
the ray predicates (``RayNearest``, ``RayIntersect``,
``RayOrderedIntersect``) over Rays, with the node tests the traversal
walks prune with and the fine leaf tests.

A predicate array holds Q predicates of one kind. The tests broadcast:
give the predicate geometry a (Q, 1, ...) shape and the values (N, ...)
to get a (Q, N) result, or give both A rows to test lane by lane. The
node tests run in the jitted walks of the reference, so their squared
sums take the fused order (``geometry.sum_sq_fused``); the leaf tests
take the float order of their context, one of ``geometry.ORDERS``
("eager", "walk" or "loop"). A ray predicate's node test is the slab
test (``geometry.ray_box``), its "distance" the ray parameter t, and its
leaf test :func:`leaf_ray_hit`, whose float order is one of
``geometry.ORDERS`` too (see ``geometry.ray_sphere``).

``Nearest.exclude = (query_labels (Q,), leaf_labels (N,))``, two int32
tensors, leaf labels in original index order, is Borůvka's "nearest
outside my component" (EMST): a value is a candidate for query q only
where ``leaf_labels[index] != query_labels[q]``; a query with no
candidate left keeps (inf, -1) slots. ``BVH`` answers it with the
exclusion walk whatever the engine's route, as the reference pins its
compiled loop walk: ``kernels.bvh_traverse.bvh_traverse_knn_exclude``
(its kernel on the card, its twin on the CPU) for Points queries over
Points or Boxes values under the default getter, with k <= ``KNN_MAX_K``
and dim <= ``MAX_DIM``; ``traversal.knn_walk`` for any other shape.
``BruteForce`` (and a BVH of N < 2) masks the excluded pairs before its
sort. The engine's routes and the serving stack refuse it.
"""
from __future__ import annotations

import dataclasses

import torch

from . import geometry as G
from .access import value_at

__all__ = ["Intersects", "Nearest", "RayNearest", "RayIntersect",
           "RayOrderedIntersect", "RAY_KINDS", "intersects", "nearest",
           "attach_data", "geometry_of", "lift", "take", "node_overlap_test",
           "node_min_distance", "leaf_match_test", "leaf_distance",
           "leaf_ray_hit", "leaf_test"]


def _to(data, device):
    """A predicate payload (tensor, geometry, or a dict / tuple / list of
    them) on `device`."""
    if data is None:
        return None
    if isinstance(data, (torch.Tensor,) + G.GEOMETRIES):
        return data.to(device)
    if isinstance(data, dict):
        return {k: _to(v, device) for k, v in data.items()}
    if isinstance(data, (tuple, list)):
        return type(data)(_to(v, device) for v in data)
    raise TypeError(f"cannot move predicate data of type {type(data).__name__}")


@dataclasses.dataclass(frozen=True)
class Intersects:
    """Spatial predicate: match values whose geometry intersects `geom`."""
    geom: object
    data: object = None

    def __len__(self):
        return len(self.geom)

    def to(self, device) -> "Intersects":
        return dataclasses.replace(self, geom=self.geom.to(device),
                                   data=_to(self.data, device))


@dataclasses.dataclass(frozen=True)
class Nearest:
    """k-nearest predicate over the centroids of `geom`; `exclude`, when
    given, is the ``(query_labels, leaf_labels)`` pair of int32 tensors of
    the module docstring."""
    geom: object
    k: int = 1
    data: object = None
    exclude: object = None

    def __post_init__(self):
        if self.exclude is None:
            return
        ok = (isinstance(self.exclude, tuple) and len(self.exclude) == 2
              and all(isinstance(t, torch.Tensor) and t.dim() == 1
                      and t.dtype == torch.int32 for t in self.exclude))
        if not ok or self.exclude[0].shape[0] != len(self.geom):
            raise ValueError(
                "Nearest.exclude must be (query_labels (Q,), leaf_labels "
                "(N,)), two int32 tensors, one query label per predicate")

    def __len__(self):
        return len(self.geom)

    def to(self, device) -> "Nearest":
        exclude = (None if self.exclude is None
                   else tuple(t.to(device) for t in self.exclude))
        return dataclasses.replace(self, geom=self.geom.to(device),
                                   data=_to(self.data, device),
                                   exclude=exclude)


@dataclasses.dataclass(frozen=True)
class _RayPredicate:
    rays: G.Rays

    def __len__(self):
        return len(self.rays)

    def to(self, device):
        return dataclasses.replace(self, rays=self.rays.to(device),
                                   data=_to(self.data, device))


@dataclasses.dataclass(frozen=True)
class RayNearest(_RayPredicate):
    """The first k hits along each ray (k = 1: the closest object)."""
    k: int = 1
    data: object = None


@dataclasses.dataclass(frozen=True)
class RayIntersect(_RayPredicate):
    """Every hit along each ray (transparent objects)."""
    data: object = None


@dataclasses.dataclass(frozen=True)
class RayOrderedIntersect(_RayPredicate):
    """Every hit along each ray, ordered by the ray parameter t."""
    data: object = None


RAY_KINDS = (RayNearest, RayIntersect, RayOrderedIntersect)


def intersects(geom, data=None) -> Intersects:
    """ArborX::intersects; ``intersects(Spheres(c, r))`` is the API-v2
    spelling of ``within(c, r)``."""
    return Intersects(geom, data)


def nearest(geom, k: int = 1, data=None, exclude=None) -> Nearest:
    return Nearest(geom, k, data, exclude)


def attach_data(pred, data):
    """ArborX::attach analogue: the predicate with payload `data` (one row
    per predicate), handed to callbacks as ``pred.data``."""
    return dataclasses.replace(pred, data=data)


def _field(pred) -> str:
    return "rays" if isinstance(pred, RAY_KINDS) else "geom"


def geometry_of(pred):
    """The geometry array a predicate holds: its rays or its geometry."""
    return getattr(pred, _field(pred))


def take(pred, i):
    """Rows `i` of a predicate array, its payload included (and the query
    labels of a ``Nearest.exclude``, whose leaf labels stay whole)."""
    data = None if pred.data is None else value_at(pred.data, i)
    rows = {_field(pred): geometry_of(pred).index(i)}
    if getattr(pred, "exclude", None) is not None:
        query_labels, leaf_labels = pred.exclude
        rows["exclude"] = (query_labels[i], leaf_labels)
    return dataclasses.replace(pred, data=data, **rows)


def lift(pred):
    """The predicate with its geometry given a (Q, 1, ...) shape, so the
    leaf tests broadcast against (N, ...) values into (Q, N)."""
    g = geometry_of(pred)
    if isinstance(g, G.KDOPs):
        g = G.KDOPs(g.lo[:, None, :], g.hi[:, None, :], g.directions)
    else:
        g = type(g)(*(t[:, None] for t in vars(g).values()))
    return dataclasses.replace(pred, **{_field(pred): g})


def node_overlap_test(pred, lo, hi):
    """May the subtree under box [lo, hi] hold matches of `pred`
    (Intersects, or a ray predicate: the slab test)? A Triangles,
    Segments or Tetrahedra query is its bounding box; a KDOPs query has
    no node test, as in the reference (brute force answers it)."""
    if isinstance(pred, RAY_KINDS):
        hit, _ = G.ray_box(pred.rays.origin, pred.rays.direction, lo, hi)
        return hit
    if not isinstance(pred, Intersects):
        raise TypeError(f"no overlap test for predicate {type(pred).__name__}")
    g = pred.geom
    if isinstance(g, G.Points):
        return G.intersects_box_point(lo, hi, g.coords)
    if isinstance(g, G.Boxes):
        return G.intersects_box_box(g.lo, g.hi, lo, hi)
    if isinstance(g, G.Spheres):
        return G.intersects_box_sphere(lo, hi, g.center, g.radius, fused=True)
    if isinstance(g, (G.Triangles, G.Segments, G.Tetrahedra)):
        b = G.to_boxes(g)
        return G.intersects_box_box(b.lo, b.hi, lo, hi)
    raise TypeError(f"no overlap test for {type(g).__name__}")


def node_min_distance(pred, lo, hi):
    """Lower bound of the distance from the query to box [lo, hi] (from
    the centroid of a Triangles, Segments, Tetrahedra or KDOPs query); for
    a ray predicate the ray parameter t at box entry (inf on a miss), so
    the k-nearest walk serves the first k hits."""
    if isinstance(pred, RAY_KINDS):
        _, t_enter = G.ray_box(pred.rays.origin, pred.rays.direction, lo, hi)
        return t_enter
    g = pred.geom
    if isinstance(g, G.Points):
        return G.distance_point_box(g.coords, lo, hi, fused=True)
    if isinstance(g, G.Spheres):
        return torch.clamp_min(
            G.distance_point_box(g.center, lo, hi, fused=True) - g.radius, 0.0)
    if isinstance(g, G.Boxes):
        d = torch.clamp_min(torch.maximum(lo - g.hi, g.lo - hi), 0.0)
        return G.sqrt(G.sum_sq_fused(d))
    return G.distance_point_box(G.centroid(g), lo, hi, fused=True)


def leaf_match_test(pred, values, order: str = "eager"):
    """Exact (fine) Intersects test of `pred.geom` against `values` in the
    float order `order` (``geometry.ORDERS``: sums of squares fused but in
    "eager"). Spheres over Points take the sqrt form, spheres over Boxes
    the squared form, as in the reference. A point is tested against
    triangles by its projection (``point_in_triangle``) and against
    tetrahedra exactly; a sphere against triangles and segments by
    distance; every other pair (points over segments or k-DOPs, spheres
    over tetrahedra or k-DOPs, any Triangles, Segments, Tetrahedra or
    KDOPs query) by bounding boxes, as the reference falls back."""
    if not isinstance(pred, Intersects):
        raise TypeError(f"no leaf test for {type(pred).__name__}")
    fused = order != "eager"
    g = pred.geom
    if isinstance(g, G.Points):
        p = g.coords
        if isinstance(values, G.Boxes):
            return G.intersects_box_point(values.lo, values.hi, p)
        if isinstance(values, G.Points):
            return (values.coords == p).all(dim=-1)
        if isinstance(values, G.Spheres):
            return (G.distance_point_point(p, values.center, fused)
                    <= values.radius)
        if isinstance(values, G.Triangles):
            return G.point_in_triangle(p, values.a, values.b, values.c, order)
        if isinstance(values, G.Tetrahedra):
            return G.point_in_tetrahedron(p, values.a, values.b, values.c,
                                          values.d, order)
    if isinstance(g, G.Spheres):
        c, r = g.center, g.radius
        if isinstance(values, G.Points):
            return G.distance_point_point(c, values.coords, fused) <= r
        if isinstance(values, G.Boxes):
            return G.intersects_box_sphere(values.lo, values.hi, c, r, fused)
        if isinstance(values, G.Spheres):
            return (G.distance_point_point(c, values.center, fused)
                    <= r + values.radius)
        if isinstance(values, G.Triangles):
            return G.distance_point_triangle(c, values.a, values.b, values.c,
                                             order) <= r
        if isinstance(values, G.Segments):
            return G.distance_point_segment(c, values.a, values.b, order) <= r
    vb = G.to_boxes(values)
    gb = G.to_boxes(g)
    return G.intersects_box_box(gb.lo, gb.hi, vb.lo, vb.hi)


def leaf_distance(pred, values, order: str = "eager"):
    """Fine distance from the query centroid to the leaf values (Tetrahedra
    and KDOPs: to their bounding boxes), in the float order `order`
    (``geometry.ORDERS``); for a ray predicate the hit parameter t (inf on
    a miss)."""
    if isinstance(pred, RAY_KINDS):
        _, t = leaf_ray_hit(pred, values, order)
        return t
    fused = order != "eager"
    q = G.centroid(pred.geom)
    if isinstance(values, G.Points):
        return G.distance_point_point(q, values.coords, fused)
    if isinstance(values, G.Spheres):
        return G.distance_point_sphere(q, values.center, values.radius, fused)
    if isinstance(values, G.Triangles):
        return G.distance_point_triangle(q, values.a, values.b, values.c,
                                         order)
    if isinstance(values, G.Segments):
        return G.distance_point_segment(q, values.a, values.b, order)
    vb = G.to_boxes(values)
    return G.distance_point_box(q, vb.lo, vb.hi, fused)


def leaf_ray_hit(pred, values, order: str = "eager"):
    """(hit, t) of a ray predicate against leaf values: the slab test for
    Boxes and for Points (zero-extent boxes), the quadratic for Spheres,
    Moller-Trumbore for Triangles, in the float order `order` (one of
    ``geometry.ORDERS``; triangles fuse in every order but
    "eager"). Segments, Tetrahedra and KDOPs take no ray, as in the
    reference."""
    r = pred.rays
    if isinstance(values, G.Boxes):
        return G.ray_box(r.origin, r.direction, values.lo, values.hi)
    if isinstance(values, G.Points):
        return G.ray_box(r.origin, r.direction, values.coords, values.coords)
    if isinstance(values, G.Spheres):
        return G.ray_sphere(r.origin, r.direction, values.center,
                            values.radius, order)
    if isinstance(values, G.Triangles):
        return G.ray_triangle(r.origin, r.direction, values.a, values.b,
                              values.c, fused=order != "eager")
    raise TypeError(f"ray tracing unsupported for {type(values).__name__} "
                    "(section 2.5: box, triangle, sphere)")


def leaf_test(pred, values, order: str = "eager"):
    """(match, t) of any predicate against leaf values: the ray hit and
    its parameter for ray predicates, the fine Intersects test and t = 0
    otherwise, in the float order `order`."""
    if isinstance(pred, RAY_KINDS):
        return leaf_ray_hit(pred, values, order)
    fine = leaf_match_test(pred, values, order)
    return fine, torch.zeros(fine.shape, dtype=torch.float32,
                             device=fine.device)
