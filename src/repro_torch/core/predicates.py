"""Predicates: ``intersects`` and ``nearest`` over Points, Boxes and
Spheres, with the fine leaf tests that brute force evaluates.

A predicate array holds Q predicates of one kind. The leaf tests
broadcast: give the predicate geometry a (Q, 1, ...) shape and the values
(N, ...) to get a (Q, N) result. Ray predicates and ``Nearest.exclude``
come in later slices.
"""
from __future__ import annotations

import dataclasses

from . import geometry as G

__all__ = ["Intersects", "Nearest", "intersects", "nearest",
           "lift", "leaf_match_test", "leaf_distance"]


@dataclasses.dataclass(frozen=True)
class Intersects:
    """Spatial predicate: match values whose geometry intersects `geom`."""
    geom: object
    data: object = None

    def __len__(self):
        return len(self.geom)

    def to(self, device) -> "Intersects":
        return dataclasses.replace(self, geom=self.geom.to(device))


@dataclasses.dataclass(frozen=True)
class Nearest:
    """k-nearest predicate over the centroids of `geom`."""
    geom: object
    k: int = 1
    data: object = None
    exclude: object = None

    def __post_init__(self):
        if self.exclude is not None:
            raise NotImplementedError(
                "Nearest.exclude (the EMST component filter) is not ported "
                "yet: it comes with the algorithms slice")

    def __len__(self):
        return len(self.geom)

    def to(self, device) -> "Nearest":
        return dataclasses.replace(self, geom=self.geom.to(device))


def intersects(geom, data=None) -> Intersects:
    """ArborX::intersects; ``intersects(Spheres(c, r))`` is the API-v2
    spelling of ``within(c, r)``."""
    return Intersects(geom, data)


def nearest(geom, k: int = 1, data=None, exclude=None) -> Nearest:
    return Nearest(geom, k, data, exclude)


def lift(pred):
    """The predicate with its geometry given a (Q, 1, ...) shape, so the
    leaf tests broadcast against (N, ...) values into (Q, N)."""
    g = pred.geom
    G._check(g)
    if isinstance(g, G.Points):
        g = G.Points(g.coords[:, None, :])
    elif isinstance(g, G.Boxes):
        g = G.Boxes(g.lo[:, None, :], g.hi[:, None, :])
    else:
        g = G.Spheres(g.center[:, None, :], g.radius[:, None])
    return dataclasses.replace(pred, geom=g)


def leaf_match_test(pred, values):
    """Exact (fine) Intersects test of `pred.geom` against `values`.
    Spheres over Points take the sqrt form, spheres over Boxes the
    squared form, as in the reference."""
    if not isinstance(pred, Intersects):
        raise TypeError(f"no leaf test for {type(pred).__name__}")
    g = pred.geom
    G._check(g)
    G._check(values)
    if isinstance(g, G.Points):
        if isinstance(values, G.Boxes):
            return G.intersects_box_point(values.lo, values.hi, g.coords)
        if isinstance(values, G.Points):
            return (values.coords == g.coords).all(dim=-1)
        return G.distance_point_point(g.coords, values.center) <= values.radius
    if isinstance(g, G.Spheres):
        if isinstance(values, G.Points):
            return G.distance_point_point(g.center, values.coords) <= g.radius
        if isinstance(values, G.Boxes):
            return G.intersects_box_sphere(values.lo, values.hi, g.center,
                                           g.radius)
        return (G.distance_point_point(g.center, values.center)
                <= g.radius + values.radius)
    vb = G.to_boxes(values)
    return G.intersects_box_box(g.lo, g.hi, vb.lo, vb.hi)


def leaf_distance(pred, values):
    """Fine distance from the query centroid to the leaf values."""
    q = G.centroid(pred.geom)
    G._check(values)
    if isinstance(values, G.Points):
        return G.distance_point_point(q, values.coords)
    if isinstance(values, G.Boxes):
        return G.distance_point_box(q, values.lo, values.hi)
    return G.distance_point_sphere(q, values.center, values.radius)
