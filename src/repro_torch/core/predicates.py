"""Predicates: ``intersects`` and ``nearest`` over Points, Boxes and
Spheres, with the node tests the traversal walks prune with and the fine leaf tests.

A predicate array holds Q predicates of one kind. The tests broadcast:
give the predicate geometry a (Q, 1, ...) shape and the values (N, ...)
to get a (Q, N) result, or give both A rows to test lane by lane. The
node tests run in the jitted walks of the reference, so their squared
sums take the fused order (``geometry.sum_sq_fused``); the leaf tests
take it when ``fused`` is set. Ray predicates and ``Nearest.exclude``
come in later slices.
"""
from __future__ import annotations

import dataclasses

import torch

from . import geometry as G
from .access import value_at

__all__ = ["Intersects", "Nearest", "intersects", "nearest", "attach_data",
           "lift", "take", "node_overlap_test", "node_min_distance",
           "leaf_match_test", "leaf_distance"]


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
        return dataclasses.replace(self, geom=self.geom.to(device),
                                   data=_to(self.data, device))


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


def take(pred, i):
    """Rows `i` of a predicate array, its payload included."""
    data = None if pred.data is None else value_at(pred.data, i)
    return dataclasses.replace(pred, geom=pred.geom.index(i), data=data)


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


def node_overlap_test(pred, lo, hi):
    """May the subtree under box [lo, hi] hold matches of the Intersects
    predicate `pred`?"""
    if not isinstance(pred, Intersects):
        raise TypeError(f"no overlap test for predicate {type(pred).__name__}")
    g = pred.geom
    G._check(g)
    if isinstance(g, G.Points):
        return G.intersects_box_point(lo, hi, g.coords)
    if isinstance(g, G.Boxes):
        return G.intersects_box_box(g.lo, g.hi, lo, hi)
    return G.intersects_box_sphere(lo, hi, g.center, g.radius, fused=True)


def node_min_distance(pred, lo, hi):
    """Lower bound of the distance from the query to box [lo, hi]."""
    g = pred.geom
    G._check(g)
    if isinstance(g, G.Points):
        return G.distance_point_box(g.coords, lo, hi, fused=True)
    if isinstance(g, G.Spheres):
        return torch.clamp_min(
            G.distance_point_box(g.center, lo, hi, fused=True) - g.radius, 0.0)
    d = torch.clamp_min(torch.maximum(lo - g.hi, g.lo - hi), 0.0)
    return G.sqrt(G.sum_sq_fused(d))


def leaf_match_test(pred, values, fused: bool = False):
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
        return (G.distance_point_point(g.coords, values.center, fused)
                <= values.radius)
    if isinstance(g, G.Spheres):
        if isinstance(values, G.Points):
            return (G.distance_point_point(g.center, values.coords, fused)
                    <= g.radius)
        if isinstance(values, G.Boxes):
            return G.intersects_box_sphere(values.lo, values.hi, g.center,
                                           g.radius, fused)
        return (G.distance_point_point(g.center, values.center, fused)
                <= g.radius + values.radius)
    vb = G.to_boxes(values)
    return G.intersects_box_box(g.lo, g.hi, vb.lo, vb.hi)


def leaf_distance(pred, values, fused: bool = False):
    """Fine distance from the query centroid to the leaf values."""
    q = G.centroid(pred.geom)
    G._check(values)
    if isinstance(values, G.Points):
        return G.distance_point_point(q, values.coords, fused)
    if isinstance(values, G.Boxes):
        return G.distance_point_box(q, values.lo, values.hi, fused)
    return G.distance_point_sphere(q, values.center, values.radius, fused)
