"""IndexableGetter: extract the bounding volume (an AABB) from stored
values (ArborX::AccessTraits, API v2 constructor contract)."""
from __future__ import annotations

import torch

from . import geometry as G


def as_geometry(obj):
    """Adapt `obj` into a geometry array: geometry arrays pass through, a
    (N, dim) tensor becomes Points, a (dim,) tensor a single point."""
    if isinstance(obj, G.GEOMETRIES):
        return obj
    arr = torch.as_tensor(obj)
    if arr.ndim == 2:
        return G.Points(arr)
    if arr.ndim == 1:
        return G.Points(arr[None, :])
    raise TypeError(f"cannot adapt {type(obj).__name__} to a geometry array")


def default_indexable_getter(values):
    """IndexableGetter: values -> AABBs used as bounding volumes."""
    return G.to_boxes(as_geometry(values))
