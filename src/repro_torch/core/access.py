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


def value_at(values, i):
    """Element(s) i of a values container: a geometry array, a tensor, or
    a dict / tuple / list of them."""
    if isinstance(values, G.GEOMETRIES):
        return values.index(i)
    if isinstance(values, torch.Tensor):
        return values[i]
    if isinstance(values, dict):
        return {k: value_at(v, i) for k, v in values.items()}
    if isinstance(values, (tuple, list)):
        return type(values)(value_at(v, i) for v in values)
    raise TypeError(f"cannot index values of type {type(values).__name__}")
