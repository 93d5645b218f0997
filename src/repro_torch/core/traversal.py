"""Helpers over values containers. The general while-loop traversal, the
callbacks and ``tree_select`` of ``repro.core.traversal`` come with a
later slice."""
from __future__ import annotations

import torch

from . import geometry as G

__all__ = ["value_at"]


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

