"""Carry trees and values between the JAX package and this port as numpy
arrays: an LBVH built by either package can be queried by the other,
and the same values can be handed to both. Like every entry point of the
port, they land on the CUDA card unless the caller passes a device
(``"cpu"``), and raise without a card."""
from __future__ import annotations

import numpy as np
import torch

from .core import geometry as G
from .core.index import resolve_device
from .core.lbvh import FIELDS, LBVH

__all__ = ["lbvh_from_numpy", "lbvh_to_numpy", "geometry_from_numpy"]

_FLOAT_FIELDS = ("node_lo", "node_hi")

#: geometry kind -> (class, field names)
_KINDS = {
    "points": (G.Points, ("coords",)),
    "boxes": (G.Boxes, ("lo", "hi")),
    "spheres": (G.Spheres, ("center", "radius")),
    "triangles": (G.Triangles, ("a", "b", "c")),
    "rays": (G.Rays, ("origin", "direction")),
}


def _tensor(a, dtype, device):
    return torch.from_numpy(np.array(a, dtype=dtype, order="C")).to(device)


def lbvh_from_numpy(fields: dict, device=None) -> LBVH:
    """LBVH from a dict of the 8 field arrays (float32 boxes, int32
    indices), e.g. ``{f: np.asarray(getattr(jax_tree, f)) for f in FIELDS}``."""
    missing = [f for f in FIELDS if f not in fields]
    if missing:
        raise KeyError(f"lbvh_from_numpy: missing fields {missing}")
    device = resolve_device(device)
    return LBVH(*(_tensor(fields[f], np.float32 if f in _FLOAT_FIELDS
                          else np.int32, device) for f in FIELDS))


def lbvh_to_numpy(tree: LBVH) -> dict:
    """The 8 LBVH fields as numpy arrays."""
    return {f: getattr(tree, f).detach().cpu().numpy() for f in FIELDS}


def geometry_from_numpy(kind: str, arrays, device=None):
    """Points / Boxes / Spheres / Triangles / Rays from numpy arrays:
    `arrays` is a dict of the field names or a sequence in field order
    (coords; lo, hi; center, radius; a, b, c; origin, direction)."""
    try:
        cls, names = _KINDS[kind.lower()]
    except KeyError:
        raise NotImplementedError(
            f"geometry kind {kind!r} is not ported (have {sorted(_KINDS)})"
        ) from None
    if isinstance(arrays, dict):
        arrays = [arrays[f] for f in names]
    if len(arrays) != len(names):
        raise ValueError(f"{kind} takes {len(names)} arrays {names}, "
                         f"got {len(arrays)}")
    device = resolve_device(device)
    return cls(*(_tensor(a, np.float32, device) for a in arrays))
