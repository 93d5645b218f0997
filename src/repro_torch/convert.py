"""Carry trees, values and LM weights between the JAX package and this
port as numpy arrays: an LBVH built by either package can be queried by
the other, the same values can be handed to both, and an LM initialised
by the reference runs in the port. Like every entry point of the
port, they land on the CUDA card unless the caller passes a device
(``"cpu"``), and raise without a card."""
from __future__ import annotations

import numpy as np
import torch

from .core import geometry as G
from .core.index import resolve_device
from .core.lbvh import FIELDS, LBVH
from .models.lm import LM

__all__ = ["lbvh_from_numpy", "lbvh_to_numpy", "geometry_from_numpy",
           "lm_from_numpy"]

_FLOAT_FIELDS = ("node_lo", "node_hi")

#: geometry kind -> (class, field names)
_KINDS = {
    "points": (G.Points, ("coords",)),
    "boxes": (G.Boxes, ("lo", "hi")),
    "spheres": (G.Spheres, ("center", "radius")),
    "triangles": (G.Triangles, ("a", "b", "c")),
    "segments": (G.Segments, ("a", "b")),
    "tetrahedra": (G.Tetrahedra, ("a", "b", "c", "d")),
    "kdops": (G.KDOPs, ("lo", "hi", "directions")),
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
    """Points / Boxes / Spheres / Triangles / Segments / Tetrahedra /
    KDOPs / Rays from numpy arrays: `arrays` is a dict of the field names
    or a sequence in field order (coords; lo, hi; center, radius; a, b, c;
    a, b; a, b, c, d; lo, hi, directions; origin, direction)."""
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


def lm_from_numpy(cfg, params: dict, device=None) -> LM:
    """An ``LM`` holding the reference's parameter tree, given as numpy
    arrays (``jax.tree_util.tree_map(np.asarray, init_params(cfg, key))``):
    ``embed/table``, ``final_norm/...`` and the ``layers`` subtree stacked
    along a leading layer axis, split here per block. Each leaf is copied
    into the parameter of the same path, in that parameter's dtype; a
    missing or mis-shaped leaf raises with its path."""
    model = LM(cfg, device)
    with torch.no_grad():
        for name, param in model.named_parameters():
            parts = name.split(".")
            layer = None
            if parts[0] == "layers":
                layer, parts = int(parts[1]), ["layers"] + parts[2:]
            node = params
            for i, key in enumerate(parts):
                if not isinstance(node, dict) or key not in node:
                    raise KeyError(f"lm_from_numpy: missing leaf "
                                   f"{'/'.join(parts[:i + 1])}")
                node = node[key]
            want = tuple(param.shape) if layer is None \
                else (cfg.n_layers,) + tuple(param.shape)
            if np.shape(node) != want:
                raise ValueError(f"lm_from_numpy: {'/'.join(parts)} has shape "
                                 f"{np.shape(node)}, the model needs {want}")
            a = node if layer is None else node[layer]
            param.copy_(torch.from_numpy(np.array(a, dtype=np.float32)))
    return model
