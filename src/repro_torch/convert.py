"""Carry trees, values, LM weights and serving caches between the JAX
package and this port as numpy arrays: an LBVH built by either package
can be queried by the other, the same values can be handed to both, and
an LM initialised by the reference runs in the port, from the
reference's cache too, and an LM's weights, gradients and optimizer
state go back as the reference's trees (``lm_to_numpy``,
``grads_to_numpy``, ``opt_to_numpy`` / ``opt_from_numpy``: the layers
stacked along a leading axis, bfloat16 as float32). Like every entry point of the port, they land on
the CUDA card unless the caller passes a device (``"cpu"``), and raise
without a card."""
from __future__ import annotations

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from .core import geometry as G
from .core.index import resolve_device
from .core.lbvh import FIELDS, LBVH
from .models.lm import LM

__all__ = ["lbvh_from_numpy", "lbvh_to_numpy", "geometry_from_numpy",
           "lm_from_numpy", "lm_to_numpy", "grads_to_numpy", "opt_to_numpy",
           "opt_from_numpy", "cache_from_numpy", "cache_to_numpy"]

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


#: module lists of ``LM`` whose blocks the reference stacks along a
#: leading layer axis
_STACKED = ("layers", "dense_layers", "enc_layers")


def _ref_path(name: str):
    """A parameter name's place in the reference's tree: (path, layer),
    ``layers.3.attn.wq`` -> (("layers", "attn", "wq"), 3), ``embed.table``
    -> (("embed", "table"), None)."""
    parts = name.split(".")
    if parts[0] in _STACKED:
        return (parts[0],) + tuple(parts[2:]), int(parts[1])
    return tuple(parts), None


def _leaf(model: LM, tree: dict, name: str, shape, what: str):
    """The array of `tree` that holds parameter `name` (one layer of a
    stacked leaf), its path and shape checked."""
    path, layer = _ref_path(name)
    node = tree
    for i, key in enumerate(path):
        if not isinstance(node, dict) or key not in node:
            raise KeyError(f"{what}: missing leaf {'/'.join(path[:i + 1])}")
        node = node[key]
    want = tuple(shape) if layer is None \
        else (len(getattr(model, path[0])),) + tuple(shape)
    if np.shape(node) != want:
        raise ValueError(f"{what}: {'/'.join(path)} has shape "
                         f"{np.shape(node)}, the model needs {want}")
    return node if layer is None else node[layer]


def _host(t: torch.Tensor) -> np.ndarray:
    """A copy of a tensor as a numpy array, bfloat16 as float32 (which
    holds it exactly): a snapshot, which no later in-place update of the
    tensor reaches. A DTensor is gathered whole, a collective that every
    rank of its mesh makes."""
    t = t.detach()
    if isinstance(t, DTensor):
        t = t.full_tensor()
    t = t.float() if t.dtype == torch.bfloat16 else t
    return t.to("cpu", copy=True).numpy()


def _tree(named: dict) -> dict:
    """{parameter name: tensor} as the reference's nested tree of numpy
    arrays, each stacked module list's leaves stacked in layer order."""
    tree, stacked = {}, {}
    for name, t in named.items():
        path, layer = _ref_path(name)
        if layer is None:
            stacked[path] = _host(t)
        else:
            stacked.setdefault(path, {})[layer] = _host(t)
    for path, a in stacked.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = a if isinstance(a, np.ndarray) else \
            np.stack([a[i] for i in range(len(a))])
    return tree


def lm_from_numpy(cfg, params: dict, device=None, *, mesh=None,
                  specs: dict | None = None) -> LM:
    """An ``LM`` of any family holding the reference's parameter tree,
    given as numpy arrays (``jax.tree_util.tree_map(np.asarray,
    init_params(cfg, key))``): ``embed/table``, ``final_norm/...`` and
    each family's subtrees (``dense_layers``, ``layers``, ``enc_layers``
    stacked along a leading layer axis and split here per block;
    ``enc_norm``, ``shared_attn``, ``patch_proj``, ``mtp``, the MoE and
    Mamba leaves as they are). Each leaf is copied into the parameter of
    the same path, in that parameter's dtype; a missing or mis-shaped leaf
    raises with its path. With a `mesh` and `specs` ({parameter name:
    ``launch.sharding`` spec}) each rank keeps its own shard of the full
    arrays (``launch.sharding.distribute_model``)."""
    model = LM(cfg, device)
    with torch.no_grad():
        for name, param in model.named_parameters():
            a = _leaf(model, params, name, param.shape, "lm_from_numpy")
            param.copy_(torch.from_numpy(np.array(a, dtype=np.float32)))
    if mesh is not None:
        from .launch.sharding import distribute_model
        distribute_model(model, mesh, specs)
    return model


def lm_to_numpy(model: LM) -> dict:
    """The inverse of ``lm_from_numpy``: the model's weights as the
    reference's parameter tree of numpy arrays (layers stacked, bfloat16
    as float32), a sharded model's gathered whole on every rank."""
    return _tree(dict(model.named_parameters()))


def grads_to_numpy(grads: dict) -> dict:
    """Gradients keyed by parameter name (``train.step``'s) as the
    reference's tree of numpy arrays."""
    return _tree(grads)


def opt_to_numpy(state: dict) -> dict:
    """AdamW state (``optim.adamw_init``'s: ``step`` and per-parameter
    ``m``, ``v``, and ``ef_err`` under grad compression) as the
    reference's tree: {"step": int32, "m": tree, "v": tree(, "ef_err")}."""
    out = {"step": np.asarray(_host(state["step"]), np.int32)}
    for key in ("m", "v", "ef_err"):
        if key in state:
            out[key] = _tree(state[key])
    return out


def opt_from_numpy(model: LM, tree: dict, dtype=torch.float32, *,
                   mesh=None, specs: dict | None = None) -> dict:
    """AdamW state for `model` from the reference's tree (numpy): the
    moments in `dtype` (float32, the reference's default; bfloat16 at
    DeepSeek-V3 scale), ``ef_err`` in float32, the step an int32 0-d
    tensor, all on the model's device. With a `mesh` and `specs` (the
    moments', ``launch.sharding.zero1_specs``' for ZeRO-1) each rank
    keeps its own shard of the moments; an ``ef_err`` (a pod's own
    error) does not go onto a mesh and raises."""
    dev = model.device
    named = dict(model.named_parameters())
    out = {"step": torch.tensor(int(np.asarray(tree["step"])),
                                dtype=torch.int32, device=dev)}
    if mesh is not None and "ef_err" in tree:
        raise ValueError("opt_from_numpy: an int8 error-feedback state "
                         "(ef_err) is each pod's own and is not restored "
                         "onto a mesh")
    for key in ("m", "v", "ef_err"):
        if key not in tree:
            continue
        dt = torch.float32 if key == "ef_err" else dtype
        out[key] = {name: torch.from_numpy(np.array(_leaf(
            model, tree[key], name, p.shape, f"opt_from_numpy {key}"),
            dtype=np.float32)).to(dev, dt) for name, p in named.items()}
        if mesh is not None:
            from .launch.sharding import to_dtensor
            out[key] = {n: to_dtensor(t, mesh, specs[n])
                        for n, t in out[key].items()}
    return out


def cache_from_numpy(cache: dict, device=None) -> dict:
    """A serving cache (``models.serve``) from the reference's, given as
    numpy arrays (``jax.tree_util.tree_map(np.asarray, cache)``), e.g.
    taken mid-sequence: each leaf in its own dtype (bfloat16 arrays, which
    numpy holds as ``ml_dtypes.bfloat16``, as torch.bfloat16), ``index`` a
    0-d int32 tensor."""
    device = resolve_device(device)
    out = {}
    for name, a in cache.items():
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a, order="C"))
        out[name] = t.to(torch.int32 if name == "index" else t.dtype).to(
            device)
    return out


def cache_to_numpy(cache: dict) -> dict:
    """The cache's leaves as numpy arrays (bfloat16 leaves as float32,
    which holds them exactly)."""
    return {name: _host(t) for name, t in cache.items()}
