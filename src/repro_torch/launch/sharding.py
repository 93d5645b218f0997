"""Sharding rules: logical axes -> mesh axes, parameter specs, ZeRO-1
optimizer-state specs, batch and cache specs: the port of
``repro.launch.sharding``, on ``torch.distributed`` device meshes and
DTensor placements.

Megatron-style tensor parallelism over the "model" axis (column then row
parallel), data parallelism over ("pod", "data"). A dimension is sharded
only when the axis size divides it: chatglm3's 2 kv heads replicate on a
16-wide model axis while its 32 q heads shard.

A spec is a ``PartitionSpec``: a tuple with one entry per tensor dim (a
mesh axis name, a tuple of names, or None), the reference's
``jax.sharding.PartitionSpec``. The spec functions read only the mesh's
axis names and sizes (a ``DeviceMesh`` or a ``mesh.AbstractMesh``), as
the reference's do. ``named(mesh, spec)`` alone turns a spec into DTensor
placements, one per mesh dim: ``Shard(d)`` or ``Replicate()``. A dim
sharded over ("pod", "data") lays its shards out pod-major, as JAX does.

The port keeps one module per layer where the reference stacks the
layers along a leading axis, which its rules never shard; so a layer
parameter's spec here is the reference's without that leading None,
keyed by the port's parameter name (``convert`` maps the names). Leaves
whose ZeRO-1 dim is that layer axis in the reference are the one
departure; ``zero1_specs`` documents it.
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from ..models.config import ModelConfig
from .mesh import mesh_shape

__all__ = ["PartitionSpec", "P", "logical_rules", "param_spec", "param_specs",
           "zero1_specs", "opt_state_specs", "batch_spec", "cache_specs",
           "named", "to_dtensor", "sharded_zeros",
           "distribute_model", "distribute_tree"]

# parameter name -> how it shards over "model": column-parallel (the last
# dim) or row-parallel (the first dim of the base rank)
_COL = {"wq", "wk", "wv", "wg", "wu", "w_uq", "w_uk", "w_uv",
        "wz", "wx", "wdt", "patch_proj", "proj"}
_ROW = {"wo", "wd", "out_proj"}
_EXPERT = {"wg", "wu", "wd"}          # when ndim == 3 (E, ., .)
_VOCAB = {"table"}
_CONV = {"conv_wx"}                   # (K, di): shard the channel axis

# base ranks of the leaves that are not (d_in, d_out) matrices
_BASE = {"table": 2, "scale": 1, "bias": 1, "a_log": 1, "dt_bias": 1,
         "d_skip": 1, "norm_scale": 1, "conv_b": 1, "router": 2,
         "conv_wx": 2, "conv_wb": 2, "conv_wc": 2}


class PartitionSpec(tuple):
    """One entry per tensor dim: a mesh axis name, a tuple of names, or
    None (replicated); fewer entries than dims leave the rest replicated.
    A tuple of one name is that name, as JAX normalises it."""

    def __new__(cls, *entries):
        return super().__new__(cls, (e[0] if isinstance(e, tuple)
                                     and len(e) == 1 else e
                                     for e in entries))

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def _div(n, size):
    return n % size == 0


def _names(name: str) -> list:
    """A parameter name's path without its layer indices."""
    return [p for p in name.split(".") if not p.isdigit()]


def _dp_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def logical_rules(mesh) -> dict:
    """Rules for activation constraints (``models.layers.shard``)."""
    dp = tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))
    dp = dp if len(dp) > 1 else (dp[0] if dp else None)
    return {"batch": dp, "heads": "model", "kv_heads": None,
            "ffn": "model", "experts": "model", "vocab": "model"}


def param_spec(path_names, shape, mesh, *, expert_2d: bool = False) -> P:
    """The spec of one parameter from its path (names, the last the
    leaf's) and shape.

    expert_2d: shard MoE expert weights over both mesh axes, the experts
    on "model" and the ffn dim on "data", so that no expert weight is
    gathered for compute."""
    sizes = mesh_shape(mesh)
    msize, dsize = sizes["model"], sizes["data"]
    name = path_names[-1]
    shape = tuple(shape)
    nd = len(shape)
    if name in _EXPERT and nd >= 3 and len(path_names) > 1 \
            and path_names[-2] == "moe":
        base_rank = 3
    else:
        base_rank = _BASE.get(name, 2)
    lead = nd - base_rank
    spec = [None] * nd

    def set_if(axis_from_end, dim_size):
        if _div(dim_size, msize):
            spec[nd - axis_from_end] = "model"

    if name in _VOCAB:
        set_if(2, shape[lead])                         # vocab rows
    elif name in _EXPERT and base_rank == 3:
        if _div(shape[lead], msize):
            set_if(3, shape[lead])                     # expert-parallel
            if expert_2d:
                if name in ("wg", "wu") and _div(shape[-1], dsize):
                    spec[nd - 1] = "data"              # (E, d, m): m/data
                elif name == "wd" and _div(shape[-2], dsize):
                    spec[nd - 2] = "data"              # (E, m, d): m/data
        elif name in ("wg", "wu"):
            set_if(1, shape[-1])                       # few experts: TP
        else:                                          # wd: (E, m, d)
            set_if(2, shape[-2])
    elif name in _CONV:
        set_if(1, shape[-1])
    elif name in _ROW:
        set_if(2, shape[-2])
    elif name in _COL:
        set_if(1, shape[-1])
    return P(*spec)


def _named_params(params) -> dict:
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def param_specs(params, mesh, *, expert_2d: bool = False) -> dict:
    """{parameter name: spec} for a module or {name: tensor} (meta
    tensors too)."""
    return {n: param_spec(_names(n), p.shape, mesh, expert_2d=expert_2d)
            for n, p in _named_params(params).items()}


_STACKED = ("layers", "dense_layers", "enc_layers")


def _stack_depths(names) -> dict:
    """{parameter name: layers} for the leaves of a module list, which the
    reference stacks along a leading axis of that many layers."""
    count = {}
    for n in names:
        parts = n.split(".")
        if parts[0] in _STACKED:
            key = (parts[0],) + tuple(parts[2:])
            count[key] = count.get(key, 0) + 1
    return {n: count[(n.split(".")[0],) + tuple(n.split(".")[2:])]
            for n in names if n.split(".")[0] in _STACKED}


def zero1_specs(pspecs: dict, params, mesh) -> dict:
    """Optimizer-moment (and FSDP) specs: the parameter's spec with its
    largest still-unsharded dim that the data-parallel axes divide
    sharded over all of them (ZeRO-1; ("pod", "data") on the multi-pod
    mesh). A spec already sharded over a data-parallel axis is kept.

    The choice is made on the reference's shapes: a module list's leaf
    with its leading layer axis. Where that axis wins (it comes first, so
    it wins a tie: Mamba2-780m's 48 layers of 48 heads), the reference
    spreads the layers over the data ranks, which one module a layer
    cannot; the port's spec is the reference's without that entry, and
    those moments replicate over the data axes."""
    named = _named_params(params)
    depth = _stack_depths(named)
    dp = _dp_axes(mesh)
    sizes = mesh_shape(mesh)
    dsize = math.prod(sizes[a] for a in dp)
    dp_entry = dp if len(dp) > 1 else dp[0]

    def one(spec, shape):
        dims = list(spec) + [None] * (len(shape) - len(spec))
        for d in dims:
            existing = d if isinstance(d, tuple) else (d,)
            if any(a in existing for a in dp):
                return dims
        best, best_size = None, 0
        for i, (s, n) in enumerate(zip(dims, shape)):
            if s is None and _div(n, dsize) and n > best_size:
                best, best_size = i, n
        if best is not None:
            dims[best] = dp_entry
        return dims

    out = {}
    for n in pspecs:
        shape = tuple(named[n].shape)
        if n in depth:
            out[n] = P(*one((None,) + tuple(pspecs[n]),
                            (depth[n],) + shape)[1:])
        else:
            out[n] = P(*one(pspecs[n], shape))
    return out


def opt_state_specs(pspecs: dict, params, mesh, *, zero1=True) -> dict:
    m = zero1_specs(pspecs, params, mesh) if zero1 else pspecs
    return {"step": P(), "m": m, "v": dict(m)}


def batch_spec(mesh, batch_size: int) -> P:
    dp = [a for a in ("pod", "data") if a in mesh.mesh_dim_names]
    sizes = mesh_shape(mesh)
    total = math.prod(sizes[a] for a in dp)
    if _div(batch_size, total):
        return P(tuple(dp))
    return P()                                         # tiny batch: replicate


def cache_specs(cfg: ModelConfig, cache: dict, mesh, batch_size: int) -> dict:
    """Specs of a decode cache ({leaf name: tensor}, ``models.serve``'s):
    the batch over the data-parallel axes when they divide it, the heads
    over "model" when it divides them; for batch-1 long-context cells the
    cache's length axis shards over the data axes instead (sequence-
    parallel decode)."""
    bspec = batch_spec(mesh, batch_size)
    dp = bspec[0] if len(bspec) else None
    sizes = mesh_shape(mesh)
    msize = sizes["model"]
    dp_total = math.prod(sizes[a] for a in ("pod", "data") if a in sizes)

    def one(name, shape):
        nd = len(shape)
        if name == "index":
            return P()
        spec = [None] * nd
        # layouts (leading L = the layers):
        #   k / v / attn_k / attn_v: (L, B, H, W, dh)
        #   ckv / kr:                (L, B, W, r)
        #   conv: (L, B, K - 1, C)   state: (L, B, H, P, N)
        #   cross_k / cross_v:       (L, B, H, Se, dh)
        bdim = 1 if nd >= 2 else None
        if bdim is not None and dp is not None and _div(shape[bdim], dp_total):
            spec[bdim] = dp
        if name in ("k", "v", "attn_k", "attn_v", "cross_k", "cross_v"):
            if _div(shape[2], msize):
                spec[2] = "model"
            elif _div(shape[3], msize):
                # few kv heads (starcoder2's 4, chatglm3's 2): the cache's
                # length shards over "model" instead
                spec[3] = "model"
            if spec[bdim] is None and dp is not None \
                    and spec[3] is None and _div(shape[3], dp_total):
                spec[3] = dp                           # sequence-parallel
        elif name in ("ckv", "kr"):
            # the MLA latent is shared by the heads: its rank shards
            if _div(shape[3], msize):
                spec[3] = "model"
            if spec[bdim] is None and dp is not None \
                    and _div(shape[2], dp_total):
                spec[2] = dp
        elif name == "state":
            if _div(shape[2], msize):
                spec[2] = "model"
        elif name == "conv":
            if _div(shape[3], msize):
                spec[3] = "model"
        return P(*spec)

    return {n: one(n, tuple(t.shape)) for n, t in cache.items()}


# ---------------------------------------------------------------------------
# specs -> DTensor placements
# ---------------------------------------------------------------------------

def named(mesh, spec):
    """The DTensor placements of `spec` on `mesh`, one per mesh dim:
    ``Shard(d)`` where entry d names the mesh dim's axis, else
    ``Replicate()`` (of every spec of a nested dict, a dict). A dim
    sharded over several axes must list them in the mesh's order (major
    first), which is the reference's layout."""
    if isinstance(spec, dict):
        return {k: named(mesh, v) for k, v in spec.items()}
    names = mesh.mesh_dim_names
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        where = [names.index(a) for a in axes]
        if where != sorted(where):
            raise ValueError(f"spec {spec}: dim {d} lists {axes} out of the "
                             f"mesh's order {names}")
        for i in where:
            out[i] = Shard(d)
    return tuple(out)


def to_dtensor(t: torch.Tensor, mesh, spec) -> DTensor:
    """`t`, the full array on every rank, as a DTensor at `spec`'s
    placements: each rank keeps its own shard, with no communication."""
    if isinstance(t, DTensor):
        return t.redistribute(mesh, named(mesh, spec))
    return distribute_tensor(t, mesh, named(mesh, spec),
                             src_data_rank=None)


def sharded_zeros(shape, dtype, mesh, spec, device) -> DTensor:
    """A zero DTensor of global `shape` at `spec`, each rank allocating its
    own shard alone on `device` (``"meta"`` allocates nothing)."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    pl = named(mesh, spec)
    local, _ = compute_local_shape_and_global_offset(tuple(shape), mesh, pl)
    return DTensor.from_local(torch.zeros(local, dtype=dtype, device=device),
                              mesh, pl, run_check=False, shape=tuple(shape),
                              stride=torch.empty(shape, device="meta").stride())


def distribute_tree(tree: dict, mesh, specs: dict) -> dict:
    """{name: tensor} as {name: DTensor} at `specs` (a nested dict of the
    same keys)."""
    return {k: distribute_tree(v, mesh, specs[k]) if isinstance(v, dict)
            else to_dtensor(v, mesh, specs[k]) for k, v in tree.items()}


def distribute_model(model: nn.Module, mesh, specs: dict) -> nn.Module:
    """Replace each parameter of `model` (the full weights on every rank)
    by a DTensor parameter at its spec's placements, in place; returns
    the model."""
    for name, p in list(model.named_parameters()):
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name) if mod_name else model
        setattr(mod, leaf, nn.Parameter(to_dtensor(p.detach(), mesh,
                                                   specs[name]),
                                        requires_grad=p.requires_grad))
    return model
