"""AdamW with global-norm clipping and a warmup + cosine schedule: the
port of ``repro.optim.adamw``, over tensors keyed by parameter name
(``dict(model.named_parameters())``), updated in place. No
``torch.optim``.

The arithmetic is the reference's: the gradients clipped to a global
norm and rounded back to their dtype, the moments updated in float32
(stored in their own dtype: float32 by default, bfloat16 at DeepSeek-V3
scale), bias correction ``1 - b ** step`` in float32, the update made in
float32 and rounded to the parameter's dtype. The step counter and the
learning rate are device tensors, so an update makes no host sync. The
leaves go through ``torch._foreach_*`` ops in chunks of at most
``CHUNK_ELEMS`` elements: a few dozen launches a chunk whatever the
number of leaves, and float32 temporaries of one chunk at a time.
"""
from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate

__all__ = ["adamw_init", "adamw_update", "cosine_schedule",
           "clip_by_global_norm", "leaf_order"]

#: elements of one chunk of leaves updated together (512 MiB of float32)
CHUNK_ELEMS = 1 << 27


def _named(params) -> dict:
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def leaf_order(name: str):
    """The sort key that puts parameter names in the reference's leaf
    order (``jax.tree_util.tree_leaves``: dict keys sorted at every
    level, a stacked module list's layers consecutive): the name's path
    without its layer index, then the index (as (length, digits): the
    numeric order)."""
    parts = name.split(".")
    return (tuple(p for p in parts if not p.isdigit()),
            [(len(p), p) for p in parts if p.isdigit()])


def adamw_init(params, dtype=torch.float32, *, mesh=None,
               specs: dict | None = None) -> dict:
    """{"step": int32 0-d, "m": {name: zeros}, "v": {name: zeros}} on the
    parameters' device. `params`: a module or {name: tensor}; `dtype` the
    moments' (float32 by default; bfloat16 halves their memory, as
    DeepSeek-V3 trains). With a `mesh` and `specs` ({name:
    ``launch.sharding`` spec}, ``zero1_specs``' for ZeRO-1) the moments
    are DTensors at those specs: each rank holds its shard alone."""
    named = _named(params)
    dev = _local(next(iter(named.values()))).device
    if mesh is None:
        zeros = {k: {n: torch.zeros(p.shape, dtype=dtype, device=p.device)
                     for n, p in named.items()} for k in ("m", "v")}
    else:
        from ..launch.sharding import sharded_zeros
        zeros = {k: {n: sharded_zeros(p.shape, dtype, mesh, specs[n], dev)
                     for n, p in named.items()} for k in ("m", "v")}
    return {"step": torch.zeros((), dtype=torch.int32, device=dev), **zeros}


def _local(t):
    """The tensor a rank holds of `t` (itself when it is not a DTensor)."""
    return t.to_local() if isinstance(t, DTensor) else t


def cosine_schedule(base_lr: float, warmup: int, total: int):
    """lr(step): linear warmup to base_lr over `warmup` steps, then a
    cosine to 0 at `total`; float32 on the step's device."""
    def lr(step):
        step = step.float()
        warm = base_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = 0.5 * base_lr * (1.0 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, cos)
    return lr


def _chunks(names, named):
    """`names` in runs of at most CHUNK_ELEMS elements."""
    run, size = [], 0
    for n in names:
        if run and size + named[n].numel() > CHUNK_ELEMS:
            yield run
            run, size = [], 0
        run.append(n)
        size += named[n].numel()
    if run:
        yield run


def _sum_squares(tensors):
    """Float32 sums of squares of `tensors`, one 0-d tensor each, by
    ``sum`` (pairwise on the CPU, a tree on the card): the CPU's
    ``vector_norm`` / ``_foreach_norm`` accumulate in float32 one element
    after another (``tests/test_torch_optim.py`` measures both)."""
    out = []
    for run in _chunks(range(len(tensors)), tensors):
        tf = [tensors[i].float() for i in run]
        out += [sq.sum() for sq in torch._foreach_mul(tf, tf)]
    return out


def clip_by_global_norm(grads: dict, max_norm: float):
    """(grads scaled by min(1, max_norm / norm), each rounded back to its
    dtype; the global norm, a float32 0-d tensor). The leaves' squares
    are summed in the reference's leaf order (``leaf_order``)."""
    names = sorted(grads, key=leaf_order)
    return _clip(grads, _sum_squares([grads[n] for n in names]), max_norm)


def _clip(grads: dict, squares: list, max_norm: float):
    """`grads` scaled by min(1, max_norm / the norm of the leaves' sums of
    `squares` (in leaf order)), and that norm."""
    names = sorted(grads, key=leaf_order)
    gn = torch.sqrt(torch.stack(squares).sum())
    scale = torch.clamp_max(max_norm / torch.clamp_min(gn, 1e-9), 1.0)
    out = {}
    for run in _chunks(names, grads):
        scaled = torch._foreach_mul([grads[n].float() for n in run], scale)
        out.update((n, s.to(grads[n].dtype)) for n, s in zip(run, scaled))
    return out, gn


def _sharded_sum_squares(grads: dict, names) -> list:
    """Float32 sums of squares of DTensor `grads`, one replicated 0-d
    tensor a leaf: each rank sums its own shard as ``_sum_squares`` does,
    and the shards' sums add over the mesh dims that shard the leaf
    (one all-reduce for all the leaves of one placement). At one rank
    the sums are ``_sum_squares``' bit for bit."""
    local = dict(zip(names, _sum_squares([grads[n].to_local()
                                          for n in names])))
    out = {}
    for pl in {grads[n].placements for n in names}:
        run = [n for n in names if grads[n].placements == pl]
        mesh = grads[run[0]].device_mesh
        part = [Partial() if p.is_shard() else Replicate() for p in pl]
        tot = DTensor.from_local(torch.stack([local[n] for n in run]), mesh,
                                 part, run_check=False).full_tensor()
        out.update(zip(run, tot.unbind()))
    return [out[n] for n in names]


@torch.no_grad()
def adamw_update(params, grads: dict, state: dict, lr_fn, *, b1=0.9, b2=0.95,
                 eps=1e-8, weight_decay=0.1, max_norm=1.0) -> dict:
    """One AdamW step: clip `grads` ({name: tensor}) to `max_norm`, then
    update ``state`` ("step", "m", "v") and the parameters (`params`, a
    module or {name: tensor}) in place. Returns {"grad_norm", "lr"}, 0-d
    device tensors.

    DTensor parameters (ZeRO-1, moments from ``adamw_init(mesh=...)``):
    each gradient is redistributed to its moments' placements (a reduce-
    scatter of the data-parallel partial sums), the global norm adds the
    shards' sums of squares over the mesh (another float order than one
    device's, within float32 rounding of it), each rank updates its
    shard with the same arithmetic, and the new shard is all-gathered to
    the parameter's placements."""
    named = _named(params)
    if any(isinstance(p, DTensor) for p in named.values()):
        return _sharded_update(named, grads, state, lr_fn, b1, b2, eps,
                               weight_decay, max_norm)
    grads, gnorm = clip_by_global_norm(grads, max_norm)
    step, lr, bc1, bc2 = _schedule(state, lr_fn, b1, b2)
    names = sorted(named, key=leaf_order)
    for run in _chunks(names, named):
        p = [named[n] for n in run]
        new_p = _adamw_chunk(p, [grads[n] for n in run],
                             [state["m"][n] for n in run],
                             [state["v"][n] for n in run], lr, bc1, bc2,
                             b1, b2, eps, weight_decay)
        torch._foreach_copy_(p, new_p)
    state["step"] = step
    return {"grad_norm": gnorm, "lr": lr}


def _schedule(state, lr_fn, b1, b2):
    step = state["step"] + 1
    stepf = step.float()
    return step, lr_fn(step), 1.0 - torch.pow(b1, stepf), \
        1.0 - torch.pow(b2, stepf)


def _adamw_chunk(p, g, m, v, lr, bc1, bc2, b1, b2, eps, weight_decay):
    """The AdamW arithmetic of one chunk of leaves: the moments `m`, `v`
    updated in place, the new parameters (float32) returned."""
    gf = [x.float() for x in g]
    # float32 moments are updated in place (x.float() is x itself)
    mf = [x.float() for x in m]
    vf = [x.float() for x in v]
    torch._foreach_mul_(mf, b1)
    torch._foreach_add_(mf, gf, alpha=1 - b1)
    torch._foreach_mul_(vf, b2)
    torch._foreach_addcmul_(vf, gf, gf, value=1 - b2)
    del gf
    denom = torch._foreach_sqrt(torch._foreach_div(vf, bc2))
    torch._foreach_add_(denom, eps)
    delta = torch._foreach_div(torch._foreach_div(mf, bc1), denom)
    del denom
    pf = [x.float() for x in p]
    torch._foreach_add_(delta, pf, alpha=weight_decay)
    torch._foreach_mul_(delta, lr)
    new_p = torch._foreach_sub(pf, delta)
    del delta, pf
    for dst, src in ((m, mf), (v, vf)):
        if dst[0].dtype != torch.float32:
            torch._foreach_copy_(dst, src)
    return new_p


def _sharded_update(named, grads, state, lr_fn, b1, b2, eps, weight_decay,
                    max_norm):
    """``adamw_update`` of DTensor parameters, ZeRO-1: every rank takes
    part in every collective, in the leaves' order."""
    names = sorted(named, key=leaf_order)
    placed = {n: grads[n].redistribute(state["m"][n].device_mesh,
                                       state["m"][n].placements)
              for n in names}
    local_g, gnorm = _clip({n: g.to_local() for n, g in placed.items()},
                           _sharded_sum_squares(placed, names), max_norm)
    step, lr, bc1, bc2 = _schedule(state, lr_fn, b1, b2)
    sizes = {n: state["m"][n].to_local() for n in names}
    for run in _chunks(names, sizes):
        m = [state["m"][n] for n in run]
        shards = [named[n].redistribute(x.device_mesh, x.placements)
                  for n, x in zip(run, m)]
        new_p = _adamw_chunk([s.to_local() for s in shards],
                             [local_g[n] for n in run],
                             [x.to_local() for x in m],
                             [state["v"][n].to_local() for n in run],
                             lr, bc1, bc2, b1, b2, eps, weight_decay)
        for n, x, s, new in zip(run, m, shards, new_p):
            p = named[n]
            whole = DTensor.from_local(new.to(p.dtype), x.device_mesh,
                                       x.placements, run_check=False,
                                       shape=p.shape, stride=p.stride())
            p.to_local().copy_(whole.redistribute(
                p.device_mesh, p.placements).to_local())
    state["step"] = step
    return {"grad_norm": gnorm, "lr": lr}
