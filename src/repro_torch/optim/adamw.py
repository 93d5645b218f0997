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


def adamw_init(params, dtype=torch.float32) -> dict:
    """{"step": int32 0-d, "m": {name: zeros}, "v": {name: zeros}} on the
    parameters' device. `params`: a module or {name: tensor}; `dtype` the
    moments' (float32 by default; bfloat16 halves their memory, as
    DeepSeek-V3 trains)."""
    named = _named(params)
    dev = next(iter(named.values())).device
    zeros = {k: {n: torch.zeros(p.shape, dtype=dtype, device=p.device)
                 for n, p in named.items()} for k in ("m", "v")}
    return {"step": torch.zeros((), dtype=torch.int32, device=dev), **zeros}


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
    sq = _sum_squares([grads[n] for n in names])
    gn = torch.sqrt(torch.stack(sq).sum())
    scale = torch.clamp_max(max_norm / torch.clamp_min(gn, 1e-9), 1.0)
    out = {}
    for run in _chunks(names, grads):
        scaled = torch._foreach_mul([grads[n].float() for n in run], scale)
        out.update((n, s.to(grads[n].dtype)) for n, s in zip(run, scaled))
    return out, gn


@torch.no_grad()
def adamw_update(params, grads: dict, state: dict, lr_fn, *, b1=0.9, b2=0.95,
                 eps=1e-8, weight_decay=0.1, max_norm=1.0) -> dict:
    """One AdamW step: clip `grads` ({name: tensor}) to `max_norm`, then
    update ``state`` ("step", "m", "v") and the parameters (`params`, a
    module or {name: tensor}) in place. Returns {"grad_norm", "lr"}, 0-d
    device tensors."""
    named = _named(params)
    grads, gnorm = clip_by_global_norm(grads, max_norm)
    step = state["step"] + 1
    lr = lr_fn(step)
    stepf = step.float()
    bc1 = 1.0 - torch.pow(b1, stepf)
    bc2 = 1.0 - torch.pow(b2, stepf)
    names = sorted(named, key=leaf_order)
    for run in _chunks(names, named):
        p = [named[n] for n in run]
        m = [state["m"][n] for n in run]
        v = [state["v"][n] for n in run]
        gf = [grads[n].float() for n in run]
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
        torch._foreach_copy_(p, new_p)
        for dst, src in ((m, mf), (v, vf)):
            if dst[0].dtype != torch.float32:
                torch._foreach_copy_(dst, src)
    state["step"] = step
    return {"grad_norm": gnorm, "lr": lr}
