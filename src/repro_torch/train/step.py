"""Train-step factory: loss -> gradients -> AdamW, with optional
microbatch gradient accumulation and optional int8 error-feedback
compression of the gradient summand across a ``torch.distributed``
group (the port of ``repro.train.step``).

``make_train_step(cfg, ...)`` returns ``train_step(model, opt_state,
batch) -> metrics``: it updates the model's parameters and
``opt_state`` in place and returns 0-d device tensors. It makes no host
sync of its own (no ``.item()``, no branch on a device value): the
gradients come from ``torch.autograd.grad`` (no ``.grad`` fields), the
optimizer keeps its step and learning rate on the device.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from ..models.config import ModelConfig
from ..models.lm import loss_fn
from ..optim import (adamw_update, cosine_schedule, decompress_int8,
                     error_feedback_compress, leaf_order)

__all__ = ["make_train_step", "make_eval_step"]


def _grads(loss, params: dict) -> dict:
    """d loss / d each parameter, zeros where the loss does not reach."""
    names = list(params)
    got = torch.autograd.grad(loss, [params[n] for n in names],
                              allow_unused=True)
    return {n: torch.zeros_like(params[n]) if g is None else g
            for n, g in zip(names, got)}


def make_train_step(cfg: ModelConfig, *, lr=3e-4, warmup=100,
                    total_steps=10000, n_micro: int = 1, weight_decay=0.1,
                    max_norm=1.0, grad_compression: bool = False,
                    pod_group=None, accum_dtype=torch.float32):
    """Build ``train_step(model, opt_state, batch) -> metrics``.

    n_micro > 1: the batch splits along its first axis into n_micro
    microbatches run one after the other, their gradients summed in
    float32 for float32 parameters and in `accum_dtype` for bfloat16 ones
    (the reference's rule), then divided by n_micro; metrics then carry
    only "ce" of the loss's terms, as the reference's.
    grad_compression with a `pod_group` (a ``torch.distributed`` group,
    the reference's ``shard_map`` axis): each rank quantizes gradient +
    error to int8 (``error_feedback_compress``), the decompressed
    summands are all-reduced over the group and divided by its size; the
    error rides in ``opt_state["ef_err"]`` (zeros when absent). Without a
    group nothing is compressed, as the reference without ``pod_axis``.
    metrics: "ce", "moe_aux", "mtp" (where the loss has them), "loss",
    "grad_norm", "lr".
    """
    lr_fn = cosine_schedule(lr, warmup, total_steps)
    compress = grad_compression and pod_group is not None

    def grads_of(model, params, batch):
        if n_micro == 1:
            loss, metrics = loss_fn(cfg, model, batch)
            return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
                _grads(loss, params)
        sharded = any(isinstance(p, DTensor) for p in params.values())
        dtype = {n: accum_dtype if p.dtype == torch.bfloat16
                 else torch.float32 for n, p in params.items()}
        names = list(dtype)
        acc = {} if sharded else {
            n: torch.zeros(p.shape, device=p.device, dtype=dtype[n])
            for n, p in params.items()}
        lsum = None
        for i in range(n_micro):
            mb = {k: _micro(v, n_micro, i) for k, v in batch.items()}
            loss, _ = loss_fn(cfg, model, mb)
            g = _grads(loss, params)
            if sharded:
                # DTensor gradients keep their placements (partial sums
                # too) until AdamW redistributes them: added one by one
                acc = {n: g[n].to(dtype[n]) + acc[n] if acc
                       else g[n].to(dtype[n]) for n in names}
            else:
                torch._foreach_add_([acc[n] for n in names],
                                    [g[n].to(acc[n].dtype) for n in names])
            lsum = loss.detach() if lsum is None else lsum + loss.detach()
        if sharded:
            acc = {n: a / n_micro for n, a in acc.items()}
        else:
            torch._foreach_div_([acc[n] for n in names], n_micro)
        return lsum / n_micro, {"ce": lsum / n_micro}, acc

    def compressed(grads, opt_state):
        import torch.distributed as dist
        if any(isinstance(g, DTensor) for g in grads.values()):
            return _compressed_over_pods(grads, opt_state, pod_group)
        err = opt_state.get("ef_err") or {
            n: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for n, g in grads.items()}
        size = dist.get_world_size(pod_group)
        out, new_err = {}, {}
        for n in sorted(grads, key=leaf_order):
            q, scale, new_err[n] = error_feedback_compress(grads[n], err[n])
            summand = decompress_int8(q, scale)
            dist.all_reduce(summand, group=pod_group)
            out[n] = summand / size
        opt_state["ef_err"] = new_err
        return out

    def train_step(model, opt_state, batch):
        params = dict(model.named_parameters())
        loss, metrics, grads = grads_of(model, params, batch)
        if compress:
            grads = compressed(grads, opt_state)
        metrics.update(adamw_update(params, grads, opt_state, lr_fn,
                                    weight_decay=weight_decay,
                                    max_norm=max_norm))
        metrics["loss"] = loss
        return metrics

    return train_step


def _micro(v, n: int, i: int):
    """Microbatch i of n of batch leaf `v`. A DTensor batch splits each
    rank's own rows (the reference splits the global rows, which would put
    a microbatch on a few data ranks): the same rows over all n, so the
    same summed gradient where every label counts."""
    if not isinstance(v, DTensor):
        return v.reshape((n, v.shape[0] // n) + tuple(v.shape[1:]))[i]
    loc = v.to_local()
    if loc.shape[0] % n:
        raise ValueError(f"{n} microbatches do not split the {loc.shape[0]} "
                         f"rows a data rank holds (a global batch of "
                         f"{v.shape[0]})")
    part = loc.reshape((n, loc.shape[0] // n) + tuple(loc.shape[1:]))[i]
    return DTensor.from_local(part, v.device_mesh, v.placements,
                              run_check=False)


def _compressed_over_pods(grads: dict, opt_state: dict, pod_group) -> dict:
    """Int8 error feedback of DTensor gradients across the "pod" axis of
    the mesh: each gradient is reduced over the other axes, its pod's
    partial sum (the gradient of the global mean: the reference's pod
    mean over the pod count) quantized with the pod's error, and the
    summands are summed over `pod_group`; the error rides in
    ``opt_state["ef_err"]`` at the gradient's placements."""
    import torch.distributed as dist
    from torch.distributed.tensor import Partial, Replicate
    out, new_err = {}, {}
    err = opt_state.get("ef_err") or {}
    for n in sorted(grads, key=leaf_order):
        g = grads[n]
        mesh = g.device_mesh
        pod = mesh.mesh_dim_names.index("pod")
        keep = [Replicate() if p.is_partial() else p for p in g.placements]
        keep[pod] = Partial()
        g = g.redistribute(mesh, keep)
        e = err.get(n)
        q, scale, ne = error_feedback_compress(
            g.to_local(), torch.zeros(g.to_local().shape, dtype=torch.float32,
                                      device=g.to_local().device)
            if e is None else e.to_local())
        summand = decompress_int8(q, scale)
        dist.all_reduce(summand, group=pod_group)
        whole = list(keep)
        whole[pod] = Replicate()
        out[n] = DTensor.from_local(summand, mesh, whole, run_check=False)
        new_err[n] = DTensor.from_local(ne, mesh, keep, run_check=False)
    opt_state["ef_err"] = new_err
    return out


def make_eval_step(cfg: ModelConfig):
    """``eval_step(model, batch) -> metrics`` (the loss's terms and
    "loss") under ``torch.inference_mode()``: no activation is kept, and
    ``attn_impl="flash"`` runs the forward-only kernel."""
    def eval_step(model, batch):
        with torch.inference_mode():
            loss, metrics = loss_fn(cfg, model, batch)
        return dict(metrics, loss=loss)
    return eval_step
