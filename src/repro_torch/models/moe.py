"""Mixture-of-Experts layer (Mixtral, DeepSeek-V3 style): the port of
``repro.models.moe``.

Three dispatch implementations (``cfg.moe_impl``), as the reference's:

  * "dense"  one-hot dispatch / combine products with a capacity of
             ``max(int(T k capacity_factor / E), 1)`` slots an expert;
             tokens over capacity are dropped;
  * "gather" the same capacity, through an inverse slot map and gathers
             instead of the (T, E, C) one-hot products;
  * "ragged" dropless: tokens sorted by expert (stable) and one product
             per expert group.

Router: softmax top-k with renormalisation and the Switch load-balance
loss. Ties go to the lower expert, as ``jax.lax.top_k`` orders them (a
stable descending sort; ``torch.topk`` promises no order). Shared experts
(DeepSeek) are a SwiGLU MLP added to every token.

The dense and gather paths keep every index on the device. The ragged
path needs its group sizes on the host to slice the groups: it is the one
place of the serving path that syncs with the device. The combine of the
ragged path is ``index_add_``, whose CUDA atomics add a token's k expert
outputs in no fixed order: at k > 2 (DeepSeek's k = 8) the sum may differ
from the reference's in its last bits.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor

from .config import ModelConfig
from .layers import MLP, local_offset, shard, sharding_mesh, trunc_normal

__all__ = ["MoE", "router_topk", "moe_forward"]


class MoE(nn.Module):
    """router (d, E) float32; wg, wu (E, d, m) and wd (E, m, d) in the
    model dtype; ``shared`` a SwiGLU MLP of width m * n_shared_experts."""

    #: the global index of the first expert held (the dispatch functions
    #: take a module or a rank's ``_Experts``)
    e0 = 0

    def __init__(self, cfg: ModelConfig, device=None, dtype=None):
        super().__init__()
        d, e, m = cfg.d_model, cfg.n_experts, cfg.d_expert
        self.router = nn.Parameter(torch.empty((d, e), device=device))
        for name, shape in (("wg", (e, d, m)), ("wu", (e, d, m)),
                            ("wd", (e, m, d))):
            self.register_parameter(name, nn.Parameter(
                torch.empty(shape, device=device, dtype=dtype)))
        self.shared = (MLP(d, m * cfg.n_shared_experts, "swiglu", device,
                           dtype) if cfg.n_shared_experts else None)

    @torch.no_grad()
    def init_(self, gen: torch.Generator):
        """The router a truncated normal scaled by d ** -0.5; the experts
        normals scaled by their d_in ** -0.5 (the reference's ``init_moe``),
        drawn an expert at a time so that no float32 copy of a whole stack
        is made."""
        self.router.copy_(trunc_normal(gen, self.router.shape,
                                       self.router.shape[0] ** -0.5,
                                       torch.float32))
        for w in (self.wg, self.wu, self.wd):
            for i in range(w.shape[0]):
                w[i].copy_(torch.randn(w.shape[1:], generator=gen,
                                       device=w.device)
                           * w.shape[1] ** -0.5)
        if self.shared is not None:
            self.shared.init_(gen)


def router_topk(cfg: ModelConfig, p: MoE, x2d):
    """(T, d) -> (weights (T, k) in x's dtype, idx (T, k), aux float32):
    softmax top-k, renormalised, and the Switch load-balance loss."""
    probs = torch.softmax(x2d.float() @ p.router, dim=-1)    # (T, E)
    # a stable descending sort puts the lower expert first on equal
    # probabilities, as jax.lax.top_k does
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = w[:, :cfg.moe_top_k], idx[:, :cfg.moe_top_k]
    w = w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-9)
    e = cfg.n_experts
    me = probs.mean(0)
    ce = F.one_hot(idx[:, 0], e).float().mean(0)
    aux = e * (me * ce).sum()
    return w.to(x2d.dtype), idx, aux


def _capacity(cfg: ModelConfig, t: int) -> int:
    return max(int(t * cfg.moe_top_k * cfg.capacity_factor / cfg.n_experts),
               1)


def _slots(cfg: ModelConfig, idx, cap):
    """(onehot (T, k, E) int32, pos (T, E): the token's slot in each
    expert, keep (T, E): routed there and within capacity)."""
    onehot = F.one_hot(idx, cfg.n_experts).int()
    sel = onehot.sum(1)
    pos = torch.cumsum(sel, dim=0) - 1
    return onehot, pos, (pos < cap) & (sel > 0)


class _Experts(NamedTuple):
    """The expert weights a rank holds and the global index of its first
    expert (all of them at e0 = 0 off a mesh)."""
    wg: torch.Tensor
    wu: torch.Tensor
    wd: torch.Tensor
    e0: int = 0


def _experts(ex, xe):
    """The batched expert FFN: (E, C, d) -> (E, C, d)."""
    h = F.silu(torch.einsum("ecd,edm->ecm", xe, ex.wg)) \
        * torch.einsum("ecd,edm->ecm", xe, ex.wu)
    h = shard(h, "experts", None, None)
    return torch.einsum("ecm,emd->ecd", h, ex.wd)


def _moe_dense(cfg: ModelConfig, ex, x2d, w, idx):
    cap = _capacity(cfg, x2d.shape[0])
    onehot, pos, keep = _slots(cfg, idx, cap)
    # a slot of `cap` is out of range: jax.nn.one_hot gives a zero row
    # there, so the extra column is cut off
    dispatch = (F.one_hot(torch.where(keep, pos, cap).long(), cap + 1)
                [..., :cap].to(x2d.dtype) * keep[..., None])  # (T, E, C)
    dispatch = shard(dispatch, None, "experts", None)
    xe = shard(torch.einsum("tec,td->ecd", dispatch, x2d), "experts", None,
               None)
    ye = _experts(ex, xe)
    wsel = torch.einsum("tke,tk->te", onehot.to(w.dtype), w)  # (T, E)
    combine = dispatch * wsel[:, :, None]
    return torch.einsum("tec,ecd->td", combine, ye)


def _moe_gather(cfg: ModelConfig, ex, x2d, w, idx):
    """Capacity dispatch through the inverse slot map (E, C) -> token:
    no (T, E, C) one-hot tensor. Slots are counted over all T tokens;
    only the experts `ex` holds run, and a token's other experts add
    zeros (on a mesh the other ranks add theirs)."""
    t, d = x2d.shape
    e = cfg.n_experts
    el = ex.wg.shape[0]
    cap = _capacity(cfg, t)
    _, pos, keep = _slots(cfg, idx, cap)
    tok_ids = torch.arange(t, dtype=torch.int64,
                           device=x2d.device)[:, None].expand(t, e)
    flat_slot = (torch.arange(e, device=x2d.device) * cap)[None, :] \
        + torch.clamp_max(pos, cap - 1)
    # the reference's scatter drops out-of-range slots (mode="drop"): they
    # land in one extra slot here, which is cut off
    inv = torch.full((e * cap + 1,), t, dtype=torch.int64, device=x2d.device)
    inv[torch.where(keep, flat_slot, e * cap).reshape(-1)] = \
        tok_ids.reshape(-1)
    inv = inv[:e * cap].reshape(e, cap)[ex.e0:ex.e0 + el]
    xpad = torch.cat([x2d, x2d.new_zeros((1, d))], dim=0)
    ye = _experts(ex, shard(xpad[inv], "experts", None, None))  # (El, C, d)
    slot_of = torch.where(keep, torch.clamp_max(pos, cap - 1), cap)
    tk_slot = torch.take_along_dim(slot_of, idx, dim=1)       # (T, k)
    mine = (idx >= ex.e0) & (idx < ex.e0 + el)
    ypad = torch.cat([ye, ye.new_zeros((el, 1, d))], dim=1)   # (El, C+1, d)
    ypad = torch.cat([ypad, ypad.new_zeros((1, cap + 1, d))])  # + no expert
    rows = ypad[torch.where(mine, idx - ex.e0, el),
                torch.where(mine, tk_slot, cap)]
    return torch.einsum("tkd,tk->td", rows, w)


def _ragged_dot(x, w, sizes):
    """Rows of x grouped by expert, `sizes` rows each (host ints): group
    i times w[i]."""
    out = x.new_empty((x.shape[0], w.shape[-1]))
    r0 = 0
    for i, n in enumerate(sizes):
        if n:
            out[r0:r0 + n] = x[r0:r0 + n] @ w[i]
        r0 += n
    return out


def _moe_ragged(cfg: ModelConfig, ex, x2d, w, idx):
    """Dropless: the T k (token, expert) pairs sorted by expert, stably,
    and one product per expert group of the experts `ex` holds. The
    group sizes are read on the host (one sync a call: the only one on
    the serving path)."""
    t, d = x2d.shape
    k = cfg.moe_top_k
    el = ex.wg.shape[0]
    flat_e = idx.reshape(t * k)
    flat_t = torch.arange(t, device=x2d.device).repeat_interleave(k)
    order = torch.argsort(flat_e, stable=True)
    sizes = torch.bincount(flat_e, minlength=cfg.n_experts).tolist()
    r0 = sum(sizes[:ex.e0])
    sizes = sizes[ex.e0:ex.e0 + el]
    mine = order[r0:r0 + sum(sizes)]
    xs = x2d[flat_t[mine]]
    h = F.silu(_ragged_dot(xs, ex.wg, sizes)) * _ragged_dot(xs, ex.wu, sizes)
    ys = _ragged_dot(h, ex.wd, sizes)
    wflat = w.reshape(t * k)[mine]
    out = x2d.new_zeros((t, d))
    return out.index_add_(0, flat_t[mine], ys * wflat[:, None])


def _on_local_experts(cfg: ModelConfig, p: MoE, x2d, w, idx, dispatch):
    """`dispatch` (gather or ragged) under a mesh, as ``local_map``: its
    index, scatter and ``index_add_`` ops have no DTensor rule. Slots are
    counted over all tokens, as the reference counts them, so the tokens,
    their weights and experts are gathered over the data axes (each rank
    then runs every token through the experts it holds); each rank's
    output, and its gradient of x and w, is its experts' (or its ffn
    slice's) share: a partial sum over the mesh dims the expert weights
    shard."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = sharding_mesh()

    def whole_d(t, d):
        # a d_model dim split by ZeRO-1 / FSDP: gathered for compute, as
        # the reference's partitioner gathers FSDP weights
        pl = [Replicate() if q.is_shard(d) else q for q in t.placements]
        return t if pl == list(t.placements) else t.redistribute(mesh, pl)

    ws = (whole_d(p.wg, 1), whole_d(p.wu, 1), whole_d(p.wd, 2))
    e0 = local_offset(ws[0], mesh, 0)
    sharded = [any(t.placements[i].is_shard() for t in ws)
               for i in range(mesh.ndim)]
    whole = [Replicate()] * mesh.ndim
    part = [Partial() if s else Replicate() for s in sharded]
    x2d, w, idx = (t.redistribute(mesh, whole) for t in (x2d, w, idx))

    def local(xl, wl, il, wg, wu, wd):
        return dispatch(cfg, _Experts(wg, wu, wd, e0), xl, wl, il)

    pls = tuple(t.placements for t in ws)
    return local_map(
        local, out_placements=part,
        in_placements=(whole, whole, whole) + pls,
        in_grad_placements=(part, part, whole) + pls,
        device_mesh=mesh)(x2d, w, idx, *ws)


def moe_forward(cfg: ModelConfig, p: MoE, x):
    """x: (B, S, d) -> (out (B, S, d), aux float32)."""
    b, s, d = x.shape
    x2d = x.reshape(b * s, d)
    w, idx, aux = router_topk(cfg, p, x2d)
    dispatch = {"ragged": _moe_ragged, "gather": _moe_gather}.get(
        cfg.moe_impl, _moe_dense)
    if dispatch is not _moe_dense and sharding_mesh() is not None \
            and isinstance(x2d, DTensor):
        y = _on_local_experts(cfg, p, x2d, w, idx, dispatch)
    else:
        y = dispatch(cfg, _Experts(p.wg, p.wu, p.wd), x2d, w, idx)
    if p.shared is not None:
        y = y + p.shared(x2d)
    return y.reshape(b, s, d), aux
