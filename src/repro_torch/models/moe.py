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

import torch
import torch.nn.functional as F
from torch import nn

from .config import ModelConfig
from .layers import MLP, trunc_normal

__all__ = ["MoE", "router_topk", "moe_forward"]


class MoE(nn.Module):
    """router (d, E) float32; wg, wu (E, d, m) and wd (E, m, d) in the
    model dtype; ``shared`` a SwiGLU MLP of width m * n_shared_experts."""

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


def _experts(p: MoE, xe):
    """The batched expert FFN: (E, C, d) -> (E, C, d)."""
    h = F.silu(torch.einsum("ecd,edm->ecm", xe, p.wg)) \
        * torch.einsum("ecd,edm->ecm", xe, p.wu)
    return torch.einsum("ecm,emd->ecd", h, p.wd)


def _moe_dense(cfg: ModelConfig, p: MoE, x2d, w, idx):
    cap = _capacity(cfg, x2d.shape[0])
    onehot, pos, keep = _slots(cfg, idx, cap)
    # a slot of `cap` is out of range: jax.nn.one_hot gives a zero row
    # there, so the extra column is cut off
    dispatch = (F.one_hot(torch.where(keep, pos, cap).long(), cap + 1)
                [..., :cap].to(x2d.dtype) * keep[..., None])  # (T, E, C)
    ye = _experts(p, torch.einsum("tec,td->ecd", dispatch, x2d))
    wsel = torch.einsum("tke,tk->te", onehot.to(w.dtype), w)  # (T, E)
    combine = dispatch * wsel[:, :, None]
    return torch.einsum("tec,ecd->td", combine, ye)


def _moe_gather(cfg: ModelConfig, p: MoE, x2d, w, idx):
    """Capacity dispatch through the inverse slot map (E, C) -> token:
    no (T, E, C) one-hot tensor."""
    t, d = x2d.shape
    e = cfg.n_experts
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
    inv = inv[:e * cap].reshape(e, cap)
    xpad = torch.cat([x2d, x2d.new_zeros((1, d))], dim=0)
    ye = _experts(p, xpad[inv])                               # (E, C, d)
    slot_of = torch.where(keep, torch.clamp_max(pos, cap - 1), cap)
    tk_slot = torch.take_along_dim(slot_of, idx, dim=1)       # (T, k)
    ypad = torch.cat([ye, ye.new_zeros((e, 1, d))], dim=1)    # (E, C+1, d)
    return torch.einsum("tkd,tk->td", ypad[idx, tk_slot], w)


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


def _moe_ragged(cfg: ModelConfig, p: MoE, x2d, w, idx):
    """Dropless: the T k (token, expert) pairs sorted by expert, stably,
    and one product per expert group. The group sizes are read on the
    host (one sync a call: the only one on the serving path)."""
    t, d = x2d.shape
    k = cfg.moe_top_k
    flat_e = idx.reshape(t * k)
    flat_t = torch.arange(t, device=x2d.device).repeat_interleave(k)
    order = torch.argsort(flat_e, stable=True)
    xs = x2d[flat_t[order]]
    sizes = torch.bincount(flat_e, minlength=cfg.n_experts).tolist()
    h = F.silu(_ragged_dot(xs, p.wg, sizes)) * _ragged_dot(xs, p.wu, sizes)
    ys = _ragged_dot(h, p.wd, sizes)
    wflat = w.reshape(t * k)[order]
    out = x2d.new_zeros((t, d))
    return out.index_add_(0, flat_t[order], ys * wflat[:, None])


def moe_forward(cfg: ModelConfig, p: MoE, x):
    """x: (B, S, d) -> (out (B, S, d), aux float32)."""
    b, s, d = x.shape
    x2d = x.reshape(b * s, d)
    w, idx, aux = router_topk(cfg, p, x2d)
    if cfg.moe_impl == "ragged":
        y = _moe_ragged(cfg, p, x2d, w, idx)
    elif cfg.moe_impl == "gather":
        y = _moe_gather(cfg, p, x2d, w, idx)
    else:
        y = _moe_dense(cfg, p, x2d, w, idx)
    if p.shared is not None:
        y = y + p.shared(x2d)
    return y.reshape(b, s, d), aux
