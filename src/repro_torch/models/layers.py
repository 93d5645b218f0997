"""Shared neural layers of the LM: norms, RoPE, MLPs, embedding and tied
logits, and the truncated-normal initialiser. The port of
``repro.models.layers``, as functions over tensors, and the two
parameter modules every block kind holds, ``Norm`` and ``MLP``; the
training side's ``cross_entropy`` and the RMSNorm's backward
(``_RMSNorm``, the reference's custom VJP).

Each follows the reference's arithmetic where PyTorch's defaults differ:
the norms compute in float32 with eps = 1e-6 (LayerNorm with the
population variance, as ``jnp.var``), GELU is the tanh approximation
(``jax.nn.gelu``'s default) and RoPE rotates interleaved pairs
(``x[..., 0::2]``, ``x[..., 1::2]``) over the first ``rotary_pct`` of the
head, with float32 angles. The reference's logical-axis sharding
annotations have no counterpart here: the distributed slice brings one.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["trunc_normal", "rms_norm", "layer_norm", "apply_norm",
           "rope_freqs", "apply_rope", "apply_mlp", "embed_tokens",
           "logits_out", "cross_entropy", "Norm", "MLP"]

EPS = 1e-6


def trunc_normal(gen: torch.Generator, shape, scale: float, dtype):
    """A standard normal truncated to [-2, 2], times `scale`, drawn in
    float32 from `gen` on its device and cast to `dtype` (the reference's
    ``trunc_normal``; the numbers differ, the distribution is the same)."""
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * scale).to(dtype)


class _RMSNorm(torch.autograd.Function):
    """RMSNorm with the reference's custom VJP (``layers._rmsnorm``): the
    forward keeps x in its own dtype and the float32 rstd (B, S, 1), not
    the float32 panels autograd would keep, and the backward gives dx in
    x's dtype and dscale summed over every axis but the last."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        xf = x.float()
        rstd = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
        ctx.save_for_backward(x, rstd, scale)
        return (xf * rstd * scale).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, rstd, scale = ctx.saved_tensors
        xhat = x.float() * rstd
        gf = g.float()
        gs = gf * scale
        dot = (gs * xhat).mean(-1, keepdim=True)
        dx = ((gs - xhat * dot) * rstd).to(x.dtype)
        dscale = gf * xhat
        if x.dim() > 1:
            dscale = dscale.sum(tuple(range(x.dim() - 1)))
        return dx, dscale.to(scale.dtype), None


def rms_norm(x, scale, eps: float = EPS):
    """x / rms(x) * scale in float32, cast back to x's dtype; through
    ``_RMSNorm`` whenever a gradient is taken."""
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return _RMSNorm.apply(x, scale, eps)
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


def layer_norm(x, scale, bias, eps: float = EPS):
    """(x - mean) / sqrt(population variance + eps) * scale + bias in
    float32, cast back to x's dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    return ((xf - mu) * torch.rsqrt(var + eps) * scale + bias).to(x.dtype)


def apply_norm(x, scale, bias=None, kind: str = "rmsnorm", eps: float = EPS):
    if kind == "rmsnorm":
        return rms_norm(x, scale, eps)
    return layer_norm(x, scale, bias, eps)


def rope_freqs(dh_rot: int, theta: float, device=None):
    """(dh_rot // 2,) float32 inverse frequencies."""
    e = torch.arange(0, dh_rot, 2, dtype=torch.float32, device=device) / dh_rot
    # theta filled on the device: a tensor made from a host value would be
    # a copy, and a decode step makes none
    return 1.0 / torch.pow(torch.full((), theta, dtype=torch.float32,
                                      device=device), e)


def apply_rope(x, positions, theta: float, rotary_pct: float = 1.0):
    """x: (..., S, dh); positions: (S,). Rotates the interleaved pairs of
    the first rotary_pct of dh (chatglm's partial rope at 0.5)."""
    dh = x.shape[-1]
    dh_rot = int(dh * rotary_pct)
    dh_rot -= dh_rot % 2
    if dh_rot == 0:
        return x
    inv = rope_freqs(dh_rot, theta, x.device)
    ang = positions[..., :, None].float() * inv              # (S, dh_rot/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    xr = x[..., :dh_rot].float()
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x1 * sin + x2 * cos
    rot = torch.stack([r1, r2], dim=-1).reshape(xr.shape).to(x.dtype)
    return torch.cat([rot, x[..., dh_rot:]], dim=-1)


def apply_mlp(x, wu, wd, wg=None, kind: str = "swiglu"):
    """SwiGLU (silu(x wg) * (x wu)) wd, or GELU-tanh (x wu) wd; weights
    are (d_in, d_out)."""
    if kind == "swiglu":
        h = F.silu(x @ wg) * (x @ wu)
    else:
        h = F.gelu(x @ wu, approximate="tanh")
    return h @ wd


def embed_tokens(table, tokens):
    return table[tokens]


def logits_out(table, x):
    """Tied logits: (B, S, d) @ (d, V)."""
    return x @ table.T.to(x.dtype)


def cross_entropy(logits, labels, ignore_id: int = -100):
    """Mean token cross-entropy in float32 over the labels that are not
    `ignore_id`: the label's logit gathered at ``labels.clamp(min=0)``,
    the masked sum over max(count, 1). A 0-d device tensor; no host
    sync."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, labels.clamp(min=0)[..., None])[..., 0]
    mask = labels != ignore_id
    nll = (lse - ll) * mask
    return nll.sum() / torch.clamp_min(mask.sum(), 1)


class Norm(nn.Module):
    """RMSNorm (scale) or LayerNorm (scale, bias); float32 parameters."""

    def __init__(self, d: int, kind: str, device=None):
        super().__init__()
        self.kind = kind
        self.scale = nn.Parameter(torch.ones(d, device=device))
        self.bias = (nn.Parameter(torch.zeros(d, device=device))
                     if kind != "rmsnorm" else None)

    def forward(self, x):
        return apply_norm(x, self.scale, self.bias, self.kind)


class MLP(nn.Module):
    """SwiGLU (wg, wu, wd) or GELU (wu, wd), (d_in, d_out) weights."""

    def __init__(self, d: int, d_ff: int, kind: str, device=None, dtype=None):
        super().__init__()
        self.kind = kind
        shapes = {"wu": (d, d_ff), "wd": (d_ff, d)}
        if kind == "swiglu":
            shapes = {"wg": (d, d_ff), **shapes}
        for name, shape in shapes.items():
            self.register_parameter(name, nn.Parameter(
                torch.empty(shape, device=device, dtype=dtype)))

    @torch.no_grad()
    def init_(self, gen: torch.Generator):
        for w in self.parameters():
            w.copy_(trunc_normal(gen, w.shape, w.shape[0] ** -0.5, w.dtype))

    def forward(self, x):
        return apply_mlp(x, self.wu, self.wd, getattr(self, "wg", None),
                         self.kind)
