"""Mamba2 / SSD layer (state-space duality, arXiv:2405.21060): the port of
``repro.models.mamba2``.

Chunked SSD: the sequence is split into chunks of ``ssm_chunk`` tokens;
within a chunk the output is an attention-like masked product, across
chunks a (H, P, N) state is carried by a loop. Decode is the pure
recurrence: one state update per token against a (B, H, P, N) float32
state and a (B, K - 1, conv_dim) rolling conv window.

The z / x / B / C / dt projections and the depthwise conv weights are
separate parameters, as the reference keeps them. Mixed types follow
JAX's promotion, cast explicitly where PyTorch would refuse them: the
decode cache is float32 whatever the model's dtype (the reference's
``init_mamba_cache`` default), so in a bf16 model the conv window is
float32 and the recurrence runs in float32; products that the reference
asks for with ``preferred_element_type=float32`` take float32 operands
(bf16 products are exact in float32).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .config import ModelConfig
from .layers import shard, trunc_normal

__all__ = ["Mamba", "dims", "ssd_forward", "mamba_forward",
           "init_mamba_cache", "mamba_decode"]

CHUNK = 256


def dims(cfg: ModelConfig):
    """(d_inner, heads, conv_dim). Touches no attention field: ``cfg.dh``
    divides by n_heads, which is 0 in an attention-free configuration."""
    di = cfg.ssm_expand * cfg.d_model
    nh = di // cfg.ssm_headdim
    conv_dim = di + 2 * cfg.ssm_ngroups * cfg.ssm_state
    return di, nh, conv_dim


class Mamba(nn.Module):
    """wz, wx (d, di), wb, wc (d, G N), wdt (d, H), out_proj (di, d) and
    the conv weights (K, channels) and bias in the model dtype; a_log,
    dt_bias, d_skip (H,) and norm_scale (di,) in float32."""

    def __init__(self, cfg: ModelConfig, device=None, dtype=None):
        super().__init__()
        d, k = cfg.d_model, cfg.ssm_conv
        di, nh, _ = dims(cfg)
        gn = cfg.ssm_ngroups * cfg.ssm_state
        for name, shape, dt in (
                ("wz", (d, di), dtype), ("wx", (d, di), dtype),
                ("wb", (d, gn), dtype), ("wc", (d, gn), dtype),
                ("wdt", (d, nh), dtype), ("conv_wx", (k, di), dtype),
                ("conv_wb", (k, gn), dtype), ("conv_wc", (k, gn), dtype),
                ("conv_b", (di + 2 * gn,), dtype),
                ("a_log", (nh,), torch.float32),
                ("dt_bias", (nh,), torch.float32),
                ("d_skip", (nh,), torch.float32),
                ("norm_scale", (di,), torch.float32),
                ("out_proj", (di, d), dtype)):
            self.register_parameter(name, nn.Parameter(
                torch.empty(shape, device=device, dtype=dt)))

    @torch.no_grad()
    def init_(self, gen: torch.Generator):
        """The reference's ``init_mamba``: the projections truncated
        normals scaled by d_in ** -0.5, conv_wx a normal scaled by K **
        -0.5, conv_wb / conv_wc / conv_b / dt_bias zero, a_log = log(1 ..
        H), d_skip and norm_scale one."""
        for w in (self.wz, self.wx, self.wb, self.wc, self.wdt,
                  self.out_proj):
            w.copy_(trunc_normal(gen, w.shape, w.shape[0] ** -0.5, w.dtype))
        k = self.conv_wx.shape[0]
        self.conv_wx.copy_(torch.randn(self.conv_wx.shape, generator=gen,
                                       device=self.conv_wx.device) * k ** -0.5)
        for w in (self.conv_wb, self.conv_wc, self.conv_b, self.dt_bias):
            w.zero_()
        self.a_log.copy_(torch.log(torch.arange(
            1, self.a_log.shape[0] + 1, dtype=torch.float32,
            device=self.a_log.device)))
        self.d_skip.fill_(1.0)
        self.norm_scale.fill_(1.0)


def _causal_conv(x, w, b):
    """Depthwise causal conv, width K: (B, S, C) -> (B, S, C), summed tap
    by tap in x's dtype as the reference's Python ``sum``."""
    k = w.shape[0]
    xp = torch.cat([x.new_zeros(x.shape[:1] + (k - 1,) + x.shape[2:]), x],
                   dim=1)
    out = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(k))
    return F.silu(out + b)


def _segsum(log_a):
    """(..., L) -> (..., L, L): out[i, j] = sum_{j < m <= i} log_a[m],
    -inf above the diagonal."""
    n = log_a.shape[-1]
    cs = torch.cumsum(log_a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((n, n), dtype=torch.bool,
                                 device=log_a.device))
    return torch.where(mask, diff, float("-inf"))


def _f32_einsum(eq, *ops):
    """An einsum at the reference's ``preferred_element_type=float32``."""
    return torch.einsum(eq, *(o.float() for o in ops))


def ssd_forward(cfg: ModelConfig, p: Mamba, u, B, C, dt):
    """Chunked SSD scan. u: (Bt, S, H, P); B / C: (Bt, S, G, N); dt: (Bt,
    S, H) float32, softplus'd. Returns y (Bt, S, H, P) in float32. S must
    be a multiple of min(ssm_chunk, S): the reference asserts it, and so
    does this (AssertionError, the same message), rather than pad."""
    bt, s, h, pdim = u.shape
    rep = h // B.shape[2]
    log_da = dt * -torch.exp(p.a_log)                         # (Bt, S, H)
    lc = min(cfg.ssm_chunk or CHUNK, s)
    if s % lc:
        raise AssertionError("sequence must divide the SSD chunk")
    nc = s // lc

    def resh(x):
        return x.reshape((bt, nc, lc) + tuple(x.shape[2:]))

    uc, Bc, Cc, dtc, ldc = map(resh, (u, B, C, dt, log_da))
    Bh = Bc.repeat_interleave(rep, dim=3)                     # (Bt,nc,lc,H,N)
    Ch = Cc.repeat_interleave(rep, dim=3)

    # intra-chunk (diagonal blocks)
    decay = torch.exp(_segsum(ldc.transpose(-1, -2)))         # (Bt,nc,H,lc,lc)
    scores = _f32_einsum("bclhn,bcshn->bchls", Ch, Bh)
    panel = (scores * decay).to(u.dtype)
    du = (dtc[..., None] * uc.float()).to(u.dtype)
    y_diag = _f32_einsum("bchls,bcshp->bclhp", panel, du)

    # chunk-final states
    cum = torch.cumsum(ldc, dim=2)                            # (Bt,nc,lc,H)
    total = cum[:, :, -1:]
    decay_in = torch.exp(total - cum)
    b_scaled = (Bh * (dtc * decay_in)[..., None]).to(u.dtype)
    states = _f32_einsum("bclhn,bclhp->bchpn", b_scaled, uc)  # (Bt,nc,H,P,N)

    # inter-chunk recurrence: each chunk reads the state before it
    chunk_decay = torch.exp(total[:, :, 0])                   # (Bt,nc,H)
    carry = torch.zeros((bt, h, pdim, B.shape[3]), dtype=torch.float32,
                        device=u.device)
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, c][..., None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                    # (Bt,nc,H,P,N)

    y_off = _f32_einsum("bclhn,bchpn->bclhp", Ch, prev_states.to(u.dtype))
    y_off = y_off * torch.exp(cum)[..., None]
    y = (y_diag + y_off).reshape(bt, s, h, pdim)
    return y + u * p.d_skip[None, None, :, None]


def _project(cfg: ModelConfig, p: Mamba, x):
    """x -> (z, u_conv, B_conv, C_conv, dt) with per-part causal convs."""
    di = p.conv_wx.shape[1]
    gn = p.conv_wb.shape[1]
    z = x @ p.wz
    xu = _causal_conv(x @ p.wx, p.conv_wx, p.conv_b[:di])
    xb = _causal_conv(x @ p.wb, p.conv_wb, p.conv_b[di:di + gn])
    xc = _causal_conv(x @ p.wc, p.conv_wc, p.conv_b[di + gn:])
    return z, xu, xb, xc, x @ p.wdt


def _gated_norm(p: Mamba, y, z, dtype):
    """RMSNorm of y * silu(z) (eps 1e-6), in float32, cast to `dtype`."""
    yz = y * F.silu(z)
    var = yz.float().square().mean(-1, keepdim=True)
    return (yz * torch.rsqrt(var + 1e-6) * p.norm_scale).to(dtype)


def mamba_forward(cfg: ModelConfig, p: Mamba, x):
    """x: (B, S, d) -> (B, S, d)."""
    b, s, _ = x.shape
    di, nh, _ = dims(cfg)
    g, n, hp = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_headdim
    z, xu, xb, xc, dt = _project(cfg, p, x)
    dt = F.softplus(dt.float() + p.dt_bias)
    u = shard(xu.reshape(b, s, nh, hp), "batch", None, "heads", None)
    y = ssd_forward(cfg, p, u, xb.reshape(b, s, g, n), xc.reshape(b, s, g, n),
                    dt)
    return _gated_norm(p, y.reshape(b, s, di), z, x.dtype) @ p.out_proj


# ---------------------------------------------------------------------------
# decode (recurrent single step)
# ---------------------------------------------------------------------------

def init_mamba_cache(cfg: ModelConfig, batch: int, device=None):
    """{"conv": (B, K - 1, conv_dim), "state": (B, H, P, N)}, float32
    zeros (the reference's default dtype, which its ``init_cache`` keeps
    whatever the model's)."""
    _, nh, conv_dim = dims(cfg)
    return {"conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_dim),
                                dtype=torch.float32, device=device),
            "state": torch.zeros((batch, nh, cfg.ssm_headdim, cfg.ssm_state),
                                 dtype=torch.float32, device=device)}


def mamba_decode(cfg: ModelConfig, p: Mamba, x, cache):
    """x: (B, 1, d); cache: {"conv", "state"}, written in place. Returns
    (out (B, 1, d), cache)."""
    b = x.shape[0]
    di, nh, _ = dims(cfg)
    g, n, hp = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_headdim
    gn = g * n
    x0 = x[:, 0]
    z = x0 @ p.wz
    xbc = torch.cat([x0 @ p.wx, x0 @ p.wb, x0 @ p.wc], dim=-1)
    dt = x0 @ p.wdt
    conv = cache["conv"]
    # jnp.concatenate promotes: a float32 window in a bf16 model
    wt = torch.promote_types(conv.dtype, xbc.dtype)
    window = torch.cat([conv.to(wt), xbc[:, None].to(wt)], dim=1)  # (B,K,C)
    conv_w = torch.cat([p.conv_wx, p.conv_wb, p.conv_wc], dim=-1)
    ct = torch.promote_types(wt, conv_w.dtype)
    conv_out = torch.einsum("bkc,kc->bc", window.to(ct), conv_w.to(ct)) \
        + p.conv_b
    xbc = F.silu(conv_out)

    u = xbc[..., :di].reshape(b, nh, hp).float()
    Bs = xbc[..., di:di + gn].reshape(b, g, n)
    Cs = xbc[..., di + gn:].reshape(b, g, n)
    dt = F.softplus(dt.float() + p.dt_bias)                   # (B, H)
    da = torch.exp(dt * -torch.exp(p.a_log))
    rep = nh // g
    Bh = Bs.repeat_interleave(rep, dim=1).float()             # (B, H, N)
    Ch = Cs.repeat_interleave(rep, dim=1).float()
    state = (cache["state"] * da[..., None, None]
             + dt[..., None, None] * u[..., :, None] * Bh[..., None, :])
    y = torch.einsum("bhpn,bhn->bhp", state, Ch)
    y = (y + u * p.d_skip[None, :, None]).reshape(b, di).to(x.dtype)
    out = (_gated_norm(p, y, z, x.dtype) @ p.out_proj)[:, None]
    conv.copy_(window[:, 1:])
    cache["state"].copy_(state)
    return out, cache
