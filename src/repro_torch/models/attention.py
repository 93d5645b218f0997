"""GQA attention of the dense LM, full-sequence forward: the port of
``repro.models.attention`` (``init_attn``'s GQA branch,
``_xla_attention``, ``_flash``, ``attention_core``, ``gqa_forward``).

Two implementations (``cfg.attn_impl``), routed as the reference routes
them:
  * "xla"   query-chunked attention in plain PyTorch: float32 scores and
            softmax per chunk of 1024 queries, the probabilities cast to
            the model dtype before P.V, as the reference does;
  * "flash" the CUDA kernel (``kernels.ops.flash_attention``), taken only
            when there is more than one query row (Sq > 1): bf16 and fp16
            on the tensor cores, which also round p to the model dtype
            before P.V (against their own running max, per 128-key
            tile), float32 on the CUDA cores.
MLA, cross-attention and the decode paths come with later slices.
"""
from __future__ import annotations

import torch
from torch import nn

from ..kernels.ops import flash_attention
from .config import ModelConfig
from .layers import apply_rope, trunc_normal

__all__ = ["Attention", "attention_core", "gqa_forward"]

_CHUNK_Q = 1024


class Attention(nn.Module):
    """GQA projections, (d_in, d_out) weights used as ``x @ w``: wq
    (d, H dh), wk / wv (d, Hkv dh), wo (H dh, d)."""

    def __init__(self, cfg: ModelConfig, device=None, dtype=None):
        super().__init__()
        d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.dh
        shapes = {"wq": (d, h * dh), "wk": (d, hkv * dh),
                  "wv": (d, hkv * dh), "wo": (h * dh, d)}
        for name, shape in shapes.items():
            self.register_parameter(name, nn.Parameter(
                torch.empty(shape, device=device, dtype=dtype)))

    @torch.no_grad()
    def init_(self, gen: torch.Generator):
        """Each weight ~ truncated normal scaled by d_in ** -0.5 (the
        reference's ``dense_init``)."""
        for w in (self.wq, self.wk, self.wv, self.wo):
            w.copy_(trunc_normal(gen, w.shape, w.shape[0] ** -0.5, w.dtype))


def _xla_attention(q, k, v, *, causal, window, q_offset, scale,
                   chunk=_CHUNK_Q):
    """Query-chunked attention; masks computed per chunk. q_offset is the
    absolute position of q[0]."""
    b, h, sq, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = h // hkv
    kr = k.repeat_interleave(g, dim=1) if g > 1 else k
    vr = v.repeat_interleave(g, dim=1) if g > 1 else v
    kpos = torch.arange(skv, device=q.device)
    krf = kr.float().transpose(-1, -2)
    vrd = vr.to(q.dtype)
    chunk = min(chunk, sq)
    out = []
    for c0 in range(0, sq, chunk):
        qi = q[:, :, c0:c0 + chunk]
        qpos = q_offset + c0 + torch.arange(qi.shape[2], device=q.device)
        s = torch.matmul(qi.float(), krf) * scale
        mask = torch.ones((qi.shape[2], skv), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        if window:
            mask &= kpos[None, :] > qpos[:, None] - window
        s = torch.where(mask, s, float("-inf"))
        # softmax in float32, the probability panel in the model dtype
        p = torch.softmax(s, dim=-1).to(q.dtype)
        out.append(torch.matmul(p, vrd))
    return torch.cat(out, dim=2)


def _flash(q, k, v, *, causal, window):
    return flash_attention(q, k, v, causal=causal,
                           window=window if window else None)


def attention_core(cfg: ModelConfig, q, k, v, *, causal=True, q_offset=0,
                   scale=None):
    """q (B, H, Sq, dh), k / v (B, Hkv, Skv, dh) -> (B, H, Sq, dh). The
    kernel uses 1/sqrt(dh) whatever `scale` says, as the reference's."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if cfg.attn_impl == "flash" and q.shape[2] > 1:
        return _flash(q, k, v, causal=causal, window=cfg.window)
    return _xla_attention(q, k, v, causal=causal, window=cfg.window,
                          q_offset=q_offset, scale=scale)


def _split_heads(x, n, dh):
    b, s, _ = x.shape
    return x.reshape(b, s, n, dh).transpose(1, 2)            # (B, n, S, dh)


def _merge_heads(x):
    b, n, s, dh = x.shape
    return x.transpose(1, 2).reshape(b, s, n * dh)


def gqa_forward(cfg: ModelConfig, p: Attention, x, positions, *, causal=True):
    """x: (B, S, d) -> (out (B, S, d), (k, v)) with k, v (B, Hkv, S, dh)
    after RoPE, as the reference returns them to seed a cache."""
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.dh
    q = _split_heads(x @ p.wq, h, dh)
    k = _split_heads(x @ p.wk, hkv, dh)
    v = _split_heads(x @ p.wv, hkv, dh)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.rotary_pct)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.rotary_pct)
    o = attention_core(cfg, q, k, v, causal=causal)
    return _merge_heads(o) @ p.wo, (k, v)
