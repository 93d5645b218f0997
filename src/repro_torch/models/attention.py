"""Attention of the LM: the port of ``repro.models.attention``. GQA (with
a sliding window), MLA and cross-attention, each with its full-sequence
forward, and the one-token decode steps over the serving caches.

Two implementations of the full-sequence core (``cfg.attn_impl``), routed
as the reference routes them:
  * "xla"   query-chunked attention in plain PyTorch: float32 scores and
            softmax per chunk of 1024 queries, the probabilities cast to
            the model dtype before P.V, as the reference does;
  * "flash" the CUDA kernel (``kernels.ops.flash_attention``), taken only
            when there is more than one query row (Sq > 1): bf16 and fp16
            on the tensor cores, which also round p to the model dtype
            before P.V (against their own running max, per 128-key
            tile), float32 on the CUDA cores. The kernel takes q, k and v
            of one head width; MLA's q / k (qk_nope + qk_rope) and v
            (v_head) differ, and there ``attention_core`` raises a
            ValueError naming both (the reference's Pallas route fails
            there too, in ``dot_general``).

The decode steps (``gqa_decode``, ``mla_decode``) are plain PyTorch, as
the reference's are einsums: one query row never reaches the kernel.
They write the new token's key and value into the cache in place and
keep the index, the slots and the masks on the device (no host sync).
"""
from __future__ import annotations

import torch
from torch import nn
from torch.distributed.tensor import DTensor

from ..kernels.ops import flash_attention
from .config import ModelConfig
from .layers import (apply_rope, hold_gradient, local_offset, shard,
                     sharding_mesh, trunc_normal)

__all__ = ["Attention", "MLAAttention", "attention_core", "gqa_forward",
           "gqa_decode", "mla_forward", "mla_decode", "cross_kv",
           "cross_attn_forward", "cross_attn_decode"]

_CHUNK_Q = 1024


class _Projections(nn.Module):
    """(d_in, d_out) weights used as ``x @ w``, each drawn as the
    reference's ``dense_init``: a truncated normal scaled by d_in ** -0.5."""

    def __init__(self, shapes: dict, device=None, dtype=None):
        super().__init__()
        for name, shape in shapes.items():
            self.register_parameter(name, nn.Parameter(
                torch.empty(shape, device=device, dtype=dtype)))

    @torch.no_grad()
    def init_(self, gen: torch.Generator):
        for w in self.parameters():
            w.copy_(trunc_normal(gen, w.shape, w.shape[0] ** -0.5, w.dtype))


class Attention(_Projections):
    """GQA projections: wq (d, H dh), wk / wv (d, n_kv dh), wo (H dh, d).
    `n_kv` defaults to ``cfg.n_kv_heads``; cross-attention takes
    ``cfg.n_heads`` (the reference's ``init_cross_attn``)."""

    def __init__(self, cfg: ModelConfig, device=None, dtype=None,
                 n_kv: int | None = None):
        d, h, dh = cfg.d_model, cfg.n_heads, cfg.dh
        hkv = cfg.n_kv_heads if n_kv is None else n_kv
        super().__init__({"wq": (d, h * dh), "wk": (d, hkv * dh),
                          "wv": (d, hkv * dh), "wo": (h * dh, d)},
                         device, dtype)


class MLAAttention(_Projections):
    """MLA projections (DeepSeek-V3): w_dq (d, r_q), w_uq (r_q, H (dn +
    dr)), w_dkv (d, r_kv), w_kr (d, dr), w_uk (r_kv, H dn), w_uv (r_kv, H
    dv), wo (H dv, d)."""

    def __init__(self, cfg: ModelConfig, device=None, dtype=None):
        d, h = cfg.d_model, cfg.n_heads
        qk = cfg.qk_nope_dim + cfg.qk_rope_dim
        r_kv = cfg.kv_lora_rank
        super().__init__({
            "w_dq": (d, cfg.q_lora_rank), "w_uq": (cfg.q_lora_rank, h * qk),
            "w_dkv": (d, r_kv), "w_kr": (d, cfg.qk_rope_dim),
            "w_uk": (r_kv, h * cfg.qk_nope_dim),
            "w_uv": (r_kv, h * cfg.v_head_dim),
            "wo": (h * cfg.v_head_dim, d)}, device, dtype)


# ---------------------------------------------------------------------------
# core attention math (q: (B, H, Sq, dh); k / v: (B, Hkv, Skv, dh))
# ---------------------------------------------------------------------------

def _xla_attention(q, k, v, *, causal, window, q_offset, scale,
                   chunk=_CHUNK_Q):
    """Query-chunked attention; masks computed per chunk. q_offset is the
    absolute position of q[0]. v may be narrower than q and k (MLA)."""
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
    if not q.shape[-1] == k.shape[-1] == v.shape[-1]:
        raise ValueError(
            f"attn_impl='flash': the kernel takes q, k and v of one head "
            f"width; got q / k {q.shape[-1]} and v {v.shape[-1]} (MLA's "
            f"qk_nope + qk_rope and v_head); use attn_impl='xla'")
    return flash_attention(q, k, v, causal=causal,
                           window=window if window else None)


def _core(cfg: ModelConfig, q, k, v, *, causal, q_offset, scale):
    if cfg.attn_impl == "flash" and q.shape[2] > 1:
        return _flash(q, k, v, causal=causal, window=cfg.window)
    return _xla_attention(q, k, v, causal=causal, window=cfg.window,
                          q_offset=q_offset, scale=scale)


def _local_kv(ql, kl, vl, q0: int, k0: int, group: int):
    """The kv heads this rank's query heads read: query head j (global q0
    + j) reads kv head (q0 + j) // group (global; local minus k0). A run
    that GQA's own grouping reads is sliced; any other mapping (a rank's
    query heads straddling groups unevenly) takes one kv head a query
    head."""
    hl = ql.shape[1]
    idx = [(q0 + j) // group - k0 for j in range(hl)]
    lo, n = idx[0], idx[-1] - idx[0] + 1
    if hl % n == 0 and idx == [lo + j // (hl // n) for j in range(hl)]:
        return kl[:, lo:lo + n], vl[:, lo:lo + n]
    sel = torch.tensor(idx, dtype=torch.long, device=kl.device)
    return kl.index_select(1, sel), vl.index_select(1, sel)


def attention_core(cfg: ModelConfig, q, k, v, *, causal=True, q_offset=0,
                   scale=None):
    """q (B, H, Sq, dh), k (B, Hkv, Skv, dh), v (B, Hkv, Skv, dv) -> (B,
    H, Sq, dv). The kernel uses 1/sqrt(dh) whatever `scale` says, as the
    reference's.

    Under a mesh (DTensors), each rank runs the core on its own heads
    through ``local_map``, at the placements its inputs have (the heads on
    "model" where the rules shard them): the flash kernel takes plain
    tensors, and the chunked path's masks are made per rank. Where the
    query heads shard and the kv heads replicate (chatglm3's 2 and
    starcoder2's 4 on a 16-wide axis), rank r's query head j reads kv
    head (r Hq/m + j) // (Hq/Hkv); the gradient of a replicated kv
    tensor is then a partial sum over "model"."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    mesh = sharding_mesh()
    if mesh is None or not isinstance(q, DTensor):
        return _core(cfg, q, k, v, causal=causal, q_offset=q_offset,
                     scale=scale)
    from torch.distributed.tensor import Partial, Shard
    from torch.distributed.tensor.experimental import local_map
    # local_map infers the output's shape from even shards
    q = _whole_heads(q, 1, q.shape[1])
    q0, k0 = local_offset(q, mesh, 1), local_offset(k, mesh, 1)
    group = q.shape[1] // k.shape[1]

    def local(ql, kl, vl):
        kl, vl = _local_kv(ql, kl, vl, q0, k0, group)
        return _core(cfg, ql, kl, vl, causal=causal, q_offset=q_offset,
                     scale=scale)

    def grad_of(t):
        # a kv tensor whole on a mesh dim where the query heads split:
        # each rank's gradient is its own query heads' share
        return [Partial() if qp == Shard(1) and tp != Shard(1) else tp
                for qp, tp in zip(q.placements, t.placements)]

    return local_map(local, out_placements=list(q.placements),
                     in_placements=(q.placements, k.placements, v.placements),
                     in_grad_placements=(q.placements, grad_of(k), grad_of(v)),
                     device_mesh=mesh)(q, k, v)


def _plain(t):
    """A replicated DTensor's value as the plain tensor every rank holds."""
    return t.to_local() if isinstance(t, DTensor) else t


def _split_heads(x, n, dh):
    b, s, _ = x.shape
    whole = _whole_heads(x, 2, n)
    out = whole.reshape(b, s, n, dh).transpose(1, 2)
    return out if whole is x else hold_gradient(out)


def _merge_heads(x):
    b, n, s, dh = x.shape
    whole = _whole_heads(x, 1, n)
    out = whole.transpose(1, 2).reshape(b, s, n * dh)
    return out if whole is x else hold_gradient(out)


def _whole_heads(x, dim: int, n: int):
    """`x`, a DTensor whose `dim` holds `n` heads (or n heads' columns),
    gathered along `dim` where its mesh axes do not split the n heads
    evenly: DTensor's view ops reshape only even splits (the callers hold
    the reshaped result's gradient whole too, for the view's backward).
    Where the
    kv projection's columns divide and its heads do not (chatglm3's 2
    kv heads over a 16-wide "model" axis) the rules then replicate the
    heads, as the reference's partitioner does; where the query heads do
    not divide (starcoder2's 36 over 16, which the reference pads) the
    merged output is gathered. Anything else is `x`."""
    if not isinstance(x, DTensor):
        return x
    from torch.distributed.tensor import Replicate
    split = [i for i, p in enumerate(x.placements) if p.is_shard(dim)]
    ways = 1
    for i in split:
        ways *= x.device_mesh.size(i)
    if n % ways == 0:
        return x
    return x.redistribute(x.device_mesh, [
        Replicate() if i in split else p for i, p in enumerate(x.placements)])


# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------

def gqa_forward(cfg: ModelConfig, p: Attention, x, positions, *, causal=True):
    """x: (B, S, d) -> (out (B, S, d), (k, v)) with k, v (B, Hkv, S, dh)
    after RoPE, as the reference returns them to seed a cache."""
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.dh
    q = shard(_split_heads(x @ p.wq, h, dh), "batch", "heads", None, None)
    k = shard(_split_heads(x @ p.wk, hkv, dh), "batch", "kv_heads", None,
              None)
    v = shard(_split_heads(x @ p.wv, hkv, dh), "batch", "kv_heads", None,
              None)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.rotary_pct)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.rotary_pct)
    o = shard(attention_core(cfg, q, k, v, causal=causal), "batch", "heads",
              None, None)
    return _merge_heads(o) @ p.wo, (k, v)


def _cached_attention(q, ck, cv, mask, scale, dtype, over=()):
    """One query row against a cache: q (B, H, 1, dh), ck / cv (B, Hkv, W,
    dh), mask (W,) or None (every key) -> (B, H, 1, dh) in `dtype`.
    float32 scores, softmax and P.V, as the reference's decode einsums;
    the H / Hkv query heads of a KV head share its rows through a group
    axis instead of a repeated copy of the cache.

    `over`: the process groups across which the cache's length is split
    (a mesh's sequence-parallel cache, each rank's rows here): each rank's
    softmax statistics and P.V are combined by all-reduces (max, then
    sums), flash-decoding's merge."""
    b, h, _, dh = q.shape
    hkv = ck.shape[1]
    qg = q.float().reshape(b, hkv, h // hkv, dh)
    s = torch.matmul(qg, ck.float().transpose(-1, -2)) * scale  # (B,Hkv,g,W)
    if mask is not None:
        s = torch.where(mask, s, float("-inf"))
    if not over:
        o = torch.matmul(torch.softmax(s, dim=-1), cv.float())
        return o.reshape(b, h, 1, cv.shape[-1]).to(dtype)
    from torch.distributed import _functional_collectives as funcol
    m_own = s.amax(-1, keepdim=True)
    m = m_own
    for g in over:
        m = funcol.wait_tensor(funcol.all_reduce(m, "max", g))
    seen = torch.isfinite(m_own)
    pr = torch.exp(s - torch.where(seen, m_own, 0.0))
    scale_own = torch.where(seen, torch.exp(m_own - m), 0.0)
    num = torch.matmul(pr, cv.float()) * scale_own
    den = pr.sum(-1, keepdim=True) * scale_own
    for g in over:
        num = funcol.wait_tensor(funcol.all_reduce(num, "sum", g))
        den = funcol.wait_tensor(funcol.all_reduce(den, "sum", g))
    return (num / den).reshape(b, h, 1, cv.shape[-1]).to(dtype)


def _sharded_decode(q, ck, cv, mask, scale, dtype, new=None, slot=None):
    """``_cached_attention`` under a mesh, as ``local_map`` (optionally
    writing the new token's `new` = (k, v) at `slot` first): the query
    follows the cache's batch and head split (it is one row: gathering
    its heads is cheap), and where the cache's length is split (few kv
    heads: the reference's sequence-parallel cache) each rank writes the
    slot if it holds it and attends over its own rows, the partial
    softmaxes merged over those mesh dims."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = sharding_mesh()
    kvp = list(ck.placements)
    qp = [p if p.is_shard() and p.dim in (0, 1) else Replicate() for p in kvp]
    newp = [Replicate() if p.is_shard() and p.dim == 2 else p for p in kvp]
    over = [mesh.get_group(i) for i, p in enumerate(kvp)
            if p.is_shard() and p.dim == 2]
    w0 = local_offset(ck, mesh, 2)
    q = q.redistribute(mesh, qp)

    def attend(ql, ckl, cvl, *kv):
        wl = ckl.shape[2]
        if kv:
            at = slot - w0
            mine = (at >= 0) & (at < wl)
            at = torch.clamp(at, 0, wl - 1).reshape(1).long()
            for cache, t in zip((ckl, cvl), kv):
                t = torch.where(mine, t.to(cache.dtype),
                                cache.index_select(2, at))
                cache.index_copy_(2, at, t)
        m = None if mask is None else mask[w0:w0 + wl]
        return _cached_attention(ql, ckl, cvl, m, scale, dtype, over)

    args = (q, ck, cv)
    in_pl = (qp, kvp, kvp)
    if new is not None:
        args += tuple(t.redistribute(mesh, newp) for t in new)
        in_pl += (newp, newp)
    return local_map(attend, out_placements=qp, in_placements=in_pl,
                     device_mesh=mesh)(*args)


def gqa_decode(cfg: ModelConfig, p: Attention, x, cache_k, cache_v, index):
    """One-token decode with a RING KV cache, updated in place.

    x: (B, 1, d); cache_k / cache_v: (B, Hkv, W, dh), where W may be
    smaller than the context (sliding-window configurations keep W =
    window); index: the 0-d int32 tensor of tokens already in context.
    The new entry is written at slot ``index % W``; slot s holds the token
    at absolute position ``index - ((index - s) mod W)`` (negative:
    empty), which gives both the validity and the window mask. Keys carry
    RoPE at their absolute positions, so relative phases survive the
    wraparound. Returns (out (B, 1, d), cache_k, cache_v), the caches
    being the arguments, written."""
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.dh
    q = _split_heads(x @ p.wq, h, dh)
    k = _split_heads(x @ p.wk, hkv, dh)
    v = _split_heads(x @ p.wv, hkv, dh)
    pos = index.reshape(1)
    q = apply_rope(q, pos, cfg.rope_theta, cfg.rotary_pct)
    k = apply_rope(k, pos, cfg.rope_theta, cfg.rotary_pct)
    w = cache_k.shape[2]
    kpos = index - torch.remainder(
        index - torch.arange(w, device=x.device), w)          # absolute pos
    mask = kpos >= 0
    if cfg.window:
        mask &= kpos > index - cfg.window
    if isinstance(cache_k, DTensor):
        o = _sharded_decode(q, cache_k, cache_v, _plain(mask), dh ** -0.5,
                            x.dtype, new=(k, v), slot=_plain(index % w))
        return _merge_heads(o) @ p.wo, cache_k, cache_v
    slot = (index % w).reshape(1).long()
    cache_k.index_copy_(2, slot, k.to(cache_k.dtype))
    cache_v.index_copy_(2, slot, v.to(cache_v.dtype))
    o = _cached_attention(q, cache_k, cache_v, mask, dh ** -0.5, x.dtype)
    return _merge_heads(o) @ p.wo, cache_k, cache_v


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V3)
# ---------------------------------------------------------------------------

def mla_forward(cfg: ModelConfig, p: MLAAttention, x, positions, *,
                causal=True):
    """Full-sequence MLA. Returns (out, (c_kv, k_rope)) for cache seeding."""
    b, s, _ = x.shape
    h = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    q = ((x @ p.w_dq) @ p.w_uq).reshape(b, s, h, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope.transpose(1, 2), positions, cfg.rope_theta)
    c_kv = shard(x @ p.w_dkv, "batch", None, None)          # (B, S, r_kv)
    k_rope = apply_rope(x @ p.w_kr, positions, cfg.rope_theta)  # (B, S, dr)
    k_nope = (c_kv @ p.w_uk).reshape(b, s, h, dn)
    v = (c_kv @ p.w_uv).reshape(b, s, h, dv)
    qq = torch.cat([q_nope.transpose(1, 2), q_rope], dim=-1)
    kk = torch.cat([k_nope.transpose(1, 2),
                    k_rope[:, None].expand(b, h, s, dr)], dim=-1)
    qq = shard(qq, "batch", "heads", None, None)
    kk = shard(kk, "batch", "heads", None, None)
    o = attention_core(cfg, qq, kk, v.transpose(1, 2), causal=causal,
                       scale=(dn + dr) ** -0.5)
    return _merge_heads(o) @ p.wo, (c_kv, k_rope)


def mla_decode(cfg: ModelConfig, p: MLAAttention, x, cache_ckv, cache_kr,
               index):
    """Latent-space decode, the caches updated in place: scores against
    the compressed cache (W_UK absorbed into q, W_UV into the output), in
    float32. cache_ckv (B, S, r_kv), cache_kr (B, S, dr). The cache is not
    a ring: the new entry goes to row ``min(index, S - 1)`` (the
    reference's ``dynamic_update_slice`` clamps its start, so an index at
    or past S overwrites the last row), and row j is visible when j <=
    index. Returns (out (B, 1, d), cache_ckv, cache_kr)."""
    b = x.shape[0]
    h = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    rkv = cfg.kv_lora_rank
    q = ((x @ p.w_dq) @ p.w_uq).reshape(b, 1, h, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    pos = index.reshape(1)
    q_rope = apply_rope(q_rope.transpose(1, 2), pos, cfg.rope_theta)
    c_new = x @ p.w_dkv                                      # (B, 1, r_kv)
    kr_new = apply_rope(x @ p.w_kr, pos, cfg.rope_theta)     # (B, 1, dr)
    s_max = cache_ckv.shape[1]
    row = torch.clamp(index, max=s_max - 1).reshape(1).long()
    cache_ckv.index_copy_(1, row, c_new.to(cache_ckv.dtype))
    cache_kr.index_copy_(1, row, kr_new.to(cache_kr.dtype))

    ckv = cache_ckv.float()
    w_uk = p.w_uk.float().reshape(rkv, h, dn)
    q_abs = torch.einsum("bhd,khd->bhk", q_nope[:, 0].float(), w_uk)
    s_lat = torch.einsum("bhk,bsk->bhs", q_abs, ckv)
    s_rope = torch.einsum("bhd,bsd->bhs", q_rope[:, :, 0].float(),
                          cache_kr.float())
    s = (s_lat + s_rope) * ((dn + dr) ** -0.5)
    mask = torch.arange(s_max, device=x.device) <= index
    s = torch.where(mask, s, float("-inf"))
    ctx = torch.einsum("bhs,bsk->bhk", torch.softmax(s, dim=-1), ckv)
    w_uv = p.w_uv.float().reshape(rkv, h, dv)
    o = torch.einsum("bhk,khd->bhd", ctx, w_uv)
    o = o.reshape(b, 1, h * dv).to(x.dtype)
    return o @ p.wo, cache_ckv, cache_kr


# ---------------------------------------------------------------------------
# cross attention (enc-dec)
# ---------------------------------------------------------------------------

def cross_kv(cfg: ModelConfig, p: Attention, enc_out):
    """The cross-attention keys and values of `enc_out`, (B, H, Se, dh)
    each, without RoPE (what ``prefill_encoder`` caches)."""
    h, dh = cfg.n_heads, cfg.dh
    return (_split_heads(enc_out @ p.wk, h, dh),
            _split_heads(enc_out @ p.wv, h, dh))


def cross_attn_forward(cfg: ModelConfig, p: Attention, x, enc_out):
    """Non-causal attention of x (B, S, d) over enc_out (B, Se, d)."""
    q = _split_heads(x @ p.wq, cfg.n_heads, cfg.dh)
    k, v = cross_kv(cfg, p, enc_out)
    o = attention_core(cfg, q, k, v, causal=False)
    return _merge_heads(o) @ p.wo


def cross_attn_decode(cfg: ModelConfig, p: Attention, x, cross_k, cross_v):
    """One query row against the precomputed cross k / v (B, H, Se, dh),
    float32 scores and softmax (the reference's ``_decode_encdec``)."""
    q = _split_heads(x @ p.wq, cfg.n_heads, cfg.dh)
    if isinstance(cross_k, DTensor):
        o = _sharded_decode(q, cross_k, cross_v, None, cfg.dh ** -0.5,
                            x.dtype)
    else:
        o = _cached_attention(q, cross_k, cross_v, None, cfg.dh ** -0.5,
                              x.dtype)
    return _merge_heads(o) @ p.wo
