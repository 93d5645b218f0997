"""Serving: cache init, prefill and single-token decode for every family,
the port of ``repro.models.serve``.

Cache leaves (leading L = the layers, stacked as the reference stacks
them):

  dense / moe / vlm  k / v (L, B, Hkv, W, dh): W = min(window, max_len)
                     ring
  mla_moe            ckv (L, B, S, r_kv), kr (L, B, S, d_rope): the
                     latent cache, over all layers (the first_k_dense
                     layers' rows first)
  ssm                conv (L, B, K - 1, conv_dim), state (L, B, H, P, N),
                     float32 whatever the cache's dtype
  hybrid             the ssm leaves for every Mamba layer, and attn_k /
                     attn_v (apps, B, Hkv, W, dh): one ring per application
                     of the shared block
  encdec             the decoder's self k / v ring (L, B, H, W, dh) and
                     cross_k / cross_v (L, B, H, Se, dh), set by
                     ``prefill_encoder``

and ``"index"``, a 0-d int32 tensor: the number of tokens in context.

A cache is a dict of tensors on the model's device, and ``decode_step``
UPDATES IT IN PLACE: each leaf (the index too) is written where it lies
and the same dict is returned, where the reference returns a new pytree.
A full-width cache is gigabytes, and a copy per step would move it all.
So a caller that wants an earlier state keeps a clone. A step keeps the
index, the slots and the masks on the device and makes no host sync,
except the ragged MoE dispatch (``moe._moe_ragged``), whose group sizes
are read on the host.
"""
from __future__ import annotations

import torch

from ..core.index import resolve_device
from . import attention as A
from . import mamba2 as M2
from .config import ModelConfig
from .layers import embed_tokens, logits_out

__all__ = ["kv_width", "init_cache", "decode_step", "prefill_encoder",
           "prefill"]


def kv_width(cfg: ModelConfig, max_len: int) -> int:
    return min(cfg.window, max_len) if cfg.window else max_len


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, enc_len: int | None = None,
               device=None) -> dict:
    """The zero cache of `cfg` for `batch` sequences of up to `max_len`
    tokens, its attention leaves in `dtype` (the Mamba leaves float32),
    every leaf its own buffer. On the card unless `device` says otherwise;
    without a card this raises. encdec's cross k / v hold `enc_len` frames
    (1 when None) until ``prefill_encoder`` replaces them."""
    device = resolve_device(device)
    c = {"index": torch.zeros((), dtype=torch.int32, device=device)}
    w = kv_width(cfg, max_len)

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    f = cfg.family
    if f in ("dense", "moe", "vlm"):
        c["k"] = zeros(cfg.n_layers, batch, cfg.n_kv_heads, w, cfg.dh)
        c["v"] = zeros(cfg.n_layers, batch, cfg.n_kv_heads, w, cfg.dh)
    elif f == "mla_moe":
        c["ckv"] = zeros(cfg.n_layers, batch, max_len, cfg.kv_lora_rank)
        c["kr"] = zeros(cfg.n_layers, batch, max_len, cfg.qk_rope_dim)
    elif f in ("ssm", "hybrid"):
        # the reference broadcasts one layer's cache over the layers; here
        # each layer has its own rows, so a step writes one layer's alone
        mc = M2.init_mamba_cache(cfg, batch, device=device)
        for name, a in mc.items():
            c[name] = a[None].repeat((cfg.n_layers,) + (1,) * a.dim())
        if f == "hybrid":
            apps = cfg.n_layers // cfg.attn_every
            c["attn_k"] = zeros(apps, batch, cfg.n_kv_heads, w, cfg.dh)
            c["attn_v"] = zeros(apps, batch, cfg.n_kv_heads, w, cfg.dh)
    elif f == "encdec":
        c["k"] = zeros(cfg.n_layers, batch, cfg.n_heads, w, cfg.dh)
        c["v"] = zeros(cfg.n_layers, batch, cfg.n_heads, w, cfg.dh)
        el = enc_len if enc_len is not None else 1
        c["cross_k"] = zeros(cfg.n_layers, batch, cfg.n_heads, el, cfg.dh)
        c["cross_v"] = zeros(cfg.n_layers, batch, cfg.n_heads, el, cfg.dh)
    else:
        raise ValueError(f"{cfg.name}: unknown family {f!r}")
    return c


def _attn_decode(blk, x, ck, cv, index):
    """A DenseBlock / MoEBlock's step: its attention over layer caches ck,
    cv (GQA ring or MLA latent), then its FFN."""
    xn = blk.ln1(x)
    step = A.mla_decode if blk.cfg.mla else A.gqa_decode
    h, _, _ = step(blk.cfg, blk.attn, xn, ck, cv, index)
    x, _ = blk.ffn(x + h)
    return x


def _mamba_decode(blk, x, cache, i):
    h, _ = M2.mamba_decode(blk.cfg, blk.mamba, blk.ln(x),
                           {"conv": cache["conv"][i],
                            "state": cache["state"][i]})
    return x + h


def decode_step(model, cache: dict, tokens):
    """tokens: (B, 1) -> (logits (B, 1, vocab), cache), the cache written
    in place (see the module) and ``cache["index"]`` advanced by one."""
    cfg: ModelConfig = model.cfg
    x = embed_tokens(model.embed.table, tokens)
    index = cache["index"]
    f = cfg.family
    if f in ("dense", "moe", "vlm", "mla_moe"):
        kk, vv = ("ckv", "kr") if f == "mla_moe" else ("k", "v")
        blocks = list(getattr(model, "dense_layers", ())) + list(model.layers)
        for i, blk in enumerate(blocks):
            x = _attn_decode(blk, x, cache[kk][i], cache[vv][i], index)
    elif f in ("ssm", "hybrid"):
        for i, blk in enumerate(model.layers):
            x = _mamba_decode(blk, x, cache, i)
            if f == "hybrid" and (i + 1) % cfg.attn_every == 0:
                app = (i + 1) // cfg.attn_every - 1
                x = _attn_decode(model.shared_attn, x, cache["attn_k"][app],
                                 cache["attn_v"][app], index)
    else:                                                     # encdec
        for i, blk in enumerate(model.layers):
            h, _, _ = A.gqa_decode(cfg, blk.attn, blk.ln1(x), cache["k"][i],
                                   cache["v"][i], index)
            x = x + h
            x = x + A.cross_attn_decode(cfg, blk.xattn, blk.lnx(x),
                                        cache["cross_k"][i],
                                        cache["cross_v"][i])
            x = x + blk.mlp(blk.ln2(x))
    x = model.final_norm(x)
    logits = logits_out(model.embed.table, x)
    index.add_(1)
    return logits, cache


def prefill_encoder(model, cache: dict, src_embeds) -> dict:
    """encdec: run the encoder over (B, Se, d) frame embeddings, taken in
    the model's dtype as the forward takes them, and set each decoder
    layer's cross k / v (L, B, H, Se, dh) in `cache` (returned)."""
    enc = model.encode(src_embeds.to(model.embed.table.dtype))
    kv = [A.cross_kv(model.cfg, blk.xattn, enc) for blk in model.layers]
    cache["cross_k"] = torch.stack([k for k, _ in kv])
    cache["cross_v"] = torch.stack([v for _, v in kv])
    return cache


def prefill(model, cache: dict, tokens):
    """Sequential prefill: one ``decode_step`` per token of (B, S)
    `tokens`, as the reference's scan of decode steps (exact; O(S) steps;
    the batched route is not built there either). Returns (cache, logits
    (B, S, vocab))."""
    logits = []
    for i in range(tokens.shape[1]):
        lg, cache = decode_step(model, cache, tokens[:, i:i + 1])
        logits.append(lg[:, 0])
    return cache, torch.stack(logits, dim=1)
