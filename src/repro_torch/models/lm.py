"""The LM: the dense family's model assembly, the port of
``repro.models.lm``'s ``init_dense_block`` / ``apply_block`` /
``init_params`` / ``forward`` for ``family == "dense"`` (TinyLlama,
Phi-3, StarCoder2, ChatGLM3).

``LM`` is an ``nn.Module`` of ``DenseBlock``s (pre-norm GQA attention and
an MLP) in an ``nn.ModuleList``; the reference's ``lax.scan`` over
stacked layers is a loop. Weights keep the reference's layout, (d_in,
d_out) used as ``x @ w``, so ``convert.lm_from_numpy`` copies the JAX
parameter tree leaf for leaf; norm parameters are float32, the rest in
``cfg.dtype``. The other families raise ``NotImplementedError`` naming
what they wait for (ROADMAP Queue 1, the LM substrate).
"""
from __future__ import annotations

import torch
from torch import nn

from ..core.index import resolve_device
from . import attention as A
from .config import ModelConfig
from .layers import (apply_mlp, apply_norm, embed_tokens, logits_out,
                     trunc_normal)

__all__ = ["LM", "DenseBlock", "Norm", "MLP"]

#: what each family that does not run yet waits for (ROADMAP Queue 1,
#: the LM substrate)
_WAITING = {
    "moe": "moe.py (the MoE layer and its router)",
    "mla_moe": "MLA in attention.py and moe.py",
    "ssm": "mamba2.py (the SSD layer)",
    "hybrid": "mamba2.py and the hybrid family's shared attention block",
    "encdec": "the encoder-decoder family (cross-attention)",
    "vlm": "the VLM family (patch projection)",
}


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


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


class DenseBlock(nn.Module):
    """Pre-norm block: x + attn(ln1(x)), then + mlp(ln2(x))."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dt = _dtype(cfg)
        self.ln1 = Norm(cfg.d_model, cfg.norm, device)
        self.attn = A.Attention(cfg, device, dt)
        self.ln2 = Norm(cfg.d_model, cfg.norm, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.mlp, device, dt)

    def forward(self, x, positions, *, causal=True):
        h, _ = A.gqa_forward(self.cfg, self.attn, self.ln1(x), positions,
                             causal=causal)
        x = x + h
        return x + self.mlp(self.ln2(x))


class LM(nn.Module):
    """The dense LM: embedding, ``cfg.n_layers`` blocks, final norm, tied
    logits. ``LM(cfg, device)`` allocates the parameters uninitialised;
    ``LM.from_config`` draws them from a seed.

    ``forward(tokens)`` takes (B, S) int64 tokens and returns (logits (B,
    S, vocab) in ``cfg.dtype``, aux), aux a float32 zero as the reference
    returns for the dense family. With ``attn_impl="flash"`` the attention
    runs the CUDA kernel, which is forward-only: call it under
    ``torch.inference_mode()`` (or ``no_grad``) on the card.
    ``cfg.remat`` (the reference's per-layer activation checkpointing)
    has no effect on a forward pass under ``torch.inference_mode()``: no
    activation is kept for a backward pass there.
    """

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        if cfg.family != "dense" or cfg.mla or cfg.is_moe:
            raise NotImplementedError(
                f"{cfg.name}: family {cfg.family!r} is not ported yet; the "
                f"port runs the dense family, and {cfg.family!r} waits for "
                f"{_WAITING.get(cfg.family, 'its modules')} (ROADMAP Queue 1, "
                f"the LM substrate)")
        device = resolve_device(device)
        self.cfg = cfg
        self.embed = nn.Module()
        self.embed.table = nn.Parameter(torch.empty(
            (cfg.vocab, cfg.d_model), device=device, dtype=_dtype(cfg)))
        self.layers = nn.ModuleList(DenseBlock(cfg, device)
                                    for _ in range(cfg.n_layers))
        self.final_norm = Norm(cfg.d_model, cfg.norm, device)

    @classmethod
    def from_config(cls, cfg: ModelConfig, seed: int = 0, device=None) -> "LM":
        """An LM with weights drawn from `seed` by a ``torch.Generator`` on
        the target device: truncated normals scaled by d_in ** -0.5 (the
        embedding by 1), norms at one and zero. The card unless `device`
        says otherwise; without a card this raises."""
        model = cls(cfg, device)
        gen = torch.Generator(device=model.embed.table.device)
        gen.manual_seed(seed)
        with torch.no_grad():
            t = model.embed.table
            t.copy_(trunc_normal(gen, t.shape, 1.0, t.dtype))
            for blk in model.layers:
                blk.attn.init_(gen)
                blk.mlp.init_(gen)
        return model

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    def forward(self, tokens):
        x = embed_tokens(self.embed.table, tokens)
        positions = torch.arange(x.shape[1], device=x.device)
        for blk in self.layers:
            x = blk(x, positions)
        x = self.final_norm(x)
        return (logits_out(self.embed.table, x),
                torch.zeros((), dtype=torch.float32, device=x.device))
