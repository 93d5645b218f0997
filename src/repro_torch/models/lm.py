"""The LM: model assembly for every family, the port of
``repro.models.lm``'s blocks, ``init_params`` and ``forward``.

Families:
  dense    [tinyllama, phi3, starcoder2, chatglm3] pre-norm GQA + MLP
  moe      [mixtral] GQA (+ sliding window) + top-k MoE
  mla_moe  [deepseek-v3] MLA + (first_k_dense dense layers, the rest MoE);
           the multi-token-prediction module is held (``mtp``) for the
           loss, which no forward uses
  ssm      [mamba2] SSD layers, attention-free
  hybrid   [zamba2] Mamba backbone + one SHARED attention + MLP block
           applied after every ``attn_every`` Mamba layers
  encdec   [seamless] non-causal encoder over given frame embeddings +
           causal decoder with cross-attention
  vlm      [llava-next] projected patch embeddings prepended to the tokens

``LM`` is an ``nn.Module`` with one module per block kind
(``DenseBlock``, ``MoEBlock``, ``MambaBlock``, ``XAttnBlock``) in
``nn.ModuleList``s; the reference's ``lax.scan`` over stacked layers is a
loop. Every parameter sits at the reference's path (``layers.3.attn.wq``
for ``layers/attn/wq[3]``), in the reference's layout ((d_in, d_out) used
as ``x @ w``) and dtype (norms, the router and Mamba's a_log / dt_bias /
d_skip / norm_scale float32, the rest ``cfg.dtype``), so
``convert.lm_from_numpy`` copies the JAX tree leaf for leaf.
``models.serve`` runs the same modules one token at a time.

Training: ``loss_fn`` (the token cross-entropy, the MoE router's loss
and DeepSeek's depth-1 multi-token-prediction loss, ``_mtp_loss``) and
per-layer activation checkpointing under ``cfg.remat`` (``_remat``:
``torch.utils.checkpoint`` wherever the reference wraps a layer in
``jax.checkpoint``), taken only while a gradient is being recorded.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.index import resolve_device
from . import attention as A
from . import mamba2 as M2
from . import moe as MOE
from .config import ModelConfig
from .layers import (MLP, Norm, cross_entropy, embed_tokens, logits_out,
                     shard, trunc_normal)

__all__ = ["LM", "DenseBlock", "MoEBlock", "MambaBlock", "XAttnBlock",
           "Norm", "MLP", "loss_fn"]


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _remat(cfg: ModelConfig, block, *args, **kw):
    """block(*args, **kw), its activations recomputed in the backward pass
    (``torch.utils.checkpoint``, non-reentrant) when ``cfg.remat`` and a
    gradient is being recorded; a plain call otherwise. The forward draws
    no random numbers, so no RNG state is saved."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(block, *args, use_reentrant=False,
                          preserve_rng_state=False, **kw)
    return block(*args, **kw)


def dense_cfg(cfg: ModelConfig) -> ModelConfig:
    """The configuration of DeepSeek's first_k_dense layers and MTP block
    (the reference's ``dataclass_replace(cfg, n_experts=0)``)."""
    return dataclasses.replace(cfg, n_experts=0)


class DenseBlock(nn.Module):
    """Pre-norm block: x + attn(ln1(x)), then + mlp(ln2(x)). The attention
    is MLA when ``cfg.mla``, else GQA."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dt = _dtype(cfg)
        self.ln1 = Norm(cfg.d_model, cfg.norm, device)
        self.attn = (A.MLAAttention if cfg.mla else A.Attention)(
            cfg, device, dt)
        self.ln2 = Norm(cfg.d_model, cfg.norm, device)
        self._ffn(cfg, device, dt)

    def _ffn(self, cfg, device, dt):
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.mlp, device, dt)

    def init_(self, gen: torch.Generator):
        self.attn.init_(gen)
        self.mlp.init_(gen)

    def ffn(self, x):
        """x + the FFN of ln2(x); returns (x, aux float32 or None)."""
        return x + self.mlp(self.ln2(x)), None

    def forward(self, x, positions, *, causal=True):
        """Returns (x, aux): aux the MoE router's loss, None for an MLP."""
        fn = A.mla_forward if self.cfg.mla else A.gqa_forward
        h, _ = fn(self.cfg, self.attn, self.ln1(x), positions, causal=causal)
        x, aux = self.ffn(shard(x + h, "batch", None, None))
        return shard(x, "batch", None, None), aux


class MoEBlock(DenseBlock):
    """A DenseBlock whose FFN is ``moe.MoE``."""

    def _ffn(self, cfg, device, dt):
        self.moe = MOE.MoE(cfg, device, dt)

    def init_(self, gen: torch.Generator):
        self.attn.init_(gen)
        self.moe.init_(gen)

    def ffn(self, x):
        h, aux = MOE.moe_forward(self.cfg, self.moe, self.ln2(x))
        return x + h, aux


class MambaBlock(nn.Module):
    """x + mamba(ln(x))."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.ln = Norm(cfg.d_model, cfg.norm, device)
        self.mamba = M2.Mamba(cfg, device, _dtype(cfg))

    def forward(self, x):
        return shard(x + M2.mamba_forward(self.cfg, self.mamba, self.ln(x)),
                     "batch", None, None)


class XAttnBlock(nn.Module):
    """The decoder block of encdec: causal self-attention, cross-attention
    over the encoder's output, MLP; each pre-norm."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dt = _dtype(cfg)
        self.ln1 = Norm(cfg.d_model, cfg.norm, device)
        self.attn = A.Attention(cfg, device, dt)
        self.lnx = Norm(cfg.d_model, cfg.norm, device)
        self.xattn = A.Attention(cfg, device, dt, n_kv=cfg.n_heads)
        self.ln2 = Norm(cfg.d_model, cfg.norm, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.mlp, device, dt)

    def init_(self, gen: torch.Generator):
        for m in (self.attn, self.xattn, self.mlp):
            m.init_(gen)

    def forward(self, x, positions, enc_out):
        h, _ = A.gqa_forward(self.cfg, self.attn, self.ln1(x), positions)
        x = x + h
        x = x + A.cross_attn_forward(self.cfg, self.xattn, self.lnx(x),
                                     enc_out)
        return shard(x + self.mlp(self.ln2(x)), "batch", None, None)


class LM(nn.Module):
    """The LM of any family: embedding, the family's blocks, final norm,
    tied logits. ``LM(cfg, device)`` allocates the parameters
    uninitialised; ``LM.from_config`` draws them from a seed.

    ``forward(tokens, patch_embeds=None, src_embeds=None)`` takes (B, S)
    int64 tokens (and, for vlm, (B, P, d) patch embeddings; for encdec,
    (B, Se, d) frame embeddings) and returns (logits (B, S, vocab) in
    ``cfg.dtype``, aux), aux the float32 sum of the MoE layers' router
    losses (zero without MoE), as the reference returns them. With
    ``attn_impl="flash"`` the attention runs the CUDA kernel, which is
    forward-only: call it under ``torch.inference_mode()`` (or
    ``no_grad``) on the card. With ``cfg.remat`` each layer (each block,
    each Mamba layer, each application of the hybrid's shared block)
    keeps only its input while a gradient is recorded and recomputes its
    activations in the backward pass, as the reference's
    ``jax.checkpoint``; under ``torch.inference_mode()`` or ``no_grad``
    nothing is kept and remat changes nothing.
    """

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        dt = _dtype(cfg)
        self.embed = nn.Module()
        self.embed.table = nn.Parameter(torch.empty(
            (cfg.vocab, cfg.d_model), device=device, dtype=dt))
        f = cfg.family
        if f in ("dense", "moe", "mla_moe", "vlm"):
            if cfg.first_k_dense:
                self.dense_layers = nn.ModuleList(
                    DenseBlock(dense_cfg(cfg), device)
                    for _ in range(cfg.first_k_dense))
            block = MoEBlock if cfg.is_moe else DenseBlock
            self.layers = nn.ModuleList(
                block(cfg, device)
                for _ in range(cfg.n_layers - cfg.first_k_dense))
            if f == "vlm":
                self.patch_proj = nn.Parameter(torch.empty(
                    (cfg.d_model, cfg.d_model), device=device, dtype=dt))
            if cfg.mtp_depth:
                self.mtp = nn.Module()
                self.mtp.block = DenseBlock(dense_cfg(cfg), device)
                self.mtp.norm = Norm(cfg.d_model, cfg.norm, device)
                self.mtp.proj = nn.Parameter(torch.empty(
                    (2 * cfg.d_model, cfg.d_model), device=device, dtype=dt))
        elif f in ("ssm", "hybrid"):
            self.layers = nn.ModuleList(MambaBlock(cfg, device)
                                        for _ in range(cfg.n_layers))
            if f == "hybrid":
                self.shared_attn = DenseBlock(cfg, device)
        elif f == "encdec":
            self.enc_layers = nn.ModuleList(DenseBlock(cfg, device)
                                            for _ in range(cfg.n_enc_layers))
            self.enc_norm = Norm(cfg.d_model, cfg.norm, device)
            self.layers = nn.ModuleList(XAttnBlock(cfg, device)
                                        for _ in range(cfg.n_layers))
        else:
            raise ValueError(f"{cfg.name}: unknown family {f!r}")
        self.final_norm = Norm(cfg.d_model, cfg.norm, device)

    @classmethod
    def from_config(cls, cfg: ModelConfig, seed: int = 0, device=None) -> "LM":
        """An LM with weights drawn from `seed` by a ``torch.Generator`` on
        the target device, with the reference's initialisers: truncated
        normals scaled by d_in ** -0.5 (the embedding by 1), normals for
        the experts and conv_wx, norms at one and zero, Mamba's constants.
        The card unless `device` says otherwise; without a card this
        raises."""
        model = cls(cfg, device)
        gen = torch.Generator(device=model.device)
        gen.manual_seed(seed)
        with torch.no_grad():
            for m in model.modules():
                if isinstance(m, (DenseBlock, XAttnBlock, M2.Mamba)):
                    m.init_(gen)
            for w in (model.embed.table, getattr(model, "patch_proj", None),
                      getattr(getattr(model, "mtp", None), "proj", None)):
                if w is not None:
                    scale = 1.0 if w is model.embed.table else \
                        w.shape[0] ** -0.5
                    w.copy_(trunc_normal(gen, w.shape, scale, w.dtype))
        return model

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    def forward(self, tokens, patch_embeds=None, src_embeds=None):
        cfg = self.cfg
        x = shard(embed_tokens(self.embed.table, tokens), "batch", None, None)
        if cfg.family == "vlm":
            if patch_embeds is None:
                raise ValueError(f"{cfg.name}: the vlm family's forward takes "
                                 f"patch_embeds (B, P, d_model)")
            pe = patch_embeds.to(x.dtype) @ self.patch_proj
            x = torch.cat([pe, x], dim=1)
        positions = torch.arange(x.shape[1], device=x.device)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if cfg.family in ("dense", "moe", "mla_moe", "vlm"):
            for blk in getattr(self, "dense_layers", ()):
                x, _ = _remat(cfg, blk, x, positions)
            for blk in self.layers:
                x, a = _remat(cfg, blk, x, positions)
                if a is not None:
                    aux = aux + a
        elif cfg.family == "ssm":
            for blk in self.layers:
                x = _remat(cfg, blk, x)
        elif cfg.family == "hybrid":
            k = cfg.attn_every
            for i, blk in enumerate(self.layers):
                x = _remat(cfg, blk, x)
                if (i + 1) % k == 0:
                    x, _ = _remat(cfg, self.shared_attn, x, positions)
        else:                                                 # encdec
            if src_embeds is None:
                raise ValueError(f"{cfg.name}: the encdec family's forward "
                                 f"takes src_embeds (B, Se, d_model)")
            enc = self.encode(src_embeds.to(x.dtype))
            for blk in self.layers:
                x = _remat(cfg, blk, x, positions, enc)
        x = self.final_norm(x)
        logits = logits_out(self.embed.table, x)
        if cfg.family == "vlm":
            logits = logits[:, patch_embeds.shape[1]:]
        return logits, aux

    def encode(self, src_embeds):
        """encdec: the non-causal encoder and its final norm."""
        enc = src_embeds
        positions = torch.arange(enc.shape[1], device=enc.device)
        for blk in self.enc_layers:
            enc, _ = _remat(self.cfg, blk, enc, positions, causal=False)
        return self.enc_norm(enc)


# ---------------------------------------------------------------------------
# loss (with DeepSeek's optional multi-token prediction)
# ---------------------------------------------------------------------------

def loss_fn(cfg: ModelConfig, model: LM, batch: dict, *, aux_weight=0.01,
            mtp_weight=0.3):
    """(total, metrics) of ``model`` (whose configuration is `cfg`) on
    ``batch`` ({"tokens", "labels"} (B, S) int64, "patch_embeds" for vlm,
    "src_embeds" for encdec): total = cross-entropy + aux_weight * the MoE
    router's loss (+ mtp_weight * the MTP loss where the model has the
    module); metrics {"ce", "moe_aux"(, "mtp")}, 0-d float32 tensors."""
    logits, aux = model(batch["tokens"], patch_embeds=batch.get("patch_embeds"),
                        src_embeds=batch.get("src_embeds"))
    loss = cross_entropy(logits, batch["labels"])
    total = loss + aux_weight * aux
    metrics = {"ce": loss, "moe_aux": aux}
    if cfg.mtp_depth and hasattr(model, "mtp"):
        mtp = _mtp_loss(cfg, model, batch)
        total = total + mtp_weight * mtp
        metrics["mtp"] = mtp
    return total, metrics


def _mtp_loss(cfg: ModelConfig, model: LM, batch: dict):
    """Depth-1 MTP: predict token t + 2 from [emb(token t) ; emb(label t)]
    @ proj, through the dense MTP block (no remat), its norm and the tied
    logits; labels shifted one more place, -100 at the end."""
    table, labels = model.embed.table, batch["labels"]
    x = embed_tokens(table, batch["tokens"])
    lab = embed_tokens(table, labels.clamp(min=0))
    h = torch.cat([x, lab], dim=-1) @ model.mtp.proj
    h, _ = model.mtp.block(h, torch.arange(h.shape[1], device=h.device))
    logits = logits_out(table, model.mtp.norm(h))
    labels2 = torch.cat([labels[:, 1:], torch.full_like(labels[:, :1], -100)],
                        dim=1)
    return cross_entropy(logits, labels2)
