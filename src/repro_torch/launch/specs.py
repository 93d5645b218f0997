"""Input specs and step builders for every (architecture x input shape)
cell: the port of ``repro.launch.specs``.

``input_specs(cfg, shape)`` gives meta tensors standing in for every
model input (no memory), and ``build_step`` the function the dry-run
runs:

  train_4k    -> train_step(model, opt_state, batch)    (fwd + bwd + AdamW)
  prefill_32k -> prefill_step(model, batch) -> logits
  decode_32k  -> decode_step(model, cache, batch)       (one new token)
  long_500k   -> decode_step, sub-quadratic caches only

The modality frontends are stubs, as in the reference: the [audio] and
[vlm] cells get precomputed frame or patch embeddings in their batch.
Tokens are int32, the reference's dtype.
"""
from __future__ import annotations

import dataclasses

import torch

from ..models import serve
from ..models.config import ModelConfig
from ..models.lm import LM

__all__ = ["ShapeCell", "SHAPES", "ENC_LEN_DECODE", "cell_applicable",
           "input_specs", "cache_struct", "params_struct", "opt_struct",
           "build_step"]


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq: int
    global_batch: int
    mode: str                     # train | prefill | decode


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}

ENC_LEN_DECODE = 4096             # encdec decode: the encoder stub's length


def cell_applicable(cfg: ModelConfig, shape: str) -> tuple[bool, str]:
    """(runnable, reason). long_500k needs sub-quadratic attention."""
    if shape == "long_500k" and not cfg.sub_quadratic:
        return False, ("full quadratic attention: 500k decode cache "
                       "infeasible by design (DESIGN.md §4)")
    return True, ""


def _f(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: str) -> dict:
    """The cell's batch as meta tensors (decode: the ``tokens`` input; the
    cache comes from ``cache_struct``)."""
    cell = SHAPES[shape]
    b, s = cell.global_batch, cell.seq
    tok = torch.int32
    emb = getattr(torch, cfg.dtype)
    if cell.mode in ("train", "prefill"):
        batch = {}
        if cfg.family == "vlm":
            batch["patch_embeds"] = _f((b, cfg.n_patches, cfg.d_model), emb)
            batch["tokens"] = _f((b, s - cfg.n_patches), tok)
            batch["labels"] = _f((b, s - cfg.n_patches), tok)
        elif cfg.family == "encdec":
            batch["src_embeds"] = _f((b, s, cfg.d_model), emb)
            batch["tokens"] = _f((b, s), tok)
            batch["labels"] = _f((b, s), tok)
        else:
            batch["tokens"] = _f((b, s), tok)
            batch["labels"] = _f((b, s), tok)
        if cell.mode == "prefill":
            batch.pop("labels")
        return batch
    return {"tokens": _f((b, 1), tok)}


def cache_struct(cfg: ModelConfig, shape: str) -> dict:
    """The cell's decode cache on the meta device."""
    cell = SHAPES[shape]
    enc = ENC_LEN_DECODE if cfg.family == "encdec" else None
    return serve.init_cache(cfg, cell.global_batch, cell.seq, enc_len=enc,
                            device="meta")


def params_struct(cfg: ModelConfig) -> LM:
    """The LM on the meta device (its constructor: ``from_config`` draws
    weights from a generator, which the meta device has not)."""
    return LM(cfg, device="meta")


def opt_struct(cfg: ModelConfig, pstruct: LM, opt_dtype, *, mesh=None,
               specs: dict | None = None) -> dict:
    from ..optim import adamw_init
    return adamw_init(pstruct, dtype=opt_dtype, mesh=mesh, specs=specs)


def build_step(cfg: ModelConfig, mode: str, *, n_micro: int = 1,
               opt_dtype=torch.float32, accum_dtype=torch.float32):
    """The function the dry-run runs."""
    del opt_dtype                 # the moments carry their own dtype
    if mode == "train":
        from ..train import make_train_step
        return make_train_step(cfg, n_micro=n_micro, accum_dtype=accum_dtype)
    if mode == "prefill":
        def prefill_step(model, batch):
            with torch.no_grad():
                logits, _ = model(batch["tokens"],
                                  patch_embeds=batch.get("patch_embeds"),
                                  src_embeds=batch.get("src_embeds"))
            return logits
        return prefill_step
    if mode == "decode":
        def dstep(model, cache, batch):
            with torch.no_grad():
                return serve.decode_step(model, cache, batch["tokens"])
        return dstep
    raise ValueError(mode)
