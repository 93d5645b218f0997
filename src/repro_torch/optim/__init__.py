"""The optimizer of the LM's training: AdamW with global-norm clipping
and a warmup + cosine schedule, and int8 error-feedback gradient
compression (the port of ``repro.optim``)."""
from .adamw import (adamw_init, adamw_update, clip_by_global_norm,
                    cosine_schedule, leaf_order)
from .compression import (compress_int8, decompress_int8,
                          error_feedback_compress)

__all__ = ["adamw_init", "adamw_update", "cosine_schedule",
           "clip_by_global_norm", "leaf_order", "compress_int8",
           "decompress_int8", "error_feedback_compress"]
