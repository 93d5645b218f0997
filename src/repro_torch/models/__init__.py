"""The LM substrate of the port: every family's forward pass (``lm.LM``)
with its layers, attention (GQA, MLA, cross), MoE and Mamba2 modules,
and the serving path (``serve``: caches, prefill, decode), over the
configurations of ``repro_torch.configs``."""
from . import attention, layers, lm, mamba2, moe, serve
from .config import ModelConfig
from .lm import LM

__all__ = ["LM", "ModelConfig", "attention", "layers", "lm", "mamba2", "moe",
           "serve"]
