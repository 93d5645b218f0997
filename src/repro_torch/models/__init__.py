"""The LM substrate of the port: the dense family's forward pass
(``lm.LM``) with its layers and GQA attention, over the configurations
of ``repro_torch.configs``."""
from . import attention, layers, lm
from .config import ModelConfig
from .lm import LM

__all__ = ["LM", "ModelConfig", "attention", "layers", "lm"]
