"""tinyllama-1.1b [arXiv:2401.02385; hf] — llama2-arch small.

22L d_model=2048 32H (GQA kv=4, head_dim=64) d_ff=5632 vocab=32000.
Full attention -> long_500k SKIPPED.
"""
from ..models.config import ModelConfig


def full():
    return ModelConfig(
        name="tinyllama-1.1b", family="dense",
        n_layers=22, d_model=2048, n_heads=32, n_kv_heads=4, d_ff=5632,
        vocab=32000, rope_theta=1e4)


def smoke():
    return ModelConfig(
        name="tinyllama-1.1b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab=512, dtype="float32", remat=False)
