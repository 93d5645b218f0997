"""phi3-mini-3.8b [arXiv:2404.14219; unverified] — dense.

32L d_model=3072 32H (kv=32 -> MHA) d_ff=8192 vocab=32064.
RoPE + SwiGLU + RMSNorm. Full attention -> long_500k SKIPPED.
"""
from ..models.config import ModelConfig


def full():
    return ModelConfig(
        name="phi3-mini-3.8b", family="dense",
        n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32, d_ff=8192,
        vocab=32064, rope_theta=1e4)


def smoke():
    return ModelConfig(
        name="phi3-mini-3.8b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab=512, dtype="float32", remat=False)
