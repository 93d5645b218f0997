"""starcoder2-7b [arXiv:2402.19173; hf] — dense code model.

32L d_model=4608 36H (GQA kv=4, head_dim=128) d_ff=18432 vocab=49152.
LayerNorm + GeLU MLP (the StarCoder2 block), RoPE theta 1e5.
Full attention -> long_500k SKIPPED.
"""
from ..models.config import ModelConfig


def full():
    return ModelConfig(
        name="starcoder2-7b", family="dense",
        n_layers=32, d_model=4608, n_heads=36, n_kv_heads=4, d_ff=18432,
        vocab=49152, norm="layernorm", mlp="gelu", rope_theta=1e5)


def smoke():
    return ModelConfig(
        name="starcoder2-7b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab=512, norm="layernorm", mlp="gelu", dtype="float32",
        remat=False)
