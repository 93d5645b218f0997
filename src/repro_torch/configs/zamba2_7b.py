"""zamba2-7b [arXiv:2411.15242; unverified] — hybrid Mamba2 + shared attn.

81 layer slots, d_model=3584, ssm_state=64; the SHARED attention+MLP
block (32H kv=32, d_ff=14336, tied weights) is applied after every 6
mamba layers (13 applications). Bounded per-token state (SSM + full-attn
KV that grows only at 13 shared applications) -> long_500k RUNS.
"""
from ..models.config import ModelConfig


def full():
    return ModelConfig(
        name="zamba2-7b", family="hybrid",
        n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, d_ff=14336,
        vocab=32000, ssm_state=64, ssm_headdim=64, ssm_expand=2,
        attn_every=6, rope_theta=1e4)


def smoke():
    return ModelConfig(
        name="zamba2-7b-smoke", family="hybrid",
        n_layers=5, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab=512, ssm_state=16, ssm_headdim=16, attn_every=2,
        dtype="float32", remat=False)
