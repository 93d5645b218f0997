"""mamba2-780m [arXiv:2405.21060; unverified] — pure SSM (SSD).

48L d_model=1536 (attn-free) vocab=50280 ssm_state=128, expand 2
(d_inner=3072, headdim 64 -> 48 SSD heads). O(1) per-token state ->
long_500k RUNS.
"""
from ..models.config import ModelConfig


def full():
    return ModelConfig(
        name="mamba2-780m", family="ssm",
        n_layers=48, d_model=1536, n_heads=0, n_kv_heads=0, d_ff=0,
        vocab=50280, ssm_state=128, ssm_headdim=64, ssm_expand=2)


def smoke():
    return ModelConfig(
        name="mamba2-780m-smoke", family="ssm",
        n_layers=2, d_model=64, n_heads=0, n_kv_heads=0, d_ff=0,
        vocab=512, ssm_state=16, ssm_headdim=16, dtype="float32",
        remat=False)
