"""mixtral-8x22b [arXiv:2401.04088; hf] — MoE, 8 experts top-2, SWA.

56L d_model=6144 48H (GQA kv=8, head_dim=128) d_ff=16384 (per expert)
vocab=32768. Sliding window 4096 per the assignment -> long_500k RUNS
(window-bounded ring KV cache).
"""
from ..models.config import ModelConfig


def full():
    return ModelConfig(
        name="mixtral-8x22b", family="moe",
        n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=0,
        vocab=32768, n_experts=8, moe_top_k=2, d_expert=16384,
        window=4096, rope_theta=1e6)


def smoke():
    return ModelConfig(
        name="mixtral-8x22b-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=0, vocab=512,
        n_experts=4, moe_top_k=2, d_expert=96, window=16,
        dtype="float32", remat=False)
