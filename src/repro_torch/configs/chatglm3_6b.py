"""chatglm3-6b [arXiv:2406.12793; hf] — dense, 2d (partial) RoPE.

28L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=65024. The "RoPE 2d"
is realized as partial rotary (rotary_pct=0.5 — half the head dims
rotate, half stay). kv=2 < 16-way TP -> kv heads REPLICATED on the
model axis (DESIGN.md §5). Full attention -> long_500k SKIPPED.
"""
from ..models.config import ModelConfig


def full():
    return ModelConfig(
        name="chatglm3-6b", family="dense",
        n_layers=28, d_model=4096, n_heads=32, n_kv_heads=2, d_ff=13696,
        vocab=65024, rotary_pct=0.5, rope_theta=1e4)


def smoke():
    return ModelConfig(
        name="chatglm3-6b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab=512, rotary_pct=0.5, dtype="float32", remat=False)
