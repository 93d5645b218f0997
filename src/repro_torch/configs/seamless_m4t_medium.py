"""seamless-m4t-medium [arXiv:2308.11596; hf] — audio/multimodal enc-dec.

12L d_model=1024 16H (GQA kv=16) d_ff=4096 vocab=256206. We realize "12L"
as 12 encoder + 12 decoder layers (the HF medium checkpoint's text
enc/dec depth). The speech frontend is a STUB per the assignment:
input_specs supplies precomputed (B, frames, d_model) embeddings.
Full attention both sides -> long_500k is SKIPPED (DESIGN.md §4).
"""
from ..models.config import ModelConfig


def full():
    return ModelConfig(
        name="seamless-m4t-medium", family="encdec",
        n_layers=12, n_enc_layers=12, d_model=1024, n_heads=16,
        n_kv_heads=16, d_ff=4096, vocab=256206,
        norm="layernorm", mlp="gelu", rope_theta=1e4)


def smoke():
    return ModelConfig(
        name="seamless-m4t-medium-smoke", family="encdec",
        n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=512, norm="layernorm", mlp="gelu",
        dtype="float32", remat=False)
