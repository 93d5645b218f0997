"""llava-next-mistral-7b [hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]
— VLM: mistral-7b backbone, anyres tiling.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000. The vision tower
is a STUB: input_specs supplies precomputed (B, 576, d_model) patch
embeddings (CLIP-L/14 @ 336px base grid); anyres tile *selection* uses
repro.core.geometry box overlap (see examples/vlm_tiles.py). Sliding
window 4096 (mistral-v1 attention) -> long_500k RUNS on the ring cache.
"""
from ..models.config import ModelConfig


def full():
    return ModelConfig(
        name="llava-next-mistral-7b", family="vlm",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
        vocab=32000, window=4096, n_patches=576, rope_theta=1e6)


def smoke():
    return ModelConfig(
        name="llava-next-mistral-7b-smoke", family="vlm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab=512, window=16, n_patches=8, dtype="float32", remat=False)
