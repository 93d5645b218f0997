"""Morton (Z-order) codes, 32-bit and 64-bit.

PyTorch has thin uint32 support and no count-leading-zeros, so a 64-bit
code is held as two int64 tensors (hi, lo), each carrying one unsigned
32-bit lane, and ``_clz32`` is written with integer compares and shifts.
The bits rule, the quantization and the bit interleave repeat
``repro.core.morton`` exactly, so codes, the stable sort permutation and
the prefix deltas are integer-identical to it.
"""
from __future__ import annotations

import torch

__all__ = ["quantize", "morton32", "morton64", "sort_by_morton",
           "combined_delta_key", "delta_from_keys", "bits_per_dim", "key_of",
           "key_lanes"]

_U32_MAX = (1 << 32) - 1


def bits_per_dim(dim: int, total_bits: int = 64) -> int:
    """Bits per dimension: ``min(64 // dim, 21)`` for dim <= 6 (21 even at
    dim 1 and 2), ``64 // dim`` above; ``max(32 // dim, 1)`` for 32-bit."""
    if total_bits == 32:
        return max(32 // dim, 1)
    return min(64 // dim, 21) if dim <= 6 else 64 // dim


def quantize(coords, lo, hi, bits: int) -> torch.Tensor:
    """Normalize coords (N, dim) float32 into the integer grid
    [0, 2^bits - 1]; int64 result."""
    extent = torch.clamp_min(hi - lo, 1e-30)
    x = (coords - lo) / extent
    scale = float(torch.tensor(float((1 << bits) - 1), dtype=torch.float32))
    q = torch.clamp(x * scale, 0.0, scale)
    # float32 -> integer truncates toward zero, as XLA's convert does;
    # the clamp keeps 2^32 (scale at bits=32) inside the uint32 range
    return torch.clamp(q.to(torch.int64), max=_U32_MAX)


def _interleave(q, bits: int, total_bits: int):
    """Bit-interleave q (N, dim) -> (hi, lo) int64 tensors holding uint32.
    Input (dim k, bit j) lands at output bit ``j * dim + k``."""
    n, dim = q.shape
    hi = torch.zeros((n,), dtype=torch.int64, device=q.device)
    lo = torch.zeros((n,), dtype=torch.int64, device=q.device)
    for j in range(bits):
        for k in range(dim):
            p = j * dim + k
            if p >= total_bits:
                continue
            bit = (q[:, k] >> j) & 1
            if p < 32:
                lo |= bit << p
            else:
                hi |= bit << (p - 32)
    return hi, lo


def _scene(coords, scene_lo, scene_hi):
    if scene_lo is None:
        scene_lo = coords.amin(0)
    if scene_hi is None:
        scene_hi = coords.amax(0)
    return scene_lo, scene_hi


def morton32(coords, scene_lo=None, scene_hi=None) -> torch.Tensor:
    """32-bit Morton codes, (N,) int64 holding uint32."""
    scene_lo, scene_hi = _scene(coords, scene_lo, scene_hi)
    bits = bits_per_dim(coords.shape[-1], 32)
    _, lo = _interleave(quantize(coords, scene_lo, scene_hi, bits), bits, 32)
    return lo


def morton64(coords, scene_lo=None, scene_hi=None):
    """64-bit Morton codes as an (hi, lo) pair of int64 uint32 lanes."""
    scene_lo, scene_hi = _scene(coords, scene_lo, scene_hi)
    bits = bits_per_dim(coords.shape[-1], 64)
    return _interleave(quantize(coords, scene_lo, scene_hi, bits), bits, 64)


def key_of(codes) -> torch.Tensor:
    """The (N,) int64 sort key of Morton codes, a (lo,) tensor (32-bit, hi
    taken as 0) or an (hi, lo) pair: ``(hi - 2^31) << 32 | lo``, the signed
    image of code ^ 2^63, which maps the unsigned 64-bit order onto the
    signed order, so codes with bit 63 set (dim 4 and dim 8 use all 64
    bits) still sort last."""
    if isinstance(codes, tuple):
        hi, lo = codes
    else:
        hi, lo = torch.zeros_like(codes), codes
    return ((hi - (1 << 31)) << 32) + lo


def key_lanes(key: torch.Tensor):
    """(hi, lo, idx) lanes of the 96-bit augmented keys (as
    :func:`combined_delta_key`) from sorted :func:`key_of` keys."""
    idx = torch.arange(key.shape[0], dtype=torch.int64, device=key.device)
    return (key >> 32) + (1 << 31), key & _U32_MAX, idx


def sort_by_morton(codes, aux: torch.Tensor):
    """Stable sort by Morton code; `codes` is a (lo,) tensor or an (hi, lo)
    pair. Returns (sorted_codes, permuted_aux). The pair sorts as ONE
    int64 key (:func:`key_of`)."""
    if isinstance(codes, tuple):
        hi, lo = codes
        order = torch.sort(key_of(codes), stable=True).indices
        return (hi[order], lo[order]), aux[order]
    order = torch.sort(codes, stable=True).indices
    return codes[order], aux[order]


def combined_delta_key(codes, n: int):
    """(hi, lo, idx) lanes of the 96-bit augmented keys: the sorted
    position breaks ties between duplicate codes (Karras §4)."""
    if isinstance(codes, tuple):
        hi, lo = codes
    else:
        lo = codes
        hi = torch.zeros_like(codes)
    idx = torch.arange(n, dtype=torch.int64, device=lo.device)
    return hi, lo, idx


def _clz32(x: torch.Tensor) -> torch.Tensor:
    """Count leading zeros of uint32 values held in int64 (32 for 0),
    by a five-step binary search on the bit length."""
    n = torch.zeros_like(x)
    for shift in (16, 8, 4, 2, 1):
        small = x < (1 << (32 - shift))
        n = torch.where(small, n + shift, n)
        x = torch.where(small, x << shift, x)
    # x == 0 took every step (31) and takes this one too: 32
    return torch.where(x < (1 << 31), n + 1, n)


def delta_from_keys(hi, lo, idx) -> torch.Tensor:
    """delta(i) = common-prefix length of keys i and i+1 over the 96-bit
    (hi | lo | idx) key. Returns (N-1,) int32."""
    hi_x = hi[:-1] ^ hi[1:]
    lo_x = lo[:-1] ^ lo[1:]
    ix_x = idx[:-1] ^ idx[1:]
    d = torch.where(hi_x != 0, _clz32(hi_x),
                    torch.where(lo_x != 0, 32 + _clz32(lo_x),
                                64 + _clz32(ix_x)))
    return d.to(torch.int32)
