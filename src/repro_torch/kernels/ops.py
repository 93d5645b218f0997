"""The stand-alone kernel entry points, with the reference's signatures
(``repro.kernels.ops``): ``morton64``, ``bruteforce_knn``,
``ray_box_nearest`` and ``flash_attention``.

Each takes tensors on the CUDA card (the kernel runs) or on the CPU (its
plain twin runs); the results equal the reference's. The card needs no
padding, so the block sizes ``bq``, ``br`` and ``bb`` that shaped the
reference's TPU tiles are accepted and change nothing. ``bn`` changes a
result in one place only: the rows of ``bruteforce_knn`` past N when
k > N (see ``kernels.bruteforce_knn``). ``morton64``'s ``bn`` changes
nothing. ``flash_attention``'s ``bk`` sets the twin's KV panels, and so
its float32 rounding, as it does the reference's; the kernel's tiles are
its own, it masks the ragged edges itself, and for 16-bit inputs it
rounds p to the input type before P·V (``kernels.flash_attention``).
"""
from __future__ import annotations

import torch

from . import sanitize
from .bruteforce_knn import bruteforce_knn as _bruteforce_knn
from .flash_attention import flash_attention as _flash_attention
from .morton import morton64 as _morton64
from .ray_box import ray_box_nearest as _ray_box_nearest

__all__ = ["morton64", "bruteforce_knn", "ray_box_nearest",
           "flash_attention"]


def _f32(x):
    """Inputs as float32, as the reference's kernels read them (float16
    and bfloat16 cast up exactly; float64 rounded, as JAX with x64 off
    stores it)."""
    return x if x.dtype == torch.float32 else x.to(torch.float32)


def morton64(coords, scene_lo=None, scene_hi=None, *, bn: int = 1024):
    """64-bit Morton codes of (N, dim) coords -> (hi, lo) (N,) int64
    tensors holding uint32 values. The scene defaults to the coordinates'
    min and max."""
    coords = _f32(coords)
    if scene_lo is None:
        scene_lo = coords.amin(0)
    if scene_hi is None:
        scene_hi = coords.amax(0)
    return _morton64(coords, _f32(scene_lo), _f32(scene_hi))


def bruteforce_knn(queries, points, k: int, *, bq: int = 256, bn: int = 512):
    """Exact kNN: (Q, dim) x (N, dim) -> (dists, idx) (Q, k) ascending,
    ties to the lower index."""
    d, i = _bruteforce_knn(_f32(queries), _f32(points), k, bn=bn)
    sanitize.check_knn(d, i, n=points.shape[0], kernel="bruteforce_knn")
    return d, i


def ray_box_nearest(origins, directions, box_lo, box_hi, *, br: int = 256,
                    bb: int = 512):
    """Nearest box per ray: returns (t, idx) (R,), t = inf / idx = -1 on a
    miss."""
    return _ray_box_nearest(*(_f32(x) for x in (origins, directions, box_lo,
                                                box_hi)))


def flash_attention(q, k, v, *, causal: bool = True, window: int | None = None,
                    bq: int = 128, bk: int = 128):
    """Flash attention: q (B, Hq, Sq, D), k / v (B, Hkv, Skv, D) ->
    (B, Hq, Sq, D) in q's dtype. GQA via Hq = G * Hkv; optional sliding
    window; query rows right-aligned to the true lengths (a row with no
    visible key gives 0)."""
    return _flash_attention(q, k, v, causal=causal, window=window, bq=bq,
                            bk=bk)
