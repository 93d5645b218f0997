"""Plain PyTorch oracles of the stand-alone kernels: the semantic ground
truth, as ``repro.kernels.ref`` is the reference's.

A kernel's twin (``<kernel>_ref`` in the kernel's own module) repeats
the kernel's algorithm and float order, so the two agree bit for bit;
these oracles state what the kernels compute in the plainest form, over
the full (queries x points) or (rays x boxes) matrix, and both are held
to them. ``attention_ref`` arrives with the flash-attention slice.
"""
from __future__ import annotations

import torch

from ..core import geometry as G
from ..core import morton as M

__all__ = ["morton64_ref", "bruteforce_knn_ref", "ray_box_nearest_ref"]


def morton64_ref(coords, scene_lo, scene_hi):
    """(N, dim) float32 -> (hi, lo) 64-bit Morton codes, int64 tensors of
    uint32 values. Delegates to the core implementation (itself held to
    the reference's)."""
    return M.morton64(coords, scene_lo, scene_hi)


def bruteforce_knn_ref(queries, points, k: int):
    """Exact k smallest euclidean distances over the full (Q, N) matrix
    |q|^2 - 2 q p^T + |p|^2 (clamped at 0). Returns (d, idx): (Q, k)
    float32 / int32, ascending, ties to the lower index (a stable sort),
    (inf, -1) past N."""
    q, n = queries.shape[0], points.shape[0]
    d2 = ((queries * queries).sum(-1, keepdim=True)
          - 2.0 * queries @ points.T
          + (points * points).sum(-1)[None, :])
    d2 = torch.clamp_min(d2, 0.0)
    d, idx = torch.sort(d2, dim=1, stable=True)
    d, idx = d[:, :k], idx[:, :k].to(torch.int32)
    if n < k:
        d = torch.cat([d, torch.full((q, k - n), float("inf"),
                                     device=d.device)], 1)
        idx = torch.cat([idx, torch.full((q, k - n), -1, dtype=torch.int32,
                                         device=idx.device)], 1)
    return G.sqrt(d), idx


def ray_box_nearest_ref(origins, directions, box_lo, box_hi):
    """For each ray the smallest entry parameter t over all boxes and the
    first box reaching it. Returns (t, idx): (R,), t = inf / idx = -1 on a
    miss."""
    _, t = G.ray_box(origins[:, None, :], directions[:, None, :],
                     box_lo[None, :, :], box_hi[None, :, :])    # (R, B)
    if t.shape[1] == 0:
        return (torch.full((t.shape[0],), float("inf"), device=t.device),
                torch.full((t.shape[0],), -1, dtype=torch.int32,
                           device=t.device))
    tmin, idx = t.min(dim=1)
    return tmin, torch.where(torch.isfinite(tmin), idx.to(torch.int32), -1)
