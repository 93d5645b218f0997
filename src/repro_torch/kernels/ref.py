"""Plain PyTorch oracles of the stand-alone kernels: the semantic ground
truth, as ``repro.kernels.ref`` is the reference's.

A kernel's twin (``<kernel>_ref`` in the kernel's own module) repeats
the kernel's algorithm and float order, so the two agree bit for bit;
these oracles state what the kernels compute in the plainest form, over
the full (queries x points) or (rays x boxes) matrix, and both are held
to them.
"""
from __future__ import annotations

import torch

from ..core import geometry as G
from ..core import morton as M

__all__ = ["morton64_ref", "bruteforce_knn_ref", "ray_box_nearest_ref",
           "attention_ref"]


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


def attention_ref(q, k, v, *, causal: bool = True, window: int | None = None,
                  scale: float | None = None):
    """(B, Hq, Sq, D) x (B, Hkv, Skv, D) -> (B, Hq, Sq, D) in q's dtype:
    GQA by head repetition, float32 softmax over the full score matrix,
    causal and sliding-window masks right-aligned (query row i at position
    i + Skv - Sq) as -inf, so a row with no visible key is NaN."""
    sq, d = q.shape[2], q.shape[3]
    g = q.shape[1] // k.shape[1]
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    if scale is None:
        scale = 1.0 / torch.sqrt(torch.tensor(float(d), dtype=torch.float32))
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    skv = k.shape[2]
    qpos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    logits = torch.where(mask, logits, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    return torch.matmul(p, v.float()).to(q.dtype)
