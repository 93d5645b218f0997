"""Moving least squares interpolation (§1: "new implementation of the
moving least squares algorithm [Quaranta et al. 2005] as part of the
interpolation subpackage"), as ``repro.core.interpolation`` computes it.

Given source points with attached values and target points, each target:

  1. finds its k nearest sources (``BVH.query(nearest)``: on the card the
     ``bvh_traverse_knn`` kernel);
  2. weights them with the compactly supported Wendland C2 RBF scaled by
     1.1 times the k-th neighbour distance;
  3. solves the weighted least-squares fit over a polynomial basis
     (degree 0, 1 or 2) shifted to the target, for conditioning;
  4. evaluates the fit at the target: the constant coefficient.

Everything after the kNN is one batch of small dense solves: the normal
equations by batched matrix products in full float32 (TF32 off for the
call) and one ``torch.linalg.solve`` over (T, m, m), as the reference
leaves its ``jnp.linalg.solve`` to XLA outside any kernel.
"""
from __future__ import annotations

import torch

from . import geometry as G
from . import predicates as P
from .bvh import BVH
from .index import ExecutionPolicy, placed

__all__ = ["mls_interpolate", "wendland_c2", "polynomial_basis_size"]


def wendland_c2(r):
    """Wendland C2 compact RBF: (1-r)^4 (4r+1) on [0, 1], 0 outside; the
    fourth power by two squarings, as XLA evaluates ``x ** 4``."""
    r = torch.clamp(r, 0.0, 1.0)
    s2 = (1.0 - r) * (1.0 - r)
    return s2 * s2 * (4.0 * r + 1.0)


def polynomial_basis_size(dim: int, degree: int) -> int:
    if degree == 0:
        return 1
    if degree == 1:
        return 1 + dim
    if degree == 2:
        return 1 + dim + dim * (dim + 1) // 2
    raise ValueError("degree must be 0, 1 or 2")


def _basis(x, degree: int):
    """Polynomial basis rows p(x) for x (..., dim): 1, then x, then the
    products x_i x_j over i <= j in ``triu_indices`` order."""
    parts = [torch.ones(x.shape[:-1] + (1,), dtype=x.dtype, device=x.device)]
    if degree >= 1:
        parts.append(x)
    if degree >= 2:
        iu, ju = torch.triu_indices(x.shape[-1], x.shape[-1], device=x.device)
        parts.append(x[..., iu] * x[..., ju])
    return torch.cat(parts, -1)


def mls_interpolate(src_coords, src_values, tgt_coords, *, k: int | None = None,
                    degree: int = 1, reg: float = 1e-8, device=None):
    """Interpolate `src_values` (N,) from `src_coords` (N, dim) onto
    `tgt_coords` (T, dim); returns (T,) float32 values. Tensors run where
    they live, arrays on `device` (the CUDA card by default).

    k defaults to 2 * basis size + 2, at most N (ArborX's heuristic of a
    modest oversampling of the polynomial basis)."""
    src = placed(src_coords, device)
    dev = src.device
    values = placed(src_values, dev)
    tgt = placed(tgt_coords, dev)
    m = polynomial_basis_size(src.shape[1], degree)
    if k is None:
        k = min(2 * m + 2, src.shape[0])
    index = BVH(G.Points(src), policy=ExecutionPolicy(device=dev))
    res = index.query(P.nearest(G.Points(tgt), k=k))
    d, ix = res.distances, torch.clamp_min(res.indices, 0).to(torch.int64)
    radius = torch.clamp_min(d[:, -1:], 1e-30) * 1.1
    w = wendland_c2(d / radius)                              # (T, k)
    pm = _basis(src[ix] - tgt[:, None, :], degree)           # (T, k, m)
    pw = (pm * w[..., None]).transpose(1, 2)                 # (T, m, k)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        a = pw @ pm + reg * torch.eye(m, dtype=pm.dtype, device=dev)
        b = pw @ values[ix][..., None]                       # (T, m, 1)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return torch.linalg.solve(a, b)[:, 0, 0]
