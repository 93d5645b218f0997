"""Nearest ray-box hit over a flat box soup: ``ray_box_nearest``, with
its plain twin ``ray_box_nearest_ref``.

For R rays and B boxes, each ray's smallest entry parameter t >= 0 of the
slab test (``geometry.ray_box``) and the first box reaching it: (R,)
float32 t and (R,) int32 index, (inf, -1) on a miss, the lowest index on
equal t. It is the flat counterpart of ``cast_nearest(k=1)`` over a
``BVH(Boxes)`` of the same boxes, and the contract of the reference's
``repro.kernels.ops.ray_box_nearest``.

A CPU tensor takes the twin, which sweeps panels of boxes through
``geometry.ray_box`` and keeps a running (t, index) pair per ray with a
strict < merge; a CUDA tensor launches ``csrc/ray_box.cu`` (one
thread per ray, boxes streamed through shared memory); any other device
raises. t is bit-identical between the two: the slab test sums no
products. The kernel's launch count is ``ray_box_nearest.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from ..core import geometry as G
from . import _build
from .bvh_traverse import MAX_DIM, _device_of, _stream

__all__ = ["ray_box_nearest", "ray_box_nearest_ref"]

#: ray x box x dim elements of one panel of the twin
_PANEL_ELEMENTS = 1 << 24


def _check(what, origins, directions, box_lo, box_hi):
    if origins.dim() != 2 or origins.shape != directions.shape:
        raise ValueError(f"{what}: origins and directions must both be "
                         f"(R, dim), got {tuple(origins.shape)} and "
                         f"{tuple(directions.shape)}")
    if box_lo.dim() != 2 or box_lo.shape != box_hi.shape \
            or box_lo.shape[1] != origins.shape[1]:
        raise ValueError(f"{what}: box_lo and box_hi must both be (B, dim) "
                         f"with the rays' dim, got {tuple(box_lo.shape)} and "
                         f"{tuple(box_hi.shape)}")
    if not 1 <= origins.shape[1] <= MAX_DIM:
        raise ValueError(f"{what}: dim must be in 1..{MAX_DIM}, got "
                         f"{origins.shape[1]}")
    for name, t in (("origins", origins), ("directions", directions),
                    ("box_lo", box_lo), ("box_hi", box_hi)):
        if t.dtype != torch.float32:
            raise ValueError(f"{what}: {name} must be float32, got {t.dtype}")
        if t.device != origins.device:
            raise ValueError(f"{what}: {name} is on {t.device}, not "
                             f"{origins.device}")


def ray_box_nearest_ref(origins, directions, box_lo, box_hi):
    """The kernel's plain twin: ``geometry.ray_box`` over panels of boxes
    (at most ``_PANEL_ELEMENTS`` ray x box x dim elements each) and a
    strict < merge of each panel's first minimum."""
    r, dim = origins.shape
    b = box_lo.shape[0]
    dev = origins.device
    best_t = torch.full((r,), float("inf"), dtype=torch.float32, device=dev)
    best_i = torch.full((r,), -1, dtype=torch.int32, device=dev)
    if r == 0:
        return best_t, best_i
    panel = max(1, _PANEL_ELEMENTS // (r * dim))
    o, d = origins[:, None], directions[:, None]
    for s in range(0, b, panel):
        _, t = G.ray_box(o, d, box_lo[None, s:s + panel],
                         box_hi[None, s:s + panel])
        m, first = t.min(dim=1)
        better = m < best_t
        best_t = torch.where(better, m, best_t)
        best_i = torch.where(better, (first + s).to(torch.int32), best_i)
    return best_t, best_i


_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3


def ray_box_nearest(origins, directions, box_lo, box_hi):
    """(t, idx) (R,) float32 / int32: per ray the smallest slab-test entry
    t over the B boxes and the lowest box index reaching it; (inf, -1) on
    a miss. origins / directions (R, dim), box_lo / box_hi (B, dim),
    float32, dim <= MAX_DIM."""
    what = "ray_box_nearest"
    _check(what, origins, directions, box_lo, box_hi)
    if _device_of(origins, what) == "cpu":
        return ray_box_nearest_ref(origins, directions, box_lo, box_hi)
    dev = origins.device
    r, dim = origins.shape
    a = [t.contiguous() for t in (origins, directions, box_lo, box_hi)]
    t_out = torch.full((r,), float("inf"), dtype=torch.float32, device=dev)
    i_out = torch.full((r,), -1, dtype=torch.int32, device=dev)
    if r == 0:
        return t_out, i_out
    fn = _build.function("ray_box", "ray_box_nearest_launch", _ARGS)
    with torch.cuda.device(dev):
        err = fn(*(x.data_ptr() for x in a), r, box_lo.shape[0], dim,
                 t_out.data_ptr(), i_out.data_ptr(), _stream(dev))
    _build.check("ray_box", err, what)
    ray_box_nearest.launches += 1
    return t_out, i_out


ray_box_nearest.launches = 0
