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
strict < merge; a CUDA tensor launches ``csrc/ray_box.cu``; any other
device raises. t is bit-identical between the two: the slab test sums no
products. The kernel's launch count is ``ray_box_nearest.launches``.

In 3-D the kernel holds several rays per thread and cuts the box axis
into ranges (:func:`plan`), one per block row, so that a few thousand
blocks fill the card; each range's best per ray is merged as a 64-bit
key, (bits of t) << 32 | index (:func:`merge_key`, :func:`merge_decode`),
by an atomic minimum: t >= +0, whose bits order as unsigned ints, so the
smallest key is the smallest t and on equal t the lowest index, which is
the twin's answer. A second, small kernel (``ray_box_decode``, one
thread per ray) then writes (t, idx) from the keys, so a 3-D call runs
two kernels; ``ray_box_nearest.launches`` counts the call once, at the
slab-test kernel. Other dims take one thread per ray over every box, in
one kernel.
"""
from __future__ import annotations

import ctypes

import torch

from ..core import geometry as G
from . import _build
from .bvh_traverse import MAX_DIM, _device_of, _stream

__all__ = ["ray_box_nearest", "ray_box_nearest_ref", "plan", "merge_key",
           "merge_decode", "NO_HIT"]

#: ray x box x dim elements of one panel of the twin
_PANEL_ELEMENTS = 1 << 24

#: the 3-D kernel's block, boxes per shared-memory stage, stages of its
#: ring and rays per thread (kThreads3, kTile3, kStages and kRays3 of
#: csrc/ray_box.cu)
THREADS, TILE, STAGES, RAYS_PER_THREAD = 128, 256, 2, 4
#: blocks the 3-D kernel's grid aims at per SM: several resident at once,
#: over a few waves
BLOCKS_PER_SM = 16
#: the merge key of a ray no range has hit: (inf, INT32_MAX)
NO_HIT = (0x7F800000 << 32) | 0x7FFFFFFF


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


def plan(r, b, sms):
    """(splits, chunk) of the 3-D kernel: the box axis cut into `splits`
    ranges of `chunk` boxes (a multiple of TILE), enough that R rays at
    RAYS_PER_THREAD a thread give about BLOCKS_PER_SM blocks per SM."""
    ray_blocks = -(-r // (THREADS * RAYS_PER_THREAD))
    tiles = max(1, -(-b // TILE))
    want = min(tiles, max(1, -(-BLOCKS_PER_SM * sms // ray_blocks)))
    per = -(-tiles // want)
    return -(-tiles // per), per * TILE


def merge_key(t, idx):
    """(R,) int64 merge keys of per-ray (t, idx): (bits of t) << 32 | idx,
    NO_HIT where idx < 0. t >= +0 or inf."""
    key = (t.view(torch.int32).to(torch.int64) << 32) | idx.to(torch.int64)
    return torch.where(idx < 0, NO_HIT, key)


def merge_decode(keys):
    """(t, idx) of merge keys: (inf, -1) for NO_HIT."""
    miss = keys == NO_HIT
    t = (keys >> 32).to(torch.int32).view(torch.float32)
    idx = (keys & 0xFFFFFFFF).to(torch.int32)
    return (torch.where(miss, float("inf"), t),
            torch.where(miss, -1, idx).to(torch.int32))


def _aligned(t):
    """t, or a copy of it when its data is not 16-byte aligned (the bulk
    copies' rule)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
         + [ctypes.c_int] * 2 + [ctypes.c_void_p])


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
    b = box_lo.shape[0]
    a = [t.contiguous() for t in (origins, directions, box_lo, box_hi)]
    t_out = torch.full((r,), float("inf"), dtype=torch.float32, device=dev)
    i_out = torch.full((r,), -1, dtype=torch.int32, device=dev)
    if r == 0:
        return t_out, i_out
    keys, splits, chunk = None, 1, TILE
    if dim == 3:
        a[2], a[3] = _aligned(a[2]), _aligned(a[3])
        keys = torch.full((r,), NO_HIT, dtype=torch.int64, device=dev)
        splits, chunk = plan(r, b, torch.cuda.get_device_properties(
            dev).multi_processor_count)
    fn = _build.function("ray_box", "ray_box_nearest_launch", _ARGS)
    with torch.cuda.device(dev):
        err = fn(*(x.data_ptr() for x in a), r, b, dim, t_out.data_ptr(),
                 i_out.data_ptr(), None if keys is None else keys.data_ptr(),
                 splits, chunk, _stream(dev))
    _build.check("ray_box", err, what)
    ray_box_nearest.launches += 1
    return t_out, i_out


ray_box_nearest.launches = 0
