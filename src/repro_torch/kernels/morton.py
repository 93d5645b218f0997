"""64-bit Morton encoding: ``morton64``, with its plain twin
``morton64_ref``.

For N points (N, dim) and the scene bounds (dim,) it returns the 64-bit
Morton code of every point as an (hi, lo) pair of (N,) int64 tensors,
each holding an unsigned 32-bit half: the convention of
``core.morton``, whose codes the LBVH build sorts. The values equal the
uint32 lanes of the reference's ``repro.kernels.ops.morton64``. The bits
per dimension follow the reference's rule (``core.morton.bits_per_dim``:
``min(64 // dim, 21)`` up to dim 6, ``64 // dim`` above).

A CPU tensor takes the twin, ``core.morton.morton64``: the same
quantization, operation for operation, and the same interleave. A CUDA
tensor launches ``csrc/morton.cu`` (one thread per point); any other
device raises. The two agree bit for bit on finite coordinates. The
kernel's launch count is ``morton64.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from ..core import morton as M
from . import _build
from .bvh_traverse import _device_of, _stream

__all__ = ["morton64", "morton64_ref"]


def morton64_ref(coords, scene_lo, scene_hi):
    """The kernel's plain twin: ``core.morton.morton64``."""
    return M.morton64(coords, scene_lo, scene_hi)


_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3


def morton64(coords, scene_lo, scene_hi):
    """(hi, lo) (N,) int64 tensors of uint32 values: the 64-bit Morton codes
    of float32 coords (N, dim) inside the float32 scene bounds (dim,)."""
    what = "morton64"
    if coords.dim() != 2 or coords.shape[1] < 1:
        raise ValueError(f"{what}: coords must be (N, dim), got "
                         f"{tuple(coords.shape)}")
    dim = coords.shape[1]
    for name, t in (("coords", coords), ("scene_lo", scene_lo),
                    ("scene_hi", scene_hi)):
        if t.dtype != torch.float32:
            raise ValueError(f"{what}: {name} must be float32, got {t.dtype}")
        if t.device != coords.device:
            raise ValueError(f"{what}: {name} is on {t.device}, not "
                             f"{coords.device}")
    if scene_lo.shape != (dim,) or scene_hi.shape != (dim,):
        raise ValueError(f"{what}: scene bounds must be ({dim},), got "
                         f"{tuple(scene_lo.shape)} and {tuple(scene_hi.shape)}")
    if _device_of(coords, what) == "cpu":
        return morton64_ref(coords, scene_lo, scene_hi)
    dev = coords.device
    n = coords.shape[0]
    hi = torch.empty((n,), dtype=torch.int64, device=dev)
    lo = torch.empty((n,), dtype=torch.int64, device=dev)
    if n == 0:
        return hi, lo
    a = [t.contiguous() for t in (coords, scene_lo, scene_hi)]
    fn = _build.function("morton", "morton64_launch", _ARGS)
    with torch.cuda.device(dev):
        err = fn(*(t.data_ptr() for t in a), n, dim, M.bits_per_dim(dim),
                 hi.data_ptr(), lo.data_ptr(), _stream(dev))
    _build.check("morton", err, what)
    morton64.launches += 1
    return hi, lo


morton64.launches = 0
