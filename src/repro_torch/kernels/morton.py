"""Morton encoding on the card: ``morton64`` (the stand-alone op) and
``morton_key`` (the LBVH build's step), with their plain twins
``morton64_ref`` and ``morton_key_ref``.

``morton64``: for N points (N, dim) and the scene bounds (dim,) it returns
the 64-bit Morton code of every point as an (hi, lo) pair of (N,) int64
tensors, each holding an unsigned 32-bit half: the convention of
``core.morton``. The values equal the uint32 lanes of the reference's
``repro.kernels.ops.morton64``. The bits per dimension follow the
reference's rule (``core.morton.bits_per_dim``: ``min(64 // dim, 21)`` up
to dim 6, ``64 // dim`` above).

``morton_key``: for the leaf boxes (N, dim) of a build, the one (N,) int64
sort key a leaf of the build's 32- or 64-bit codes (``core.morton.key_of``)
of the box centroids ``0.5 * (lo + hi)`` in the centroids' own scene (min
and max), as ``repro.core.lbvh.build`` computes them.

A CPU tensor takes the twin: ``core.morton``'s quantization, operation for
operation, and its interleave. A CUDA tensor launches ``csrc/morton.cu``
(templated instances for dims 1 to 6, the interleave by shifts and masks;
the build's step as a scene pass, its final reduction and a key pass in
one C call); any other device raises. The two agree bit for bit, NaN and
infinite coordinates included. The kernel's launch count, from either
entry, is ``morton64.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from ..core import morton as M
from . import _build
from .bvh_traverse import _device_of, _stream

__all__ = ["morton64", "morton64_ref", "morton_key", "morton_key_ref"]


def morton64_ref(coords, scene_lo, scene_hi):
    """The kernel's plain twin: ``core.morton.morton64``."""
    return M.morton64(coords, scene_lo, scene_hi)


_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
_KEY_ARGS = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
#: most partials of the key entry's scene pass (kMaxParts of csrc/morton.cu)
MAX_PARTS = 256


def key_scratch(dim: int, device) -> torch.Tensor:
    """The key entry's scratch: the scene pass's partials, then the scene."""
    return torch.empty((2 * dim * (MAX_PARTS + 1),), dtype=torch.float32,
                       device=device)


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


def morton_key_ref(box_lo, box_hi, bits: int = 64):
    """The build step's plain twin: the centroids, their scene, the codes
    through ``core.morton`` and their sort key."""
    c = 0.5 * (box_lo + box_hi)
    scene_lo, scene_hi = c.amin(0), c.amax(0)
    morton = M.morton64 if bits == 64 else M.morton32
    return M.key_of(morton(c, scene_lo, scene_hi))


def morton_key(box_lo, box_hi, bits: int = 64):
    """(N,) int64 sort keys (``core.morton.key_of``) of the `bits`-bit
    Morton codes of the centroids of the float32 boxes (N, dim) in their
    own scene: the LBVH build's step."""
    what = "morton_key"
    if bits not in (32, 64):
        raise ValueError(f"{what}: bits must be 32 or 64, got {bits}")
    if box_lo.dim() != 2 or box_lo.shape[1] < 1 or \
            box_hi.shape != box_lo.shape:
        raise ValueError(f"{what}: boxes must be (N, dim) twice, got "
                         f"{tuple(box_lo.shape)} and {tuple(box_hi.shape)}")
    for name, t in (("box_lo", box_lo), ("box_hi", box_hi)):
        if t.dtype != torch.float32:
            raise ValueError(f"{what}: {name} must be float32, got {t.dtype}")
    if box_hi.device != box_lo.device:
        raise ValueError(f"{what}: box_hi is on {box_hi.device}, not "
                         f"{box_lo.device}")
    if _device_of(box_lo, what) == "cpu":
        return morton_key_ref(box_lo, box_hi, bits)
    dev = box_lo.device
    n, dim = box_lo.shape
    key = torch.empty((n,), dtype=torch.int64, device=dev)
    if n == 0:
        return key
    parts = key_scratch(dim, dev)
    lo, hi = box_lo.contiguous(), box_hi.contiguous()
    fn = _build.function("morton", "morton_key_launch", _KEY_ARGS)
    with torch.cuda.device(dev):
        err = fn(lo.data_ptr(), hi.data_ptr(), n, dim, bits,
                 parts.data_ptr(), key.data_ptr(), _stream(dev))
    _build.check("morton", err, what)
    morton64.launches += 1
    return key
