"""LBVH hierarchy search (Karras ranges) and the RMQ AABB pass.

``karras_ranges`` computes, for every internal node i, the sorted-leaf
range ``[first, last]`` it covers and its split ``gamma``. On a CUDA
tensor it launches the hand-written kernel ``csrc/karras.cu``; on a CPU
tensor it runs :func:`karras_ranges_fused`, the plain PyTorch twin of
``repro.kernels.lbvh_build.karras_ranges_fused`` (a sparse min-table over
the adjacent prefix deltas, then two descending power-of-two searches).
Both give the integers of the reference, bit for bit.

``aabb_rmq`` is plain PyTorch: internal boxes as range minima over a
sparse table of the sorted leaf boxes (the high corner rides negated in
the same table).
"""
from __future__ import annotations

import ctypes

import torch

from ..core import morton as M
from . import _build, sanitize

__all__ = ["karras_ranges", "karras_ranges_fused", "aabb_rmq"]

_BIG = torch.iinfo(torch.int32).max


# ---------------------------------------------------------------------------
# plain twin
# ---------------------------------------------------------------------------

def _delta_table(dadj, max_log2: int):
    """Sparse min-table over the (N-1,) adjacent deltas, flattened to
    (L * (N-1),): row k entry m is min(dadj[m : m + 2^k]), windows past
    the end padded with +BIG."""
    n1 = dadj.shape[0]
    tbl = torch.empty((max_log2 + 1, n1), dtype=dadj.dtype, device=dadj.device)
    tbl[0] = dadj
    for k in range(1, max_log2 + 1):
        h = 1 << (k - 1)
        tbl[k] = tbl[k - 1]
        if h < n1:
            torch.minimum(tbl[k - 1, :n1 - h], tbl[k - 1, h:], out=tbl[k, :n1 - h])
    return tbl.reshape(-1)


def _rmq_delta(tbl_flat, n1: int, i, j):
    """delta(i, j) from the min-table; -1 where j is outside [0, n1]."""
    ok = (j >= 0) & (j <= n1)
    jc = torch.clamp(j, 0, n1)
    a = torch.minimum(i, jc)
    b = torch.maximum(i, jc)
    length = torch.clamp_min(b - a, 1)
    k = 31 - M._clz32(length)
    last = tbl_flat.shape[0] - 1
    lo = tbl_flat[torch.clamp(k * n1 + a, 0, last)]
    hi = tbl_flat[torch.clamp(k * n1 + (b - (1 << k)), 0, last)]
    return torch.where(ok, torch.minimum(lo, hi), -1)


def _descend_search(probe, threshold, max_log2: int, zero):
    """Largest m >= 0 with probe(m) > threshold, for nonincreasing probe."""
    m = zero
    for k in range(max_log2, -1, -1):
        t = 1 << k
        m = torch.where(probe(m + t) > threshold, m + t, m)
    return m


def karras_ranges_fused(hi, lo, idx, n: int, max_log2: int):
    """Plain twin of the kernel: (first, last, gamma), (N-1,) int32 each.
    Keys are int64 tensors holding uint32 lanes."""
    n1 = n - 1
    dadj = M.delta_from_keys(hi, lo, idx).to(torch.int64)
    tbl = _delta_table(dadj, max_log2)

    i = torch.arange(n1, dtype=torch.int64, device=hi.device)
    d_r = dadj
    d_l = torch.cat([torch.full((1,), -1, dtype=torch.int64, device=hi.device),
                     dadj[:-1]])
    d = torch.where(d_r > d_l, 1, -1)
    delta_min = torch.where(d > 0, d_l, d_r)

    def delta(j):
        return _rmq_delta(tbl, n1, i, j)

    zero = torch.zeros_like(i)
    l = _descend_search(lambda m: delta(i + m * d), delta_min, max_log2, zero)
    j = i + l * d
    first = torch.minimum(i, j)
    last = torch.maximum(i, j)

    delta_node = delta(j)
    s = _descend_search(lambda m: delta(i + m * d), delta_node, max_log2, zero)
    gamma = i + s * d + torch.clamp_max(d, 0)
    return (first.to(torch.int32), last.to(torch.int32),
            gamma.to(torch.int32))


# ---------------------------------------------------------------------------
# the kernel's wrapper
# ---------------------------------------------------------------------------

_LAUNCH_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 4


def karras_ranges(hi, lo, idx, n: int, max_log2: int):
    """(first, last, gamma) (N-1,) int32 for the sorted, distinct 96-bit
    keys (hi | lo | idx), each an (N,) int64 tensor of uint32 values.

    CPU tensors take the plain twin; CUDA tensors launch
    ``csrc/karras.cu`` (one thread per internal node, reading the int64
    lanes as they are; its searches stop where the node's range does, so
    `max_log2` bounds only the twin's); any other device raises. Under
    ``REPRO_SANITIZE`` the twin also runs beside the kernel and must agree
    with it bit for bit (the reference's build-conformance check), and
    each result is held to ``sanitize.check_karras``."""
    what = "karras_ranges"
    if hi.device.type == "cpu":
        out = karras_ranges_fused(hi, lo, idx, n, max_log2)
        sanitize.check_karras(*out, n=n, kernel="karras_ranges_fused")
        return out
    out = _karras_launch(hi, lo, idx, n, max_log2)
    if sanitize.enabled():
        twin = karras_ranges_fused(hi, lo, idx, n, max_log2)
        if not all(torch.equal(a, b) for a, b in zip(out, twin)):
            raise AssertionError(f"REPRO_SANITIZE: the {what} kernel "
                                 "disagrees with karras_ranges_fused")
        for r, kern in ((out, what), (twin, "karras_ranges_fused")):
            sanitize.check_karras(*r, n=n, kernel=kern)
    return out


def _karras_launch(hi, lo, idx, n: int, max_log2: int):
    dev = hi.device
    if dev.type != "cuda":
        raise ValueError(f"karras_ranges: no kernel for device {dev}")
    for name, t in (("hi", hi), ("lo", lo), ("idx", idx)):
        if t.shape != (n,) or t.device != dev:
            raise ValueError(f"karras_ranges: {name} must be ({n},) on {dev}, "
                             f"got {tuple(t.shape)} on {t.device}")
    if n < 2 or (1 << (max_log2 + 1)) <= n - 1:
        raise ValueError(f"karras_ranges: need n >= 2 and 2^(max_log2+1) > "
                         f"n - 1, got n={n}, max_log2={max_log2}")
    # the kernel reads the int64 lanes and takes their low 32 bits
    keys = [t.to(torch.int64).contiguous() for t in (hi, lo, idx)]
    out = [torch.empty((n - 1,), dtype=torch.int32, device=dev)
           for _ in range(3)]
    fn = _build.function("karras", "karras_ranges_launch", _LAUNCH_ARGS)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*(k.data_ptr() for k in keys), n,
                 *(o.data_ptr() for o in out), stream)
    _build.check("karras", err, "karras_ranges")
    karras_ranges.launches += 1
    return tuple(out)


karras_ranges.launches = 0


# ---------------------------------------------------------------------------
# AABB reduce: RMQ sparse table (plain PyTorch)
# ---------------------------------------------------------------------------

def aabb_rmq(leaf_lo, leaf_hi, first, last, max_log2: int):
    """Internal-node AABBs over sorted leaf boxes: (N-1, dim) lo and hi.

    The (L, N, 2*dim) table is filled level by level in one allocation
    (no second stacked copy): row k entry m is the min over leaves
    [m, m + 2^k), the hi bound negated (max(x) == -min(-x), exact).
    Same float min operations in the same order as the reference."""
    n, dim = leaf_lo.shape
    tbl = torch.empty((max_log2 + 1, n, 2 * dim), dtype=leaf_lo.dtype,
                      device=leaf_lo.device)
    tbl[0, :, :dim] = leaf_lo
    torch.neg(leaf_hi, out=tbl[0, :, dim:])
    for k in range(1, max_log2 + 1):
        h = 1 << (k - 1)
        # min(prev[m], prev[m + h]), +inf padding past the end (a copy)
        torch.minimum(tbl[k - 1, :n - h], tbl[k - 1, h:], out=tbl[k, :n - h])
        tbl[k, n - h:] = tbl[k - 1, n - h:]
    first = first.to(torch.int64)
    last = last.to(torch.int64)
    length = last - first + 1
    k = 31 - M._clz32(length)
    off = last - (1 << k) + 1
    combo = torch.minimum(tbl[k, first], tbl[k, off])
    return combo[:, :dim], -combo[:, dim:]
