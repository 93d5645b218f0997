"""LBVH hierarchy search (Karras ranges) and the build's tail.

``karras_ranges`` computes, for every internal node i, the sorted-leaf
range ``[first, last]`` it covers and its split ``gamma``. On a CUDA
tensor it launches the hand-written kernel ``csrc/karras.cu``; on a CPU
tensor it runs :func:`karras_ranges_fused`, the plain PyTorch twin of
``repro.kernels.lbvh_build.karras_ranges_fused`` (a sparse min-table over
the adjacent prefix deltas, then two descending power-of-two searches).
Both give the integers of the reference, bit for bit.

``lbvh_tail`` turns the ranges and the Morton permutation into the tree:
the Apetrei links, every node's box, range_last, the ropes in closed form,
leaf_perm and, in 3-D, the (2N-1, 8) int32 node records the 3-D walks read
(``bvh_traverse.pack_nodes``); ``lbvh_refit`` recomputes the boxes and
records over a kept topology. On a CUDA tensor each launches
``csrc/lbvh_tail.cu`` (links and ropes, then a bottom-up climb with one
atomic counter a node, ArborX's construction); on a CPU tensor each runs its
plain twin (:func:`lbvh_tail_ref`, :func:`lbvh_refit_ref`): the
reference's closed forms and its RMQ sparse table (:func:`aabb_rmq`, the
high corner negated in the same table). Every field equals the
reference's node for node: min and max are exact in any order, NaN
propagates, and -0 orders below +0 as in XLA's minimum and maximum
(:func:`aabb_rmq` settles the zeros so; ``torch.minimum`` alone returns
either operand on a tie of zeros).
"""
from __future__ import annotations

import ctypes

import torch

from ..core import morton as M
from . import _build, sanitize
from .bvh_traverse import _device_of, _stream, pack_nodes

__all__ = ["karras_ranges", "karras_ranges_fused", "aabb_rmq", "lbvh_tail",
           "lbvh_tail_ref", "lbvh_refit", "lbvh_refit_ref", "max_log2"]

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
# the build's tail: plain twins
# ---------------------------------------------------------------------------

def _min_zeros(a, b):
    """torch.minimum with -0 below +0, as XLA's minimum (``torch.minimum``
    returns either operand when they are zeros of two signs); NaN
    propagates."""
    tie = (a.view(torch.int32) | b.view(torch.int32)).view(torch.float32)
    return torch.where(a == b, tie, torch.minimum(a, b))


def aabb_rmq(leaf_lo, leaf_hi, first, last, max_log2: int):
    """Internal-node AABBs over sorted leaf boxes: (N-1, dim) lo and hi.

    The (L, N, 2*dim) table is filled level by level in one allocation
    (no second stacked copy): row k entry m is the min over leaves
    [m, m + 2^k), the hi bound negated (max(x) == -min(-x), exact).
    Same float min operations in the same order as the reference, with
    its zeros (:func:`_min_zeros`)."""
    n, dim = leaf_lo.shape
    tbl = torch.empty((max_log2 + 1, n, 2 * dim), dtype=leaf_lo.dtype,
                      device=leaf_lo.device)
    tbl[0, :, :dim] = leaf_lo
    torch.neg(leaf_hi, out=tbl[0, :, dim:])
    for k in range(1, max_log2 + 1):
        h = 1 << (k - 1)
        # min(prev[m], prev[m + h]), +inf padding past the end (a copy)
        tbl[k, :n - h] = _min_zeros(tbl[k - 1, :n - h], tbl[k - 1, h:])
        tbl[k, n - h:] = tbl[k - 1, n - h:]
    first = first.to(torch.int64)
    last = last.to(torch.int64)
    length = last - first + 1
    k = 31 - M._clz32(length)
    off = last - (1 << k) + 1
    combo = _min_zeros(tbl[k, first], tbl[k, off])
    return combo[:, :dim], -combo[:, dim:]


def max_log2(n: int) -> int:
    """The levels of the twins' sparse tables over N leaves: the bit length
    of N - 1, at least 1."""
    return max((n - 1).bit_length(), 1)


def lbvh_tail_ref(first, last, gamma, perm, box_lo, box_hi):
    """The tail kernel's plain twin: (node_lo, node_hi, left_child,
    right_child, rope, range_last, leaf_perm, records) of the tree whose
    Karras ranges are (first, last, gamma) (N-1,) int32 and whose sorted
    position p holds leaf perm[p] of the boxes (N, dim); records None
    outside 3-D."""
    n, dim = box_lo.shape
    dev = box_lo.device
    perm = perm.to(torch.int64)
    leaf_lo = box_lo[perm]
    leaf_hi = box_hi[perm]
    # Apetrei links: the child at gamma / gamma+1 is a leaf exactly when it
    # coincides with the range end
    left_child = torch.where(gamma == first, (n - 1) + gamma, gamma).to(torch.int32)
    right_child = torch.where(gamma + 1 == last, (n - 1) + gamma + 1,
                              gamma + 1).to(torch.int32)
    int_lo, int_hi = aabb_rmq(leaf_lo, leaf_hi, first, last, max_log2(n))
    node_lo = torch.cat([int_lo, leaf_lo], 0)
    node_hi = torch.cat([int_hi, leaf_hi], 0)
    # ropes in closed form: the splits are a bijection onto [0, N-2]
    split_owner = torch.zeros((n - 1,), dtype=torch.int64, device=dev)
    split_owner[gamma.to(torch.int64)] = torch.arange(n - 1, device=dev)
    leaf_pos = torch.arange(n, dtype=torch.int32, device=dev)
    range_last = torch.cat([last, leaf_pos]).to(torch.int32)
    safe_last = torch.clamp(range_last, 0, n - 2).to(torch.int64)
    rope = torch.where(range_last >= n - 1, -1,
                       right_child[split_owner[safe_last]]).to(torch.int32)
    leaf_perm = perm.to(torch.int32)
    records = pack_nodes(node_lo, node_hi, rope, left_child, leaf_perm) \
        if dim == 3 else None
    return (node_lo, node_hi, left_child, right_child, rope, range_last,
            leaf_perm, records)


def lbvh_refit_ref(left_child, right_child, rope, range_first, range_last,
                   leaf_perm, box_lo, box_hi):
    """The refit's plain twin: (node_lo, node_hi, records) of the kept
    topology over new boxes (N, dim) in the build input's order: one RMQ
    pass over the ranges, no sort; records None outside 3-D."""
    n, dim = box_lo.shape
    perm = leaf_perm.to(torch.int64)
    leaf_lo = box_lo[perm]
    leaf_hi = box_hi[perm]
    int_lo, int_hi = aabb_rmq(leaf_lo, leaf_hi, range_first,
                              range_last[:n - 1], max_log2(n))
    node_lo = torch.cat([int_lo, leaf_lo], 0)
    node_hi = torch.cat([int_hi, leaf_hi], 0)
    records = pack_nodes(node_lo, node_hi, rope, left_child, leaf_perm) \
        if dim == 3 else None
    return node_lo, node_hi, records


# ---------------------------------------------------------------------------
# the tail kernel's wrappers
# ---------------------------------------------------------------------------

_TAIL_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 10
_REFIT_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 5


def _boxes(what, box_lo, box_hi, n):
    if box_lo.dim() != 2 or box_lo.shape[0] != n or box_lo.shape[1] < 1 \
            or box_hi.shape != box_lo.shape:
        raise ValueError(f"{what}: boxes must be ({n}, dim) twice, got "
                         f"{tuple(box_lo.shape)} and {tuple(box_hi.shape)}")
    for name, t in (("box_lo", box_lo), ("box_hi", box_hi)):
        if t.dtype != torch.float32:
            raise ValueError(f"{what}: {name} must be float32, got {t.dtype}")
    return box_lo.contiguous(), box_hi.contiguous()


def _ints(what, n, **tensors):
    out = []
    for name, (t, size, dtype) in tensors.items():
        if t.shape != (size,):
            raise ValueError(f"{what}: {name} must be ({size},), got "
                             f"{tuple(t.shape)}")
        out.append(t.to(dtype).contiguous())
    return out


def _on_one_device(what, *tensors):
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{what}: tensors on {t.device} and {dev}")
    return _device_of(tensors[0], what)


def lbvh_tail(first, last, gamma, perm, box_lo, box_hi):
    """The tree from its Karras ranges (first, last, gamma) (N-1,) int32
    and the Morton permutation `perm` (N,) (sorted position -> index into
    the boxes (N, dim) float32): (node_lo, node_hi, left_child,
    right_child, rope, range_last, leaf_perm, records), records the (2N-1,
    8) int32 node records in 3-D, else None. CPU tensors take
    :func:`lbvh_tail_ref`; CUDA tensors launch ``csrc/lbvh_tail.cu``."""
    what = "lbvh_tail"
    n = perm.shape[0]
    if n < 2:
        raise ValueError(f"{what}: needs N >= 2 leaves, got {n}")
    if _on_one_device(what, first, last, gamma, perm, box_lo,
                      box_hi) == "cpu":
        return lbvh_tail_ref(first, last, gamma, perm, box_lo, box_hi)
    lo, hi = _boxes(what, box_lo, box_hi, n)
    f, l_, g, p = _ints(what, n, first=(first, n - 1, torch.int32),
                        last=(last, n - 1, torch.int32),
                        gamma=(gamma, n - 1, torch.int32),
                        perm=(perm, n, torch.int64))
    dev, dim = lo.device, lo.shape[1]

    def ints(*size):
        return torch.empty(size, dtype=torch.int32, device=dev)

    node_lo = torch.empty((2 * n - 1, dim), dtype=torch.float32, device=dev)
    node_hi = torch.empty_like(node_lo)
    left, right = ints(n - 1), ints(n - 1)
    rope, range_last, leaf_perm = ints(2 * n - 1), ints(2 * n - 1), ints(n)
    records = ints(2 * n - 1, 8) if dim == 3 else None
    scratch = ints(4 * n - 3)
    fn = _build.function("lbvh_tail", "lbvh_tail_launch", _TAIL_ARGS)
    with torch.cuda.device(dev):
        err = fn(f.data_ptr(), l_.data_ptr(), g.data_ptr(), p.data_ptr(),
                 lo.data_ptr(), hi.data_ptr(), n, dim, node_lo.data_ptr(),
                 node_hi.data_ptr(), left.data_ptr(), right.data_ptr(),
                 rope.data_ptr(), range_last.data_ptr(), leaf_perm.data_ptr(),
                 None if records is None else records.data_ptr(),
                 scratch.data_ptr(), _stream(dev))
    _build.check("lbvh_tail", err, what)
    lbvh_tail.launches += 1
    return (node_lo, node_hi, left, right, rope, range_last, leaf_perm,
            records)


lbvh_tail.launches = 0


def lbvh_refit(left_child, right_child, rope, range_first, range_last,
               leaf_perm, box_lo, box_hi):
    """(node_lo, node_hi, records) of a kept topology over new boxes (N,
    dim) float32 in the build input's order; records as
    :func:`lbvh_tail`. CPU tensors take :func:`lbvh_refit_ref`; CUDA
    tensors launch ``csrc/lbvh_tail.cu``'s refit entry (the bottom-up
    climb alone), counted in ``lbvh_tail.launches``."""
    what = "lbvh_refit"
    n = leaf_perm.shape[0]
    if n < 2:
        raise ValueError(f"{what}: needs N >= 2 leaves, got {n}")
    if _on_one_device(what, left_child, right_child, rope, range_first,
                      range_last, leaf_perm, box_lo, box_hi) == "cpu":
        return lbvh_refit_ref(left_child, right_child, rope, range_first,
                              range_last, leaf_perm, box_lo, box_hi)
    lo, hi = _boxes(what, box_lo, box_hi, n)
    left, right, rp, perm = _ints(
        what, n, left_child=(left_child, n - 1, torch.int32),
        right_child=(right_child, n - 1, torch.int32),
        rope=(rope, 2 * n - 1, torch.int32),
        leaf_perm=(leaf_perm, n, torch.int32))
    dev, dim = lo.device, lo.shape[1]
    node_lo = torch.empty((2 * n - 1, dim), dtype=torch.float32, device=dev)
    node_hi = torch.empty_like(node_lo)
    records = torch.empty((2 * n - 1, 8), dtype=torch.int32, device=dev) \
        if dim == 3 else None
    scratch = torch.empty((4 * n - 3,), dtype=torch.int32, device=dev)
    fn = _build.function("lbvh_tail", "lbvh_refit_launch", _REFIT_ARGS)
    with torch.cuda.device(dev):
        err = fn(left.data_ptr(), right.data_ptr(), rp.data_ptr(),
                 perm.data_ptr(), lo.data_ptr(), hi.data_ptr(), n, dim,
                 node_lo.data_ptr(), node_hi.data_ptr(),
                 None if records is None else records.data_ptr(),
                 scratch.data_ptr(), _stream(dev))
    _build.check("lbvh_tail", err, what)
    lbvh_tail.launches += 1
    return node_lo, node_hi, records
