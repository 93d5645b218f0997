"""Exact brute-force k nearest neighbours: ``bruteforce_knn``, with its
plain twin ``bruteforce_knn_ref``.

For Q queries and N points (float32, (Q, dim) and (N, dim)) it returns
per query the k smallest euclidean distances over all points, ascending,
and their point indices: (Q, k) float32 and (Q, k) int32, ties to the
lower index. Distances are the square roots of

    d2 = max((|q|^2 - 2 q.p) + |p|^2, 0)

taken in the float order XLA:CPU gives the reference's kernel
(``repro.kernels.bruteforce_knn._knn_kernel``) up to dim 10: |q|^2 and
|p|^2 with every square rounded, summed from dimension 0; q.p as q0*p0,
then one fused multiply-add per further dimension. Both agree with the
reference bit for bit there.

k > N reproduces the reference's tail: past the last point a row holds
(inf, T), where T is -1 when the reference swept the points in one panel
(N <= bn) and, with more panels, the index of the query's nearest point
below the start of the last panel, ``tail_from(n, bn)``. So ``bn`` changes
a result only in that tail.

A CPU tensor takes the twin, which streams the points in chunks, forms
d2 in the same order (``geometry.fma`` for the exact float32 FMA,
``geometry.sqrt`` for the correctly rounded root) and merges each chunk
into the running best with a stable sort. A CUDA tensor launches
``csrc/bruteforce_knn.cu``; any other device raises. The kernel cuts the
point axis into chunks (:func:`plan`, one boundary at ``tail_from``), one
block row each, writes each chunk's k best per query to scratch and
merges them in chunk order by the key (d2, index), which is the twin's
answer bit for bit; when one chunk covers every point it writes the
result directly. A call counts once in ``bruteforce_knn.launches``,
though a split call runs two kernels (the scan, then the merge).
"""
from __future__ import annotations

import ctypes

import torch

from ..core import geometry as G
from . import _build
from .bvh_traverse import _device_of, _stream

__all__ = ["bruteforce_knn", "bruteforce_knn_ref", "tail_from", "plan",
           "splits", "queries_per_block", "MAX_K", "MAX_DIM"]

#: largest k the kernel takes (the reference's REPROLINT_MAX_K)
MAX_K = 256
#: widest rows the kernel takes (one point's row fills at most a tile)
MAX_DIM = 8192
#: query x point x dim elements of one chunk of the twin
_CHUNK_ELEMENTS = 1 << 24
#: threads of a scan block (kThreads of csrc/bruteforce_knn.cu)
THREADS = 128
#: 3-D points per shared-memory stage (kTile3): chunks are multiples of it
TILE = 512
#: blocks the scan's grid aims at per SM: fewer, longer chunks, since
#: each chunk's list starts empty and fills by inserts (on an H100 at
#: Q = 2^13, N = 2^20, k = 10, scripts/knn_variants.py: 576 blocks
#: beat 1,152 by 3.5 %, and 320 blocks took 1.24 times as long)
BLOCKS_PER_SM = 4
#: a chunk holds at least this many points per list entry, so that each
#: chunk's list settles before its end (k = 256 at N = 2^16 on an H100:
#: chunks of 8,192 points beat 4,096 by 13 %)
MIN_POINTS_PER_ENTRY = 32
#: the most the (S, k, Q) scratch lists may take
SCRATCH_BYTES = 256 << 20
#: the most block rows a grid may have (gridDim.y)
_MAX_SPLITS = 65535


def tail_from(n: int, bn: int = 512) -> int:
    """Start of the last panel of the reference's sweep over n points in
    panels of ``min(bn, round_up(n, 8))``: 0 for one panel."""
    bn_eff = min(bn, (n + 7) // 8 * 8)
    return (-(-n // bn_eff) - 1) * bn_eff


def splits(n: int, tail: int, chunk: int) -> int:
    """Block rows of a scan of n points in chunks of `chunk`, one boundary
    at `tail` (= ``tail_from``): 1 when one chunk covers every point."""
    if chunk >= n:
        return 1
    return -(-tail // chunk) + -(-(n - tail) // chunk)


def queries_per_block(k: int) -> int:
    """Queries of a scan block: THREADS times kQueriesPerThread of the
    kernel (two for lists of up to 32 entries, one above)."""
    return THREADS * (2 if k <= 32 else 1)


def plan(q: int, n: int, k: int, tail: int, sms: int) -> int:
    """Points per chunk of the scan: enough chunks that the grid gives
    about BLOCKS_PER_SM blocks per SM, each chunk a multiple of TILE and
    at least MIN_POINTS_PER_ENTRY * k points, the scratch within
    SCRATCH_BYTES and the rows within the grid's limit."""
    q_blocks = -(-q // queries_per_block(k))
    want = max(1, -(-BLOCKS_PER_SM * sms // q_blocks))
    least = -(-MIN_POINTS_PER_ENTRY * k // TILE) * TILE
    chunk = max(least, -(-(-(-n // want)) // TILE) * TILE)
    while True:
        s = splits(n, tail, chunk)
        if s == 1 or (s <= _MAX_SPLITS and q * s * k * 8 <= SCRATCH_BYTES):
            return chunk
        chunk *= 2


def _check(what, queries, points, k, bn):
    if queries.dim() != 2 or points.dim() != 2 \
            or queries.shape[1] != points.shape[1]:
        raise ValueError(f"{what}: queries and points must be (Q, dim) and "
                         f"(N, dim), got {tuple(queries.shape)} and "
                         f"{tuple(points.shape)}")
    if not 1 <= queries.shape[1] <= MAX_DIM:
        raise ValueError(f"{what}: dim must be in 1..{MAX_DIM}, got "
                         f"{queries.shape[1]}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"{what}: k must be in 1..{MAX_K}, got {k}")
    if bn < 1:
        raise ValueError(f"{what}: bn must be >= 1, got {bn}")
    for name, t in (("queries", queries), ("points", points)):
        if t.dtype != torch.float32:
            raise ValueError(f"{what}: {name} must be float32, got {t.dtype}")
    if points.device != queries.device:
        raise ValueError(f"{what}: points are on {points.device}, not "
                         f"{queries.device}")


def _empty(q, k, dev):
    return (torch.full((q, k), float("inf"), dtype=torch.float32, device=dev),
            torch.full((q, k), -1, dtype=torch.int32, device=dev))


def bruteforce_knn_ref(queries, points, k: int, *, bn: int = 512):
    """The kernel's plain twin: chunks of points (split at
    ``tail_from``), d2 in the kernel's float order, a stable-sort merge."""
    q, dim = queries.shape
    n = points.shape[0]
    dev = queries.device
    best_d, best_i = _empty(q, k, dev)
    if q == 0 or n == 0:
        return best_d, best_i
    b = tail_from(n, bn)
    q2 = G.sum_sq(queries)[:, None]
    chunk = max(1, _CHUNK_ELEMENTS // (q * dim))
    tail = None
    for lo, hi in ((0, b), (b, n)):
        for s in range(lo, hi, chunk):
            if s == b and tail is None:
                tail = best_i[:, 0].clone()
            p = points[s:min(s + chunk, hi)]
            qp = queries[:, None, 0] * p[None, :, 0]
            for c in range(1, dim):
                qp = G.fma(queries[:, None, c], p[None, :, c], qp)
            d2 = torch.clamp_min((q2 - 2.0 * qp) + G.sum_sq(p)[None, :], 0.0)
            d2 = torch.where(d2 < float("inf"), d2, float("inf"))  # NaN too
            idx = torch.arange(s, s + p.shape[0], dtype=torch.int32,
                               device=dev)
            cand_d = torch.cat([best_d, d2], 1)
            cand_i = torch.cat([best_i, idx[None, :].expand(q, -1)], 1)
            order = torch.sort(cand_d, dim=1, stable=True).indices[:, :k]
            best_d = torch.gather(cand_d, 1, order)
            best_i = torch.gather(cand_i, 1, order)
            best_i = torch.where(torch.isinf(best_d), -1, best_i)
    best_i = torch.where(best_i < 0, tail[:, None], best_i)
    return G.sqrt(best_d), best_i


_ARGS = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 6
         + [ctypes.c_void_p] * 5)


def bruteforce_knn(queries, points, k: int, *, bn: int = 512):
    """(dists, idxs) (Q, k) float32 / int32: each query's k nearest points,
    ascending, ties to the lower index; past N the reference's tail (see
    the module docstring). queries (Q, dim), points (N, dim), float32,
    1 <= k <= MAX_K."""
    what = "bruteforce_knn"
    _check(what, queries, points, k, bn)
    if _device_of(queries, what) == "cpu":
        return bruteforce_knn_ref(queries, points, k, bn=bn)
    dev = queries.device
    q, n = queries.shape[0], points.shape[0]
    if q == 0 or n == 0:
        return _empty(q, k, dev)
    tail = tail_from(n, bn)
    chunk = plan(q, n, k, tail, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    return _launch(queries, points, k, tail, chunk)


def _launch(queries, points, k, tail, chunk):
    """The kernel on (Q, dim) queries and (N, dim) points of one card,
    Q, N >= 1, with the point axis in chunks of `chunk` (one boundary at
    `tail`): (dists, idxs)."""
    dev = queries.device
    q, dim = queries.shape
    n = points.shape[0]
    s = splits(n, tail, chunk)
    dists = torch.empty((q, k), dtype=torch.float32, device=dev)
    idxs = torch.empty((q, k), dtype=torch.int32, device=dev)
    part_d = part_i = None
    if s > 1:
        part_d = torch.empty((s, k, q), dtype=torch.float32, device=dev)
        part_i = torch.empty((s, k, q), dtype=torch.int32, device=dev)
    a = [t.contiguous() for t in (queries, points)]
    fn = _build.function("bruteforce_knn", "bruteforce_knn_launch", _ARGS)
    with torch.cuda.device(dev):
        err = fn(a[0].data_ptr(), a[1].data_ptr(), q, n, dim, k, tail, chunk,
                 dists.data_ptr(), idxs.data_ptr(),
                 None if part_d is None else part_d.data_ptr(),
                 None if part_i is None else part_i.data_ptr(), _stream(dev))
    _build.check("bruteforce_knn", err, "bruteforce_knn")
    bruteforce_knn.launches += 1
    return dists, idxs


bruteforce_knn.launches = 0
