"""Standard callbacks (reference ``repro.core.callbacks``): each factory
returns ``(cb, state0)`` with an unbatched ``state0`` that
``Index.query(callback=)`` gives a leading query axis.

``cb`` follows the batched contract of ``traversal`` (every argument
carries the lanes stepped together). The first five factories and
DBSCAN's ``_min_where`` return an :class:`Epilogue`: a small frozen
object whose ``__call__`` is the batched torch body and whose ``kind``
and integer parameters select the instance of the fused CUDA kernel
(``kernels.bvh_callback``). ``sum_payload`` and any other Python
callable stay plain callables and take the loop route.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["Epilogue", "counting", "count_with_limit", "min_distance",
           "collect_first_k", "collect_hits", "sum_payload"]


def _no(index):
    return torch.zeros(index.shape, dtype=torch.bool, device=index.device)


class Epilogue:
    """A callback the fused kernel runs in its epilogue. ``kind`` names the
    kernel instance; :meth:`layout` gives the state the kernel keeps, one
    (trailing shape, dtype) per state leaf."""
    kind: str = ""

    def layout(self):
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class _Counting(Epilogue):
    kind = "counting"

    def layout(self):
        return (((), torch.int32),)

    def __call__(self, state, pred, value, index, t):
        return state + 1, _no(index)


@dataclasses.dataclass(frozen=True)
class _CountWithLimit(Epilogue):
    limit: int
    kind = "count_with_limit"

    def layout(self):
        return (((), torch.int32),)

    def __call__(self, state, pred, value, index, t):
        new = state + 1
        return new, new >= self.limit


@dataclasses.dataclass(frozen=True)
class _MinDistance(Epilogue):
    kind = "min_distance"

    def layout(self):
        return (((), torch.float32),)

    def __call__(self, state, pred, value, index, t):
        return torch.minimum(state, t), _no(index)


def _store(count, idxs, ts, index, t, take, width):
    """Write (index, t) at slot min(count, width - 1) of the rows that
    take it."""
    pos = torch.clamp_max(count, width - 1).to(torch.int64)[:, None]
    keep = take[:, None]
    idxs = torch.where(keep, idxs.scatter(1, pos, index[:, None]), idxs)
    ts = torch.where(keep, ts.scatter(1, pos, t[:, None]), ts)
    return idxs, ts


@dataclasses.dataclass(frozen=True)
class _CollectFirstK(Epilogue):
    k: int
    early_exit: bool = True
    kind = "collect_first_k"

    def layout(self):
        return (((), torch.int32), ((self.k,), torch.int32),
                ((self.k,), torch.float32))

    def __call__(self, state, pred, value, index, t):
        count, idxs, ts = state
        take = count < self.k
        idxs, ts = _store(count, idxs, ts, index, t, take, self.k)
        count = count + take.to(count.dtype)
        done = (count >= self.k) if self.early_exit else _no(index)
        return (count, idxs, ts), done


@dataclasses.dataclass(frozen=True)
class _CollectHits(Epilogue):
    capacity: int
    kind = "collect_hits"

    def layout(self):
        return (((), torch.int32), ((self.capacity,), torch.int32),
                ((self.capacity,), torch.float32))

    def __call__(self, state, pred, value, index, t):
        count, idxs, ts = state
        idxs, ts = _store(count, idxs, ts, index, t, count < self.capacity,
                          self.capacity)
        return (count + 1, idxs, ts), _no(index)


@dataclasses.dataclass(frozen=True, eq=False)
class _MinWhere(Epilogue):
    """DBSCAN's round callback: ``min(state, where(flags[index],
    weights[index], big))`` over (N,) bool flags and int32 weights."""
    flags: torch.Tensor
    weights: torch.Tensor
    big: int
    kind = "min_where"

    def __post_init__(self):
        if self.flags.dtype != torch.bool or self.weights.dtype != torch.int32:
            raise TypeError("_min_where takes bool flags and int32 weights")
        if self.flags.shape != self.weights.shape or self.flags.dim() != 1:
            raise ValueError("_min_where: flags and weights must be (N,)")

    def layout(self):
        return (((), torch.int32),)

    def __call__(self, state, pred, value, index, t):
        i = index.to(torch.int64)
        w = torch.where(self.flags[i], self.weights[i], self.big)
        return torch.minimum(state, w), _no(index)


def counting():
    """Count matches per query. state: int32."""
    return _Counting(), torch.tensor(0, dtype=torch.int32)


def count_with_limit(limit: int):
    """Count matches, ending the query's walk once the count reaches
    `limit` (early termination: DBSCAN's core test needs only min_pts)."""
    return _CountWithLimit(int(limit)), torch.tensor(0, dtype=torch.int32)


def min_distance():
    """Smallest hit parameter t per query (0 on any spatial hit). state:
    float32, +inf without a hit."""
    return _MinDistance(), torch.tensor(float("inf"), dtype=torch.float32)


def collect_first_k(k: int, early_exit: bool = True):
    """The first k matched indices (walk order), then stop. state:
    (count, idxs (k,), ts (k,))."""
    return _CollectFirstK(int(k), bool(early_exit)), (
        torch.tensor(0, dtype=torch.int32),
        torch.full((k,), -1, dtype=torch.int32),
        torch.full((k,), float("inf"), dtype=torch.float32))


def collect_hits(capacity: int):
    """Up to `capacity` matched (index, t) pairs; the count goes on past
    capacity (the full match count). state: (count, idxs, ts)."""
    return _CollectHits(int(capacity)), (
        torch.tensor(0, dtype=torch.int32),
        torch.full((capacity,), -1, dtype=torch.int32),
        torch.full((capacity,), float("inf"), dtype=torch.float32))


def _min_where(flags, weights, big: int):
    """The (epilogue, state0) of DBSCAN's min-label round."""
    return _MinWhere(flags, weights, int(big)), torch.tensor(int(big),
                                                             dtype=torch.int32)


def sum_payload(extract):
    """Reduce a user quantity over matches: state += extract(pred, value)
    (batched rows). A plain callable: it takes the loop route."""
    def cb(state, pred, value, index, t):
        return state + extract(pred, value), _no(index)
    return cb
