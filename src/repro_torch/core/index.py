"""The unified ``Index`` protocol: every search structure stores values
with an indexable getter and answers one ``query()``.

    index = BVH(values, policy=ExecutionPolicy(...))
    result = index.query(predicates)        # dispatch on predicate kind

    =================== ============================================
    predicate           result (a :class:`QueryResult`)
    =================== ============================================
    Intersects          CSR spatial join: values / indices / offsets
    Nearest             dense kNN: distances / indices (Q, k)
    RayIntersect        CSR of every hit: values / indices / offsets
    RayOrderedIntersect CSR of every hit sorted by t, t in distances
    RayNearest          the first k hits: distances (t) / indices
    =================== ============================================

    query(preds, callback=(cb, state0))  # the per-query final states
    query(preds, out=out_fn)             # out_fn's per-match outputs, CSR

Callbacks follow the batched contract of ``core.traversal``; ``state0``
is unbatched and gets a leading query axis. ``out_fn(pred, value, index,
t)`` takes the matches of the whole batch at once (one predicate row per
match, t = 0, as in the reference, ray predicates included) and returns
their outputs.

Backends implement a small SPI; the CSR assembly (two-pass count then
fill, capacity doubling with ``overflow``) and the output flavor live
here once:

    _query_callback_impl(preds, cb, state0_batched, policy) -> states
    _count_impl(preds, policy)           -> (Q,) int32 full counts
    _fill_impl(preds, capacity, policy)  -> (counts, idx_buf (Q, cap))
    _knn_impl(preds, policy)             -> (dists, idxs) (Q, k)
    _csr_exact(preds, policy)            -> QueryResult | None (one pass)
    _collect_with_t(preds, cap, policy)  -> (counts, idxs, ts)
    _gather_values(flat_idx, policy)     -> values container | None
    _most(counts)                        -> the largest count, as an int
"""
from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Any, NamedTuple

import torch

from . import callbacks as CB
from . import geometry as G
from . import predicates as P
from .traversal import value_at

__all__ = ["ExecutionPolicy", "Index", "QueryResult", "resolve_device",
           "placed"]


class QueryResult(NamedTuple):
    """values:    matched values (CSR flat for spatial, (Q, k) for kNN).
    indices:   matched original indices, CSR flat or (Q, k) (-1 padded).
    offsets:   (Q+1,) CSR row offsets for spatial results.
    distances: fine distances for kNN; the hit parameters t for
               RayNearest (Q, k) and RayOrderedIntersect (CSR flat).
    overflow:  True when a caller-supplied capacity was exceeded even
               after the doubling retries (the CSR result is truncated).
    """
    values: Any = None
    indices: Any = None
    offsets: Any = None
    distances: Any = None
    overflow: bool = False


def resolve_device(device) -> torch.device:
    """The device an index lives on: `device` when given, else the CUDA
    card; without a card this raises rather than run on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass ExecutionPolicy(device='cpu') to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def placed(x, device) -> torch.Tensor:
    """An algorithm's input `x` as float32 where it runs: a tensor where
    it lives (on `device` when given), an array on `device`, the CUDA card
    by default (raising without one)."""
    if isinstance(x, torch.Tensor) and device is None:
        dev = x.device
    else:
        dev = resolve_device(device)
    return torch.as_tensor(x, dtype=torch.float32, device=dev)


@dataclasses.dataclass(frozen=True)
class ExecutionPolicy:
    """Execution parameters bound to an index at construction and
    overridable per call via ``query(..., policy=...)``.

    engine:        QueryEngine choosing the route; None -> the default.
    device:        where the index (tree and values) lives; None -> the
                   CUDA card (raises when there is none).
    capacity:      default CSR width per query; None -> exact two-pass
                   sizing (count, then fill).
    max_doublings: capacity-doubling fill retries before ``overflow``.
    combine:       distributed only: the monoid folding the ranks' callback
                   states, in rank order (None -> their elementwise sum,
                   right for zero-initialized arithmetic states).
                   Single-process indexes ignore it.
    route_table:   a RouteTable (or a path to a persisted one, loaded and
                   validated here) overriding the engine's thresholds for
                   this index or call; None -> the engine config's table,
                   then the port's persisted table, then the defaults. A
                   table changes which route serves a batch, never the
                   result.
    build_engine:  the LBVH build: "pallas" (the CUDA build kernels) |
                   "ref" (the plain PyTorch pipeline on the values'
                   device) | "auto"/None (the persisted table's choice,
                   else "pallas"; both give the same tree bit for bit).
                   ``REPRO_ENGINE_FORCE`` beats it.
    ship_values:   distributed only: ship the MATCHED values to the rank
                   that asked, so ``QueryResult.values`` is filled (the
                   attach-data case). Off by default: callbacks reduce on
                   the rank that owns the data, and values stay there.
                   Single-process indexes always gather locally.
    """
    engine: Any = None
    device: Any = None
    capacity: int | None = None
    max_doublings: int = 6
    combine: Any = None
    route_table: Any = None
    build_engine: str | None = None
    ship_values: bool = False

    def __post_init__(self):
        from .route_table import BUILD_ENGINES, RouteTable
        if isinstance(self.route_table, (str, os.PathLike)):
            object.__setattr__(self, "route_table", RouteTable.load(
                os.fspath(self.route_table)))
        if self.build_engine is not None and \
                self.build_engine not in BUILD_ENGINES:
            raise ValueError(f"build_engine={self.build_engine!r} is not "
                             f"one of {BUILD_ENGINES}")

    def resolve_engine(self):
        if self.engine is not None:
            return self.engine
        from . import engine as E
        return E.default_engine()

    def override(self, **kw) -> "ExecutionPolicy":
        """Copy with the given non-None fields replaced."""
        kw = {k: v for k, v in kw.items() if v is not None}
        return dataclasses.replace(self, **kw) if kw else self


# --- deprecation shims ------------------------------------------------------

_SEEN_DEPRECATIONS: set = set()


def _warn_deprecated(key: str, msg: str):
    """One DeprecationWarning per `key` and process: the API-v1
    spellings forward to the current ones and say so once."""
    if key in _SEEN_DEPRECATIONS:
        return
    _SEEN_DEPRECATIONS.add(key)
    warnings.warn(msg, DeprecationWarning, stacklevel=3)


class _LegacyTriple(tuple):
    """Old storage-query result: a (values, indices, offsets) 3-tuple with
    an ``overflow`` attribute. Returned only by the deprecated
    ``query(space, predicates)`` spelling."""

    def __new__(cls, triple, overflow: bool = False):
        obj = super().__new__(cls, triple)
        obj.overflow = overflow
        return obj


def _is_legacy_space(arg) -> bool:
    """The API-v1 constructors took (space, values, ...): a leading None,
    torch device or device name marks the old spelling (values are never
    one of those)."""
    return arg is None or isinstance(arg, (torch.device, str))


def _bcast_state(state, nq, device):
    """An unbatched callback state (a tensor, a Python number, or a tuple
    / list of them) as fresh tensors with a leading (nq,) axis on
    `device`. Python ints become int32, as JAX's default integers."""
    if isinstance(state, (tuple, list)):
        return type(state)(_bcast_state(s, nq, device) for s in state)
    if isinstance(state, int) and not isinstance(state, bool):
        a = torch.tensor(state, dtype=torch.int32, device=device)
    else:
        a = torch.as_tensor(state, device=device)
    return a.expand((nq,) + a.shape).clone()


def _repeat_preds(predicates, offsets):
    """Per-query predicates repeated per match (a CSR repeat)."""
    counts = (offsets[1:] - offsets[:-1]).to(torch.int64)
    qid = torch.repeat_interleave(
        torch.arange(counts.shape[0], device=counts.device), counts)
    return P.take(predicates, qid)


def _csr_pack(buf, counts):
    """(Q, cap) buffer + per-query counts (<= cap) -> flat CSR array: the
    valid prefix of every row, rows in order."""
    cap = buf.shape[1]
    valid = torch.arange(cap, device=buf.device)[None, :] < counts[:, None]
    return buf[valid]


class Index:
    """Base class: the unified container + query interface."""

    policy: ExecutionPolicy
    device: torch.device

    def size(self) -> int:
        raise NotImplementedError

    def empty(self) -> bool:
        return self.size() == 0

    def bounds(self):
        raise NotImplementedError

    def query(self, predicates, *_legacy, callback=None, out=None,
              capacity: int | None = None,
              policy: ExecutionPolicy | None = None) -> QueryResult:
        """One polymorphic query, dispatched on the predicate kind; the
        ``callback=`` flavor returns the per-query final states instead.

        callback: ``(cb, state0)``, e.g. a ``core.callbacks`` factory's
                  result; state0 unbatched (broadcast to every query).
        out:      ``out_fn(pred, value, index, t)`` over all matches at
                  once; its outputs land CSR in ``result.values``.
        capacity: per-query CSR width shorthand (== policy.capacity).
        policy:   full per-call ExecutionPolicy override.
        Predicates are moved to the index's device. The API-v1 spelling
        ``query(space, predicates[, capacity])`` still works, warned once
        (:meth:`_legacy_query`)."""
        if _legacy:
            return self._legacy_query(predicates, *_legacy, callback=callback,
                                      out=out, capacity=capacity,
                                      policy=policy)
        pol = policy if policy is not None else self.policy
        if capacity is not None:
            pol = pol.override(capacity=capacity)
        if callback is not None:
            cb, state0 = callback
            predicates = predicates.to(self.device)
            s0 = _bcast_state(state0, len(predicates), self.device)
            return self._query_callback_impl(predicates, cb, s0, pol)
        if out is not None:
            return self._query_out(predicates.to(self.device), out, pol)
        if isinstance(predicates, (P.Nearest, P.RayNearest)):
            return self._query_knn(predicates.to(self.device), pol)
        if isinstance(predicates, P.RayOrderedIntersect):
            return self._query_ordered(predicates.to(self.device), pol)
        if isinstance(predicates, (P.Intersects, P.RayIntersect)):
            return self._query_csr(predicates.to(self.device), pol)
        raise TypeError(f"query() cannot dispatch predicate kind "
                        f"{type(predicates).__name__}")

    def count(self, predicates, *_legacy,
              policy: ExecutionPolicy | None = None):
        """Per-query match counts of an Intersects or ray batch (every hit
        of a ray; no fill pass). ``count(space, predicates)`` is the
        API-v1 spelling, warned once."""
        if _legacy:
            _warn_deprecated(
                "count", "count(space, predicates) is deprecated; the "
                "execution space lives in ExecutionPolicy now — call "
                "count(predicates)")
            predicates = _legacy[0]
        if not isinstance(predicates, (P.Intersects,) + P.RAY_KINDS):
            raise TypeError(f"count() takes Intersects or ray predicates, "
                            f"got {type(predicates).__name__}")
        pol = policy if policy is not None else self.policy
        return self._count_impl(predicates.to(self.device), pol)

    # --- dispatch bodies shared by all backends --------------------------
    def _query_knn(self, predicates, pol) -> QueryResult:
        d, i = self._knn_impl(predicates, pol)
        if self.size() == 0:
            return QueryResult(indices=i, distances=d)
        q, k = i.shape
        vals = self._gather_values(torch.clamp_min(i, 0).reshape(-1), pol)
        vals = _reshape_values(vals, (q, k))
        return QueryResult(values=vals, indices=i, distances=d)

    def _query_csr(self, predicates, pol) -> QueryResult:
        overflow = False
        cap = pol.capacity
        if cap is None:
            exact = self._csr_exact(predicates, pol)
            if exact is not None:
                return exact
            counts = self._count_impl(predicates, pol)
            cap = max(self._most(counts), 1)
            counts, buf = self._fill_impl(predicates, cap, pol)
        else:
            counts, buf = self._fill_impl(predicates, cap, pol)
            # counts are FULL counts, so one host sync decides the retry
            needed = self._most(counts)
            if needed > cap:
                retry = cap
                for _ in range(pol.max_doublings):
                    if retry >= needed:
                        break
                    retry *= 2
                if retry > cap:
                    counts, buf = self._fill_impl(predicates, retry, pol)
                    cap = retry
                overflow = needed > cap
        clamped = torch.clamp_max(counts, cap)
        offsets = torch.cat([torch.zeros((1,), dtype=torch.int32,
                                         device=clamped.device),
                             torch.cumsum(clamped, 0)]).to(torch.int32)
        flat_idx = _csr_pack(buf, clamped)
        return QueryResult(values=self._gather_values(flat_idx, pol),
                           indices=flat_idx, offsets=offsets,
                           overflow=overflow)

    def _query_ordered(self, predicates, pol) -> QueryResult:
        """Every ray hit ordered by t within each ray: a ``collect_hits``
        pass, then a stable per-row sort by t (invalid slots hold inf, so
        they sort past the valid segment), then a CSR pack."""
        cap = pol.capacity
        if cap is None:
            cap = max(self._most(self._count_impl(predicates, pol)), 1)
        count, idxs, ts = self._collect_with_t(predicates, cap, pol)
        count = torch.clamp_max(count, cap)
        ts_s, order = torch.sort(ts, dim=1, stable=True)
        idxs_s = torch.gather(idxs, 1, order)
        offsets = torch.cat([torch.zeros((1,), dtype=torch.int32,
                                         device=count.device),
                             torch.cumsum(count, 0)]).to(torch.int32)
        flat_idx = _csr_pack(idxs_s, count)
        return QueryResult(values=self._gather_values(flat_idx, pol),
                           indices=flat_idx, offsets=offsets,
                           distances=_csr_pack(ts_s, count))

    def _query_out(self, predicates, out_fn, pol) -> QueryResult:
        res = self._query_csr(predicates, pol)
        preds = _repeat_preds(predicates, res.offsets)
        t = torch.zeros((res.indices.shape[0],), dtype=torch.float32,
                        device=res.indices.device)
        return QueryResult(values=out_fn(preds, res.values, res.indices, t),
                           indices=res.indices, offsets=res.offsets,
                           overflow=res.overflow)

    # --- deprecation shims (API v1 spellings) -----------------------------
    # The execution space was the first argument; it is the policy's
    # device now, so the shims ignore it (the index's device holds).
    def _legacy_query(self, space, predicates, *rest, callback=None,
                      out=None, capacity=None, policy=None):
        _warn_deprecated(
            "query", "query(space, predicates, ...) is deprecated; the "
            "execution space lives in ExecutionPolicy now — call "
            "query(predicates, ...) (returns a QueryResult NamedTuple)")
        if rest:
            capacity = rest[0]
        if callback is not None:
            cb, s0 = callback
            predicates = predicates.to(self.device)
            s0 = _bcast_state(s0, len(predicates), self.device)
            return self._query_callback_impl(
                predicates, cb, s0, policy or self.policy)
        res = self.query(predicates, out=out, capacity=capacity,
                         policy=policy)
        if out is not None:
            return res.values, res.offsets
        return _LegacyTriple((res.values, res.indices, res.offsets),
                             res.overflow)

    def query_callback(self, space, predicates, callback, init_state):
        """DEPRECATED: use ``query(predicates, callback=(cb, state0))``
        (state0 unbatched; this shim keeps the old batched contract)."""
        _warn_deprecated(
            "query_callback", "query_callback(space, preds, cb, state) is "
            "deprecated; use query(predicates, callback=(cb, state0)) with "
            "an unbatched state0")
        return self._query_callback_impl(predicates.to(self.device),
                                         callback, init_state, self.policy)

    def query_out(self, space, predicates, out_fn,
                  capacity: int | None = None):
        """DEPRECATED: use ``query(predicates, out=out_fn)``."""
        _warn_deprecated(
            "query_out", "query_out(space, preds, out_fn) is deprecated; "
            "use query(predicates, out=out_fn)")
        res = self.query(predicates, out=out_fn, capacity=capacity)
        return res.values, res.offsets

    def knn(self, space, predicates):
        """DEPRECATED: use ``query(nearest(geom, k))`` — returns a
        QueryResult with .distances/.indices."""
        _warn_deprecated(
            "knn", "knn(space, predicates) is deprecated; use "
            "query(nearest(geom, k)) and read .distances/.indices")
        return self._knn_impl(predicates.to(self.device), self.policy)

    # --- backend SPI ------------------------------------------------------
    def _query_callback_impl(self, predicates, callback, state0, pol):
        raise NotImplementedError

    def _collect_with_t(self, predicates, capacity, pol):
        """(counts, idxs (Q, capacity), ts (Q, capacity)) through a
        ``collect_hits`` callback pass."""
        cb, s0 = CB.collect_hits(capacity)
        s0 = _bcast_state(s0, len(predicates), self.device)
        return self._query_callback_impl(predicates, cb, s0, pol)

    def _count_impl(self, predicates, pol):
        raise NotImplementedError

    def _fill_impl(self, predicates, capacity, pol):
        raise NotImplementedError

    def _knn_impl(self, predicates, pol):
        raise NotImplementedError

    def _csr_exact(self, predicates, pol):
        return None

    def _gather_values(self, flat_idx, pol=None):
        return value_at(self.values, flat_idx.to(torch.int64))

    def _most(self, counts) -> int:
        """The largest of the (Q,) counts (0 for Q = 0), which sizes the
        CSR buffer and decides the doubling retry; a distributed index
        takes it over every rank's queries, so all ranks decide alike."""
        return int(counts.max()) if counts.numel() else 0


def _reshape_values(vals, lead):
    """Give every tensor of a gathered values container the (Q, k) lead
    (a k-DOP's shared directions keep their shape)."""
    if isinstance(vals, torch.Tensor):
        return vals.reshape(lead + vals.shape[1:])
    if isinstance(vals, G.KDOPs):
        return G.KDOPs(_reshape_values(vals.lo, lead),
                       _reshape_values(vals.hi, lead), vals.directions)
    if dataclasses.is_dataclass(vals):
        return type(vals)(*(_reshape_values(getattr(vals, f.name), lead)
                            for f in dataclasses.fields(vals)))
    if isinstance(vals, dict):
        return {k: _reshape_values(v, lead) for k, v in vals.items()}
    if isinstance(vals, (tuple, list)):
        return type(vals)(_reshape_values(v, lead) for v in vals)
    return vals
