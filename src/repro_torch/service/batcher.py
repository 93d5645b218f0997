"""Shape-bucketed micro-batching of heterogeneous requests, as
``repro.service.batcher`` (numpy in, numpy out; the same groups).

The engine's executable cache keeps one entry per bucket shape, so
serving raw request shapes would make entries without end. The batcher
makes traffic shape-stable:

  1. requests are grouped by a *group key* — (index, predicate kind, static
     params like k) — everything that selects a distinct executable;
  2. each group's query rows are concatenated and padded up to the next
     power-of-two **bucket** (>= ``min_bucket``), repeating the last real
     row so padding is geometrically harmless;
  3. one dispatch per group hits the engine's executable cache at the
     bucket shape; per-request slices scatter the rows back.

Bucket sizes form a geometric family, so after warming log2(max_q) buckets
per kind ANY mix of request shapes runs with zero new cache entries and at
most 2x padding waste.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["Request", "Group", "Batcher", "knn_request", "within_request",
           "ray_request", "bucket_size", "SUPPORTED_KINDS", "validate_kind"]

KIND_KNN = "knn"
KIND_WITHIN = "within"
KIND_RAY = "ray"
SUPPORTED_KINDS = (KIND_KNN, KIND_WITHIN, KIND_RAY)


def validate_kind(kind):
    """Reject unknown predicate kinds up front, naming the supported set —
    an unknown kind must fail at enqueue time, not as an opaque shape error
    deep inside a later dispatch."""
    if kind not in SUPPORTED_KINDS:
        raise ValueError(f"unknown request kind {kind!r}; supported kinds "
                         f"are {SUPPORTED_KINDS}")


@dataclasses.dataclass(frozen=True)
class Request:
    """One client request: `m` homogeneous queries against one index.

    kind: "knn" (a: points),  "within" (a: centers, b: radii),
          "ray" (a: origins, b: directions). `k` is the static result width
    for knn/ray; ignored for within.
    """
    kind: str
    a: np.ndarray
    b: np.ndarray | None = None
    k: int = 1
    index: str = "default"

    def __post_init__(self):
        validate_kind(self.kind)
        if self.kind != KIND_KNN and self.b is None:
            raise ValueError(f"{self.kind!r} requests need both arrays")
        if len(self.a) == 0:
            raise ValueError("empty request (m == 0)")
        if self.b is not None and len(self.b) != len(self.a):
            # a/b concatenate independently in plan(); a length mismatch
            # would silently misalign every later request in the group
            raise ValueError(f"a/b length mismatch: {len(self.a)} vs "
                             f"{len(self.b)}")

    @property
    def m(self) -> int:
        return len(self.a)


def knn_request(points, k: int = 1, index: str = "default") -> Request:
    pts = np.asarray(points, np.float32)
    return Request(KIND_KNN, pts, None, k, index)


def within_request(centers, radii, index: str = "default") -> Request:
    c = np.asarray(centers, np.float32)
    r = np.broadcast_to(np.asarray(radii, np.float32), (len(c),))
    return Request(KIND_WITHIN, c, np.ascontiguousarray(r), 1, index)


def ray_request(origins, directions, k: int = 1,
                index: str = "default") -> Request:
    o = np.asarray(origins, np.float32)
    d = np.asarray(directions, np.float32)
    return Request(KIND_RAY, o, d, k, index)


def bucket_size(q: int, min_bucket: int = 8) -> int:
    """Smallest power of two >= max(q, min_bucket)."""
    return max(min_bucket, 1 << max(q - 1, 0).bit_length())


@dataclasses.dataclass(frozen=True)
class Group:
    """One engine dispatch: a bucket-padded batch of same-kind queries."""
    key: tuple                       # (index, kind, k, dim)
    a: np.ndarray                    # (bucket, dim) padded
    b: np.ndarray | None             # (bucket, dim) or (bucket,) or None
    bucket: int
    n_real: int                      # rows before padding
    members: tuple                   # ((request_id, start, m), ...)

    @property
    def index(self) -> str:
        return self.key[0]

    @property
    def kind(self) -> str:
        return self.key[1]

    @property
    def k(self) -> int:
        return self.key[2]


class Batcher:
    """Stateless planner: a list of requests -> a list of padded Groups."""

    def __init__(self, min_bucket: int = 8):
        if min_bucket < 1 or (min_bucket & (min_bucket - 1)):
            raise ValueError("min_bucket must be a power of two")
        self.min_bucket = min_bucket

    def group_key(self, req: Request) -> tuple:
        # k is static only where it shapes the result (knn / ray)
        k = req.k if req.kind in (KIND_KNN, KIND_RAY) else 0
        return (req.index, req.kind, k, req.a.shape[-1])

    def plan(self, requests: list[Request]) -> list[Group]:
        by_key: dict[tuple, list[tuple[int, Request]]] = {}
        for rid, req in enumerate(requests):
            # re-validate here: Request.__post_init__ already checks, but a
            # subclass (or a replace() that skipped it) must still fail with
            # the named-kind error, not a shape error inside the engine
            validate_kind(req.kind)
            by_key.setdefault(self.group_key(req), []).append((rid, req))

        groups = []
        for key, members in by_key.items():
            a_parts, b_parts, spans, off = [], [], [], 0
            for rid, req in members:
                a_parts.append(req.a)
                if req.b is not None:
                    b_parts.append(req.b)
                spans.append((rid, off, req.m))
                off += req.m
            a = np.concatenate(a_parts, 0)
            b = np.concatenate(b_parts, 0) if b_parts else None
            bucket = bucket_size(off, self.min_bucket)
            groups.append(Group(key=key, a=_pad_edge(a, bucket),
                                b=None if b is None else _pad_edge(b, bucket),
                                bucket=bucket, n_real=off,
                                members=tuple(spans)))
        return groups


def _pad_edge(arr: np.ndarray, bucket: int) -> np.ndarray:
    """Pad axis 0 to `bucket` rows by repeating the last real row (safe for
    every query kind: duplicate queries, results discarded on scatter)."""
    pad = bucket - arr.shape[0]
    if pad <= 0:
        return arr
    edge = np.repeat(arr[-1:], pad, axis=0)
    return np.concatenate([arr, edge], 0)
