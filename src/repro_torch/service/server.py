"""QueryServer: the synchronous service frontend, as
``repro.service.server``.

One ``handle(requests)`` call is a scheduling quantum: the batcher plans
shape-stable groups, each group is dispatched once through the engine's
executable cache against a *pinned* index version (grabbed at dispatch
time; concurrent ``update_index`` swaps never tear a batch), and results
scatter back to per-request :class:`Response` objects carrying stats:
which route served it (bruteforce | kernel | loop), which bucket it rode
in, which index version it saw, and whether the cache entry was warm.

The boundary is numpy in and numpy out. A group's query arrays go to the
index's device once, and its results come back in one device-to-host
copy (``server.assemble``), which also waits for the group's launches:
so when ``execute_group`` returns, no queued work still reads the
version, and the caller may release its pin.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import engine as E
from ..core import geometry as G
from ..core import predicates as P
from ..core.access import default_indexable_getter
from ..telemetry import tracer as TEL
from .batcher import (KIND_KNN, KIND_RAY, KIND_WITHIN, Batcher, Group,
                      Request, bucket_size, knn_request, ray_request,
                      within_request)
from .index_store import IndexStore, IndexVersion

__all__ = ["ServiceConfig", "RequestStats", "Response", "QueryServer",
           "execute_group", "warmup_requests"]


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """capacity: CSR buffer width per within-radius query. Held FIXED so
    every within bucket reuses one cache entry; requests that overflow it
    are flagged (callers needing exact spill re-issue via ``BVH.query``,
    which retries with doubled capacity).
    min_bucket / max_bucket: the power-of-two bucket ladder — min_bucket is
    the smallest (and alignment of) bucket, max_bucket the largest batch
    one dispatch carries (warmup covers the whole ladder; the async
    pipeline closes a group when it reaches max_bucket rows).
    rebuild_threshold: SAH degradation ratio that turns a refit into a
    full rebuild (forwarded to the IndexStore the server creates)."""
    capacity: int = 64
    min_bucket: int = 8
    max_bucket: int = 128
    rebuild_threshold: float = 1.5


@dataclasses.dataclass(frozen=True)
class RequestStats:
    kind: str
    route: str            # bruteforce | kernel | loop
    bucket: int           # power-of-two batch the request rode in
    index_name: str
    index_version: int
    cache_hit: bool       # the cache entry was already warm
    # async-pipeline timing (zero on the synchronous QueryServer path):
    queue_wait_us: float = 0.0    # submit -> batch dispatch
    service_us: float = 0.0       # batch dispatch -> results ready
    deadline_us: float | None = None
    deadline_missed: bool = False
    # telemetry (zero/None unless telemetry is enabled: kernel_us needs a
    # stream sync the disabled path must not pay):
    kernel_us: float = 0.0        # fenced engine launch time
    span_id: int = 0              # "request" root span id in the trace
    phase_us: dict | None = None  # REQUEST_PHASES tiling (async pipeline)


@dataclasses.dataclass(frozen=True)
class Response:
    """Per-request results. knn/ray fill (dists, idxs) (m, k) — dists are
    ray-hit parameters t for ray requests; within fills (counts, idxs)
    with idxs (m, capacity) -1-padded and `overflow` set when any query
    matched more than `capacity`."""
    stats: RequestStats
    dists: np.ndarray | None = None
    idxs: np.ndarray | None = None
    counts: np.ndarray | None = None
    overflow: bool = False


_HOST_DTYPES = {torch.float32: np.float32, torch.int32: np.int32}


def _to_host(*parts: torch.Tensor) -> list[np.ndarray]:
    """float32 / int32 (Q, ...) tensors of one bucket in ONE device-to-host
    copy: their bits side by side as int32 columns, split and re-viewed
    on the host (bit for bit)."""
    flat = [p.reshape(p.shape[0], -1) for p in parts]
    cols = torch.cat([f.view(torch.int32) for f in flat], 1).cpu().numpy()
    out, at = [], 0
    for p, f in zip(parts, flat):
        w = f.shape[1]
        host = cols[:, at:at + w].view(_HOST_DTYPES[p.dtype])
        out.append(host.reshape(tuple(p.shape)))
        at += w
    return out


def execute_group(engine: E.QueryEngine, config: ServiceConfig,
                  entry: IndexVersion, group: Group) -> dict[int, "Response"]:
    """Dispatch ONE planned group against a pinned index version and scatter
    the bucket results back to per-request Responses (keyed by the request
    ids recorded in ``group.members``). Shared by the synchronous
    ``QueryServer.handle`` and the async ``ServingPipeline`` — the caller
    owns version pinning and any timing bookkeeping."""
    if getattr(entry, "sharded", False):
        # a sharded version carries its group's ShardedExecutor: the
        # collective stages replace the engine's executable cache (duck
        # typed, so this module never imports service.sharded)
        return entry.executor.execute_group(config, entry, group)
    bvh = entry.bvh
    with TEL.span("server.execute_group", kind=group.kind,
                  bucket=group.bucket, index=entry.name,
                  version=entry.version):
        a = torch.from_numpy(np.ascontiguousarray(group.a)).to(bvh.device)
        b = None if group.b is None else \
            torch.from_numpy(np.ascontiguousarray(group.b)).to(bvh.device)
        # degenerate indexes (N < 2) have no tree; the cache entries need
        # one, but the BVH API itself scans linearly — a cloud that shrinks
        # to one point must not take down serving
        tiny = bvh.tree is None
        info = E.ExecInfo(E.ROUTE_LOOP, False) if tiny else None

        overflow_rows = None
        if group.kind == KIND_WITHIN:
            preds = P.intersects(G.Spheres(a, b))
            if tiny:
                counts, buf = bvh._fill_impl(preds, config.capacity,
                                             bvh.policy)
            else:
                (counts, buf), info = engine.exec_spatial(
                    bvh, preds, config.capacity)
            # CSR assembly: device buffers -> host arrays + overflow flags
            with TEL.span("server.assemble", kind=group.kind):
                counts, buf = _to_host(counts.to(torch.int32),
                                       buf.to(torch.int32))
                overflow_rows = counts > config.capacity
            res_rows = (counts, buf)
        elif group.kind == KIND_KNN:
            preds = P.nearest(G.Points(a), k=group.k)
            if tiny:
                res = bvh.query(preds)
                d, i = res.distances, res.indices
            else:
                (d, i), info = engine.exec_knn(bvh, preds)
            with TEL.span("server.assemble", kind=group.kind):
                res_rows = _to_host(d.to(torch.float32), i.to(torch.int32))
        else:  # KIND_RAY
            rays = G.Rays(a, b)
            if tiny:
                res = bvh.query(P.RayNearest(rays, group.k))
                d, i = res.distances, res.indices
            else:
                (d, i), info = engine.exec_ray_nearest(bvh, rays, group.k)
            with TEL.span("server.assemble", kind=group.kind):
                res_rows = _to_host(d.to(torch.float32), i.to(torch.int32))

        out: dict[int, Response] = {}
        with TEL.span("server.scatter", requests=len(group.members)):
            for rid, start, m in group.members:
                stats = RequestStats(kind=group.kind, route=info.route,
                                     bucket=group.bucket,
                                     index_name=entry.name,
                                     index_version=entry.version,
                                     cache_hit=info.cache_hit,
                                     kernel_us=info.kernel_us)
                sl = slice(start, start + m)
                if group.kind == KIND_WITHIN:
                    counts, buf = res_rows
                    out[rid] = Response(
                        stats, counts=counts[sl], idxs=buf[sl],
                        overflow=bool(overflow_rows[sl].any()))
                else:
                    d, i = res_rows
                    out[rid] = Response(stats, dists=d[sl], idxs=i[sl])
    return out


def warmup_requests(config: ServiceConfig, index: str, kinds_ks, max_bucket,
                    dim: int, default_ks: tuple[int, ...] = (1,)):
    """The warm-up's requests, one list a bucket of the ladder from
    ``config.min_bucket`` up to the bucket `max_bucket` queries ride in
    (None: ``config.max_bucket``): a zero request of every (kind, k) in
    `kinds_ks`, every kind it leaves out at `default_ks` (within at
    k = 0)."""
    kinds_ks = list(kinds_ks or [])
    have = {kind for kind, _ in kinds_ks}
    for kind in (KIND_KNN, KIND_WITHIN, KIND_RAY):
        if kind not in have:
            kinds_ks += [(kind, 0)] if kind == KIND_WITHIN else \
                        [(kind, k) for k in default_ks]
    if max_bucket is None:
        max_bucket = config.max_bucket
    b = config.min_bucket
    top = bucket_size(max_bucket, config.min_bucket)
    while b <= top:
        reqs = []
        for kind, k in kinds_ks:
            a = np.zeros((b, dim), np.float32)
            if kind == KIND_WITHIN:
                reqs.append(within_request(a, 0.0, index))
            elif kind == KIND_RAY:
                reqs.append(ray_request(a, np.ones((b, dim), np.float32),
                                        k, index))
            else:
                reqs.append(knn_request(a, k, index))
        yield reqs
        b *= 2


class QueryServer:
    """Synchronous frontend over an IndexStore, the Batcher and an engine.
    Without a `store` it makes one on `device` (None: the CUDA card,
    raising without one; "cpu" for the plain twins)."""

    def __init__(self, store: IndexStore | None = None,
                 engine: E.QueryEngine | None = None,
                 config: ServiceConfig | None = None, *, device=None):
        self.config = config or ServiceConfig()
        if store is not None:
            self.store = store
            self.engine = engine if engine is not None else store.engine
        else:
            self.engine = engine if engine is not None else E.QueryEngine()
            self.store = IndexStore(
                self.engine, rebuild_threshold=self.config.rebuild_threshold,
                device=device)
        self.batcher = Batcher(self.config.min_bucket)

    # -- index lifecycle ---------------------------------------------------
    def create_index(self, name: str, values,
                     indexable_getter=default_indexable_getter) -> IndexVersion:
        return self.store.build(name, values, indexable_getter)

    def update_index(self, name: str, values) -> IndexVersion:
        """Refit-or-rebuild to moved values; see IndexStore.update."""
        return self.store.update(name, values)

    # -- serving -----------------------------------------------------------
    def handle(self, requests: list[Request]) -> list[Response]:
        """Serve a batch of heterogeneous requests; responses align with
        the input order."""
        responses: list[Response | None] = [None] * len(requests)
        for group in self.batcher.plan(requests):
            self._dispatch(group, responses)
        return responses  # type: ignore[return-value]

    def warmup(self, index: str, kinds_ks: list[tuple[str, int]] | None = None,
               max_bucket: int | None = None, dim: int | None = None,
               default_ks: tuple[int, ...] = (1,)):
        """Prepare every (kind, k, bucket) cache entry for buckets up to
        (and including) the one `max_bucket` queries would ride in, so live
        traffic sees only warm dispatches.

        ALL THREE kinds are warmed by default: any kind absent from
        `kinds_ks` (or all of them, when it is None) is warmed with
        `default_ks` (within always rides k=0 — k doesn't shape its
        result). `max_bucket` defaults to the configured ladder top and
        `dim` is read off the index, so ``warmup("default")`` alone leaves
        no cold route behind."""
        if dim is None:
            dim = self.store.get(index).dim
        for reqs in warmup_requests(self.config, index, kinds_ks, max_bucket,
                                    dim, default_ks):
            self.handle(reqs)

    # -- internals ---------------------------------------------------------
    def _dispatch(self, group: Group, responses: list):
        # Pin, not get: a concurrent update_index swap during the dispatch
        # must not let history trimming evict the version this batch runs
        # against (the "pinned index version" promise).
        with self.store.pinned(group.index) as entry:
            for rid, resp in execute_group(self.engine, self.config,
                                           entry, group).items():
                responses[rid] = resp
