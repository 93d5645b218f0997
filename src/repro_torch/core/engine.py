"""QueryEngine: per-batch choice between brute force, the traversal
kernels and the general walk, as ``repro.core.engine`` chooses between
bruteforce, pallas and loop.

  * ``bruteforce``: the all-pairs match matrix (``BruteForce``); exact,
    and the cheaper route while N * Q is small. It never runs callbacks.
  * ``kernel``: the hand-written traversal kernels
    (``kernels.bvh_traverse``, ``kernels.bvh_callback``; their plain
    twins on the CPU). This is the reference's ``pallas`` route, and for
    ``RayNearest`` the ray kNN kernel, and for ``Nearest`` over Spheres,
    Triangles, Segments, Tetrahedra and KDOPs values the fine kNN kernel:
    the counterparts of the compiled walk the reference runs there.
  * ``loop``: the batched walks of ``core.traversal`` for what the
    kernels cannot express: callbacks that are not epilogues (any Python
    callable), other value geometries, custom indexable getters, more
    than ``MAX_DIM`` dimensions, k above ``KNN_MAX_K``. On the card it
    runs as a host loop of PyTorch operations.

Routing is decided in Python from N, Q, the predicate kind, the value
geometry and the callback; a kernel failure raises and never reroutes.
``callback_batches`` counts the callback batches each route served.

The serving stack dispatches every bucket through the executable cache
(``exec_spatial``, ``exec_knn``, ``exec_ray_nearest``): one entry per
(route, op, static parameters, bucket shape, index shape, getter), LRU-
bounded by ``MAX_EXECUTABLES``. An entry is a closure that binds the
bucket's static parameters (its route, capacity or k); making one is the
port's "trace", so ``EngineStats.jit_traces`` rises with
``cache_misses`` and keeps the reference's metric names. The kernel
libraries are loaded by the wrappers' first launch and kept
(``kernels._build``), so a warm service misses nothing and loads
nothing. The ``engine.route`` span wraps each decision and the
``engine.kernel`` span each launch, fenced on the calling thread's
stream when telemetry is on (``ExecInfo.kernel_us``).
"""
from __future__ import annotations

import collections
import dataclasses
import threading

import torch

from ..kernels.bvh_callback import (bvh_traverse_callback, expressible,
                                    query_order, reads_value_records)
from ..kernels.bvh_traverse import (FINE_KNN_RECORDS, FINE_KNN_VALUES,
                                    KNN_MAX_K, MAX_DIM, RAY_TARGETS,
                                    bvh_traverse_fine_knn, bvh_traverse_knn,
                                    bvh_traverse_ray_knn,
                                    bvh_traverse_spatial, knn_order)
from ..telemetry import MetricsRegistry
from ..telemetry import tracer as TEL
from . import callbacks as CB
from . import geometry as G
from . import predicates as P
from . import route_table as RT
from . import traversal as T
from .index import _bcast_state

__all__ = ["EngineConfig", "EngineStats", "EngineStatsSnapshot", "ExecInfo",
           "QueryEngine", "default_engine", "set_default_engine",
           "ROUTE_BRUTEFORCE", "ROUTE_KERNEL", "ROUTE_LOOP"]

ROUTE_BRUTEFORCE = "bruteforce"
ROUTE_KERNEL = "kernel"
ROUTE_LOOP = "loop"

_FALLBACK_TABLE = RT.RouteTable.default()

#: LRU bound of the exec_* executable cache, so a service whose leaf count
#: changes across rebuilds does not keep one entry per past N
MAX_EXECUTABLES = 256


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """route_table: rules for every routing decision through this engine
        (an ExecutionPolicy table overrides it per call or index); None
        means the built-in defaults.
    force: "bruteforce" | "kernel" pins every batch the route can express
        to it (other batches take the normal choice; brute force runs no
        callbacks); "loop" pins every batch to the general walk.
    """
    route_table: RT.RouteTable | None = None
    force: str | None = None

    def __post_init__(self):
        routes = (ROUTE_BRUTEFORCE, ROUTE_KERNEL, ROUTE_LOOP)
        if self.force is not None and self.force not in routes:
            raise ValueError(f"force={self.force!r} is not one of {routes}")


def _spatial_rep(predicates):
    """Unified (q_lo, q_hi, r) form of an Intersects batch, or None when
    the geometry has no exact box/radius spelling."""
    if not isinstance(predicates, P.Intersects):
        return None
    g = predicates.geom
    if isinstance(g, G.Points):
        z = torch.zeros((g.coords.shape[0],), dtype=torch.float32,
                        device=g.coords.device)
        return g.coords, g.coords, z
    if isinstance(g, G.Boxes):
        z = torch.zeros((g.lo.shape[0],), dtype=torch.float32, device=g.lo.device)
        return g.lo, g.hi, z
    if isinstance(g, G.Spheres):
        return g.center, g.center, g.radius.to(torch.float32)
    return None


@dataclasses.dataclass(frozen=True)
class EngineStatsSnapshot:
    """Immutable point-in-time copy of :class:`EngineStats`."""
    cache_hits: int = 0
    cache_misses: int = 0
    jit_traces: int = 0

    def snapshot(self) -> "EngineStatsSnapshot":
        return self


def _counter_prop(field: str, doc: str) -> property:
    """A field read from, and written to, its registry counter."""
    def _get(self):
        return self._counters[field].value

    def _set(self, v):
        self._counters[field].set(v)

    return property(_get, _set, doc=doc)


class EngineStats:
    """Executable-cache accounting: counters ``engine.cache_hits``,
    ``engine.cache_misses`` and ``engine.jit_traces`` on a per-instance
    :class:`~repro_torch.telemetry.MetricsRegistry` (``.registry``), so
    they reach the JSONL metrics export. ``jit_traces`` counts the cache
    entries made (the module docstring): a warm service shows hits growing
    and misses and traces flat."""

    _FIELDS = ("cache_hits", "cache_misses", "jit_traces")

    cache_hits = _counter_prop("cache_hits", "executable-cache hits")
    cache_misses = _counter_prop("cache_misses", "executable-cache misses")
    jit_traces = _counter_prop("jit_traces", "cache entries made")

    def __init__(self, registry=None, **legacy):
        self.registry = registry if registry is not None else MetricsRegistry()
        self._counters = {f: self.registry.counter(f"engine.{f}")
                          for f in self._FIELDS}
        if legacy:
            # the API-v1 spelling: fields seeded by keyword, warned once
            unknown = sorted(set(legacy) - set(self._FIELDS))
            if unknown:
                raise TypeError(f"EngineStats got unexpected fields {unknown}")
            from .index import _warn_deprecated
            _warn_deprecated(
                "EngineStats.kwargs",
                "constructing EngineStats with field keyword arguments is "
                "deprecated: the fields are now counters in a telemetry "
                "MetricsRegistry (stats.registry); assign fields or use "
                "registry.counter(...) instead")
            for k, v in legacy.items():
                self._counters[k].set(int(v))

    def snapshot(self) -> EngineStatsSnapshot:
        return EngineStatsSnapshot(
            **{f: self._counters[f].value for f in self._FIELDS})

    def __repr__(self):
        body = ", ".join(f"{f}={self._counters[f].value}"
                         for f in self._FIELDS)
        return f"EngineStats({body})"


@dataclasses.dataclass(frozen=True)
class ExecInfo:
    """Per-dispatch metadata of the exec_* entry points. kernel_us is the
    fenced duration of the launch (the ``engine.kernel`` span): 0.0 when
    telemetry is disabled, because fencing would wait for the device."""
    route: str
    cache_hit: bool
    kernel_us: float = 0.0


class QueryEngine:
    """Routes batched BVH queries to brute force or the kernels."""

    #: the executable cache, its stats and the callback-batch counts are
    #: coherent only under _cache_lock: the serving pipeline calls one
    #: engine from its scheduler and maintenance threads and callers' own
    _REPROLINT_GUARDED_BY = {"_executables": "_cache_lock",
                             "stats": "_cache_lock",
                             "callback_batches": "_cache_lock"}

    def __init__(self, config: EngineConfig | None = None):
        self.config = config or EngineConfig()
        self.stats = EngineStats()
        self._executables: collections.OrderedDict[tuple, object] = \
            collections.OrderedDict()
        self._cache_lock = threading.Lock()
        #: callback batches served per route
        self.callback_batches = {ROUTE_KERNEL: 0, ROUTE_LOOP: 0}

    def table(self, policy=None) -> RT.RouteTable:
        """Explicit policy table > engine-config table > defaults."""
        t = getattr(policy, "route_table", None)
        if t is None:
            t = self.config.route_table
        return t if t is not None else _FALLBACK_TABLE

    def _rule(self, op: str, bvh, policy) -> RT.RouteRule:
        if policy is None:
            policy = getattr(bvh, "policy", None)
        return self.table(policy).rule(op)

    # -- routing -----------------------------------------------------------
    def route_spatial(self, bvh, predicates, *, policy=None) -> str:
        """Route an Intersects batch for count or fill. Ray batches never
        take brute force or the spatial kernel: they walk, with the
        counting and collect_hits callbacks, as in the reference."""
        rule = self._rule("spatial", bvh, policy)
        q = len(predicates)
        bf_ok = isinstance(predicates, P.Intersects)
        k_ok = (bvh.tree is not None and q > 0 and bvh.kernel_values_ok
                and bvh.tree.dim <= MAX_DIM
                and _spatial_rep(predicates) is not None)
        return self._pick(bvh.size(), q, bf_ok, k_ok, rule)

    def route_knn(self, bvh, predicates, *, policy=None) -> str:
        """Route a Nearest or RayNearest batch. A Nearest batch takes the kNN
        kernel (Points or Boxes values) or the fine kNN kernel (Spheres,
        Triangles, Segments, Tetrahedra or KDOPs values) under the default
        getter, and a RayNearest batch the ray kNN kernel (Points, Boxes,
        Spheres or 3-D Triangles values), when the tree exists, Q > 0, k <=
        KNN_MAX_K and dim <= MAX_DIM; else the loop walk, or for a Nearest
        batch brute force below the crossover; a RayNearest batch never takes
        brute force. A ``Nearest.exclude`` batch is not routed: ``BVH``
        answers it with the exclusion walk, and no cached entry is keyed on
        it, so this raises."""
        if getattr(predicates, "exclude", None) is not None:
            raise ValueError(
                "Nearest.exclude takes no engine route: BVH.query answers it "
                "with the exclusion walk (core.predicates)")
        rule = self._rule("knn", bvh, policy)
        q = len(predicates)
        bf_ok = isinstance(predicates, P.Nearest)
        if bf_ok:
            values_ok = (bvh.kernel_values_ok
                         or (bvh.kernel_callback_ok
                             and isinstance(bvh.values, FINE_KNN_VALUES)
                             and not isinstance(predicates.geom, G.Rays)))
        else:
            values_ok = (bvh.kernel_callback_ok
                         and type(bvh.values) in RAY_TARGETS
                         and (type(bvh.values) is not G.Triangles
                              or bvh.values.dim == 3))
        k_ok = (bvh.tree is not None and q > 0
                and values_ok and bvh.tree.dim <= MAX_DIM
                and predicates.k <= KNN_MAX_K)
        return self._pick(bvh.size(), q, bf_ok, k_ok, rule)

    def route_callback(self, bvh, predicates, callback) -> str:
        """Route a callback batch: the fused kernel when it can run the
        callback (an epilogue; Intersects of Points, Boxes, Spheres,
        Triangles, Segments or Tetrahedra over values of any geometry but
        Rays, or a ray predicate over Points, Boxes, Spheres or 3-D
        Triangles, under the default getter; dim <= MAX_DIM; Q > 0), else
        the loop. Brute force never runs callbacks, and no crossover puts a
        batch the kernel can run on the loop, so no route rule is read. A
        kernel batch whose dtypes or state layout the kernel cannot take
        raises there; it is not rerouted."""
        if self.config.force == ROUTE_LOOP:
            return ROUTE_LOOP
        ok = (bvh.tree is not None and len(predicates) > 0
              and bvh.kernel_callback_ok
              and expressible(bvh.values, predicates, callback))
        return ROUTE_KERNEL if ok else ROUTE_LOOP

    def _pick(self, n: int, q: int, bf_ok: bool, kernel_ok: bool,
              rule: RT.RouteRule) -> str:
        force = self.config.force
        if force == ROUTE_BRUTEFORCE and bf_ok:
            return ROUTE_BRUTEFORCE
        if force == ROUTE_KERNEL and kernel_ok:
            return ROUTE_KERNEL
        if force == ROUTE_LOOP:
            return ROUTE_LOOP
        if bf_ok and n * q <= rule.bf_max_work:
            return ROUTE_BRUTEFORCE
        if kernel_ok:
            return ROUTE_KERNEL
        return ROUTE_LOOP

    # -- kernel execution --------------------------------------------------
    def kernel_count(self, bvh, predicates):
        """(Q,) int32 match counts through the spatial kernel."""
        counts, _ = self.kernel_fill(bvh, predicates, 1)
        return counts

    def kernel_fill(self, bvh, predicates, capacity: int):
        """(counts, idx_buf): full counts plus the first `capacity` matched
        indices per query in traversal order; on the card a 3-D tree's
        kept node records, and the leaf order when the queries are centred
        on the indexed points."""
        q_lo, q_hi, r = _spatial_rep(predicates)
        t = bvh.tree
        records = order = None
        if t.node_lo.is_cuda and t.dim == 3:
            records = t.records
            order = query_order(predicates, bvh.values, t.leaf_perm)
        # Points values take the sqrt-form fine test (distance <= r), the
        # exact twin of predicates.leaf_match_test for them
        return bvh_traverse_spatial(
            t.node_lo, t.node_hi, t.rope, t.left_child, t.range_last,
            t.leaf_perm, q_lo, q_hi, r, capacity=capacity,
            fine_sqrt=isinstance(bvh.values, G.Points), records=records,
            order=order)

    def run_callback(self, bvh, predicates, callback, state0):
        """Per-query final states of a callback batch (`state0` batched),
        through the route ``route_callback`` picks; counts the batch."""
        route = self.route_callback(bvh, predicates, callback)
        with self._cache_lock:
            self.callback_batches[route] += 1
        if route == ROUTE_KERNEL:
            return self.kernel_callback(bvh, predicates, callback, state0)
        return T.traverse(bvh.tree, bvh.values, predicates, callback, state0)

    def kernel_callback(self, bvh, predicates, callback, state0):
        """Per-query final states through the fused callback kernel; on
        the card a 3-D tree's kept node records and the index's kept value
        records where the walk reads them (ray batches over Spheres or
        Triangles, Intersects over Triangles, Segments or Tetrahedra)."""
        t = bvh.tree
        records = value_records = None
        if t.node_lo.is_cuda:
            records = t.records
            if reads_value_records(bvh.values, predicates):
                value_records = bvh.value_records
        return bvh_traverse_callback(
            t.node_lo, t.node_hi, t.rope, t.left_child, t.range_last,
            t.leaf_perm, bvh.values, predicates, callback, state0,
            records=records, value_records=value_records)

    def kernel_knn(self, bvh, predicates):
        """(dists, idxs) (Q, k) through the kNN kernel, from the query
        centroids (what ``predicates.leaf_distance`` measures from); on
        the card a 3-D tree's kept node records, and the leaf order when
        the queries are the indexed points. Spheres, Triangles, Segments,
        Tetrahedra and KDOPs values take the fine kNN kernel (on the card
        the index's kept value records of the first three). A RayNearest
        batch takes the ray kNN kernel: (t, idxs), the first k hits."""
        t = bvh.tree
        if isinstance(predicates, P.RayNearest):
            records = value_records = None
            if t.node_lo.is_cuda:
                records, value_records = t.records, bvh.value_records
            return bvh_traverse_ray_knn(
                t.node_lo, t.node_hi, t.rope, t.left_child, t.leaf_perm,
                bvh.values, predicates.rays, k=predicates.k, records=records,
                value_records=value_records)
        if isinstance(bvh.values, FINE_KNN_VALUES):
            records = value_records = None
            if t.node_lo.is_cuda:
                records = t.records
                if isinstance(bvh.values, FINE_KNN_RECORDS):
                    value_records = bvh.value_records
            return bvh_traverse_fine_knn(
                t.node_lo, t.node_hi, t.rope, t.left_child, t.leaf_perm,
                bvh.values, predicates.geom, k=predicates.k, records=records,
                value_records=value_records)
        queries = G.centroid(predicates.geom).to(torch.float32)
        records = order = None
        if t.node_lo.is_cuda:
            records = t.records
            coords = (bvh.values.coords if isinstance(bvh.values, G.Points)
                      else None)
            order = knn_order(queries, coords, t.leaf_perm)
        return bvh_traverse_knn(
            t.node_lo, t.node_hi, t.rope, t.left_child, t.leaf_perm, queries,
            k=predicates.k, records=records, order=order)


    # -- executable cache --------------------------------------------------
    #
    # The service dispatches every micro-batch through these entry points.
    # An entry's only inputs are the index and the bucket's predicates, so
    # a refit or rebuild at the same N reuses the warm entry.

    def _note_trace(self):  # reprolint: holds=_cache_lock
        """Count one cache entry made. Called from _cached's critical
        section, so the count is exact under concurrent schedulers."""
        self.stats.jit_traces += 1

    def _launch(self, fn, args, *, route: str, op: str, hit: bool):
        """Run a cached entry under an ``engine.kernel`` span and return
        (result, kernel_us). With telemetry enabled the span is fenced on
        the calling thread's stream, so kernel_us covers the device work;
        disabled, this is one flag check and nothing waits (0.0)."""
        sp = TEL.span("engine.kernel", route=route, op=op, cache_hit=hit)
        with sp:
            out = sp.fence(fn(*args))
        return out, sp.dur_us

    def _route_span(self, op: str):
        """Span around a route decision (wall clock, Python only)."""
        return TEL.span("engine.route", op=op)

    def _cached(self, key, make):
        """(entry, hit): the entry of `key`, made by make() on a miss,
        under the lock, so two threads never make one key twice or lose a
        count."""
        with self._cache_lock:
            fn = self._executables.get(key)
            hit = fn is not None
            if hit:
                self.stats.cache_hits += 1
                self._executables.move_to_end(key)
            else:
                self.stats.cache_misses += 1
                fn = self._executables[key] = make()
                self._note_trace()
                while len(self._executables) > MAX_EXECUTABLES:
                    self._executables.popitem(last=False)  # LRU eviction
        return fn, hit

    def _shape_key(self, bvh, predicates):
        if bvh.tree is None:
            raise ValueError("engine exec_* paths require an index with "
                             "N >= 2 (degenerate N handled by BVH directly)")
        geom = getattr(predicates, "geom", None)
        geom = geom if geom is not None else predicates.rays
        # the getter is part of the key: two same-shaped indexes with
        # different getters must not share one entry
        return (type(predicates).__name__, type(geom).__name__,
                type(bvh.values).__name__, len(predicates), bvh.size(),
                bvh._boxes.dim, bvh._getter, bvh.device.type)

    def exec_spatial(self, bvh, predicates, capacity: int):
        """Cached count + fill of an Intersects bucket. Returns ((counts,
        idx_buf), ExecInfo): full per-query counts plus the first
        `capacity` matched original indices per query (-1 padded)."""
        with self._route_span("spatial") as rsp:
            route = self.route_spatial(bvh, predicates)
            rsp.annotate(route=route)
        # the Points fine test (fine_sqrt) follows from the values' type,
        # which the shape key holds
        key = (route, "spatial", capacity) + self._shape_key(bvh, predicates)

        def make():
            if route == ROUTE_KERNEL:
                def body(index, preds):
                    return self.kernel_fill(index, preds, capacity)
            elif route == ROUTE_BRUTEFORCE:
                def body(index, preds):
                    return index._brute()._fill_impl(preds, capacity,
                                                     index.policy)
            else:
                def body(index, preds):
                    cb, s0 = CB.collect_hits(capacity)
                    s0 = _bcast_state(s0, len(preds), index.device)
                    count, idxs, _ = T.traverse(index.tree, index.values,
                                                preds, cb, s0)
                    return count, idxs
            return body

        fn, hit = self._cached(key, make)
        out, kus = self._launch(fn, (bvh, predicates), route=route,
                                op="spatial", hit=hit)
        return out, ExecInfo(route, hit, kus)

    def exec_knn(self, bvh, predicates):
        """Cached kNN of a Nearest bucket. Returns ((dists, idxs),
        ExecInfo)."""
        with self._route_span("knn") as rsp:
            route = self.route_knn(bvh, predicates)
            rsp.annotate(route=route)
        k = predicates.k
        key = (route, "knn", k) + self._shape_key(bvh, predicates)
        fn, hit = self._cached(key, lambda: self._knn_body(route, k))
        out, kus = self._launch(fn, (bvh, predicates), route=route,
                                op="knn", hit=hit)
        return out, ExecInfo(route, hit, kus)

    def exec_ray_nearest(self, bvh, rays, k: int):
        """Cached first k hits of a bucket of rays, routed as
        ``route_knn`` routes a RayNearest batch (the ray kNN kernel where
        it takes the values). Returns ((t, idx), ExecInfo), (Q, k) padded
        (inf, -1)."""
        preds = P.RayNearest(rays, k)
        with self._route_span("ray_nearest") as rsp:
            route = self.route_knn(bvh, preds)
            rsp.annotate(route=route)
        key = (route, "ray_nearest", k) + self._shape_key(bvh, preds)
        fn, hit = self._cached(key, lambda: self._knn_body(route, k))
        out, kus = self._launch(fn, (bvh, preds), route=route,
                                op="ray_nearest", hit=hit)
        return out, ExecInfo(route, hit, kus)

    def exec_collect(self, bvh, predicates, capacity: int):
        """Cached ``collect_hits`` pass of an Intersects bucket through
        the callback route (the callback kernel where ``route_callback``
        picks it): ((counts, idx_buf (Q, capacity)), ExecInfo), full
        counts and the first `capacity` matches in walk order. The sharded
        executor's local fill, which must not take brute force or the
        spatial kernel."""
        cb, _ = CB.collect_hits(capacity)
        with self._route_span("collect") as rsp:
            route = self.route_callback(bvh, predicates, cb)
            rsp.annotate(route=route)
        key = (route, "collect", capacity) + self._shape_key(bvh, predicates)

        def make():
            def body(index, preds):
                hits, s0 = CB.collect_hits(capacity)
                s0 = _bcast_state(s0, len(preds), index.device)
                count, idxs, _ = index._query_callback_impl(
                    preds, hits, s0, index.policy)
                return count, idxs
            return body

        fn, hit = self._cached(key, make)
        out, kus = self._launch(fn, (bvh, predicates), route=route,
                                op="collect", hit=hit)
        return out, ExecInfo(route, hit, kus)

    def _knn_body(self, route, k):
        """A kNN entry (Nearest or RayNearest) for one route."""
        if route == ROUTE_KERNEL:
            return self.kernel_knn
        if route == ROUTE_BRUTEFORCE:
            return lambda index, preds: index._brute()._knn_impl(
                preds, index.policy)
        return lambda index, preds: T.traverse_knn(index.tree, index.values,
                                                   preds, k)


_DEFAULT = QueryEngine()


def default_engine() -> QueryEngine:
    return _DEFAULT


def set_default_engine(engine: QueryEngine):
    global _DEFAULT
    _DEFAULT = engine
