"""Async deadline-aware serving pipeline, as ``repro.service.pipeline``.

The synchronous ``QueryServer`` answers whatever batch the caller hands
it; this module models the *live* half of the problem: many independent
clients submitting single requests with latency budgets, while the
geometry underneath keeps moving. Three actors, three threads:

  * clients call :meth:`ServingPipeline.submit` — validate, timestamp,
    enqueue into the per-group pending queue, get a :class:`Ticket`
    (future) back. Never waits for the device.
  * ONE scheduler thread forms shape-bucketed batches *adaptively*: a
    group closes when it holds ``max_bucket`` rows (full) or when the
    tightest queued deadline budget — minus the EWMA-measured service
    estimate for the bucket it would ride in, minus a slack — is about to
    be spent. Closed groups dispatch through the engine's warm executable
    cache against a **pinned** ``IndexStore`` version, then results
    scatter back into the tickets with full timing stats.
  * ONE maintenance thread owns index refresh: :meth:`update_index`
    enqueues (coalescing to the newest values per index) and returns
    immediately; the worker runs refit-or-rebuild in a shadow index
    (``IndexStore.update`` builds OUTSIDE the registry lock) and
    publishes via the store's atomic version swap. The serving loop never
    waits on a build — in-flight batches finish on their pinned version
    and the next formed batch picks up the new one.

Two streams on the card. The kernel wrappers launch on the calling
thread's current stream. The scheduler serves on its thread's stream
(the default one); the maintenance thread runs under a
``torch.cuda.Stream`` of its own, so a refit or rebuild overlaps the
serving walks instead of queueing behind them. The caching allocator
ties each block to the stream it was allocated on and may hand a freed
block to that stream's next allocation at once, without waiting for any
other stream. What keeps a tree's memory from being reused under a
reader is that no stream has work queued on a version's tensors when the
last reference to it goes:

  * the maintenance stream: the store publishes a version only after
    synchronizing the building thread's current stream (which blocks the
    maintenance thread alone), and the maintenance thread synchronizes it
    again after every update, failed ones included;
  * the serving stream: ``execute_group`` ends in one blocking
    device-to-host copy of the group's results, and the pin is released
    only after it returns, so every walk that read the version is done.
  * values a client made on its own stream: ``update_index`` records an
    event there, and the maintenance stream waits on it before reading.

``Tensor.record_stream`` would defer each free instead, but it must be
applied to every tensor a version holds on every stream that reads it,
and a version's tensors are read by whichever stream serves it next;
the synchronizations above cover them all at one point each.

Deadline accounting: a request submitted at t with ``deadline_us=D`` is
on time iff results are delivered by t + D. The scheduler therefore
closes the group no later than ``t + D - est_service(bucket) - slack``,
where est_service is an exponentially weighted average of measured batch
service times per (group key, bucket). Requests without a deadline ride
with whoever closes the bucket, capped by ``max_linger_us`` so an idle
trickle still flows.

A ``ShardedIndexStore`` of R > 1 ranks runs one pipeline a rank, every
rank a process, and ONE scheduler that all ranks follow. Each rank's own
scheduler would batch by its own arrival times, so the ranks would form
different groups and their collectives would not line up:

  * the LEADER is rank 0 of the store's group. Clients submit there (a
    follower's ``submit`` raises), and its scheduler forms the groups as
    above. Before it runs a group it broadcasts it on the store's
    serving group (a ``comm.Work``: kind, k, bucket, the members' rows,
    the index name, the version it pinned, the bucket's arrays);
  * every FOLLOWER's scheduler thread receives the groups and runs them
    in the leader's order (``ShardedExecutor.execute_group``) until the
    leader's stop, which ``close()`` on the leader sends. A follower pins
    the version the leader pinned, waiting (bounded by the store's
    timeout) for its own maintenance thread to publish it, or taking it
    from its history when it is a step ahead;
  * MAINTENANCE: ``create_index`` and ``update_index`` are the leader's,
    with the GLOBAL values (every rank's block in rank order; rank r
    indexes block r). The leader's maintenance thread broadcasts each
    build and each coalesced update (``comm.broadcast_object``) on the
    store's maintenance group, and every rank's maintenance thread runs
    it in that order, concurrently with serving;
  * a failure on any rank does not split the world: the store and the
    executor agree on it (``comm.RankFailure`` on every rank), so every
    rank publishes an update or none does (each counts it in
    ``maintenance_errors``), and a failed group fails the leader's
    tickets for that group and leaves the ranks in step;
  * while idle the leader sends a heartbeat on both groups every
    ``HEARTBEAT_S``, so no follower waits in a collective past its
    timeout. A follower's ``stats()`` counts the groups it served in
    ``batches`` (and their rows), the requests of groups that failed in
    ``failed``, and the maintenance it ran.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time

import torch

from ..core import comm
from ..core import engine as E
from ..core.access import default_indexable_getter
from ..core.distributed import DistributedTree
from ..telemetry import MetricsRegistry
from ..telemetry import tracer as TEL
from .batcher import Batcher, Group, Request, bucket_size, validate_kind
from .index_store import IndexStore, IndexVersion
from .server import Response, ServiceConfig, execute_group

__all__ = ["PipelineConfig", "PipelineStats", "PipelineStatsSnapshot",
           "Ticket", "ServingPipeline", "REQUEST_PHASES"]

#: over a sharded store of R > 1 ranks, the longest the leader stays
#: silent on either group while idle, in seconds: a heartbeat keeps the
#: followers' waiting collectives inside their timeout
HEARTBEAT_S = 1.0

#: request phase names, in wall-clock order; the phases tile the request's
#: lifetime exactly: submit+queue+batch = queue_wait_us and
#: dispatch+kernel = service_us
REQUEST_PHASES = ("submit", "queue", "batch", "dispatch", "kernel")


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """service: the bucket ladder / capacity / rebuild knobs shared with the
    synchronous server (``service.max_bucket`` is the adaptive batcher's
    "full" threshold).
    max_linger_us: a group holding only deadline-less requests closes once
    its oldest member has waited this long.
    deadline_slack_us: safety margin subtracted from every deadline budget
    (scheduler wakeup jitter + scatter cost).
    default_service_est_us: assumed batch service time for a (key, bucket)
    never measured before (cold caches are far slower than this — the
    first dispatch of a bucket is expected to miss tight deadlines).
    est_alpha: EWMA weight of the newest service-time measurement.
    est_safety: multiplier on the estimate when budgeting a close — the
    EWMA tracks the MEAN service time, but a close cut at the mean misses
    half the time (service jitter + dispatches queueing behind other
    groups on the single scheduler thread), so budget conservatively."""
    service: ServiceConfig = ServiceConfig()
    max_linger_us: float = 5_000.0
    deadline_slack_us: float = 2_000.0
    default_service_est_us: float = 20_000.0
    est_alpha: float = 0.3
    est_safety: float = 1.5


@dataclasses.dataclass(frozen=True)
class PipelineStatsSnapshot:
    """Immutable point-in-time copy of :class:`PipelineStats` — what
    ``ServingPipeline.stats()`` hands back."""
    submitted: int = 0
    served: int = 0
    failed: int = 0
    deadline_missed: int = 0
    batches: int = 0
    batch_rows: int = 0            # real rows dispatched
    batch_slots: int = 0           # bucket slots dispatched
    closed_full: int = 0           # group reached max_bucket rows
    closed_deadline: int = 0       # deadline budget forced the close
    closed_drain: int = 0          # pipeline shutdown flush
    queue_depth: int = 0           # gauge: requests waiting right now
    max_queue_depth: int = 0
    swap_count: int = 0            # maintenance publishes (refits + rebuilds)
    refits: int = 0
    rebuilds: int = 0
    maintenance_pending: int = 0   # gauge: queued + in-flight updates
    maintenance_errors: int = 0
    stalled_behind_maintenance: int = 0

    @property
    def occupancy(self) -> float:
        return self.batch_rows / self.batch_slots if self.batch_slots else 0.0

    @property
    def miss_rate(self) -> float:
        return self.deadline_missed / self.served if self.served else 0.0

    def snapshot(self) -> "PipelineStatsSnapshot":
        return self


def _counter_prop(field: str) -> property:
    def _get(self):
        return self._counters[field].value

    def _set(self, v):
        self._counters[field].set(v)

    return property(_get, _set)


def _gauge_prop(field: str) -> property:
    def _get(self):
        return self._gauges[field].value

    def _set(self, v):
        self._gauges[field].set(v)

    return property(_get, _set)


class PipelineStats:
    """Pipeline-level counters (snapshot via ``ServingPipeline.stats()``).

    Occupancy is ``batch_rows / batch_slots`` — how much of each dispatched
    bucket carried real queries. ``stalled_behind_maintenance`` counts
    dispatches that had to wait for an in-progress build/refit; the design
    makes that impossible (maintenance publishes finished indexes via the
    atomic swap), so the smoke pins it at zero.

    The fields are views over a per-instance telemetry
    :class:`~repro_torch.telemetry.MetricsRegistry` (``.registry``), so
    they flow into the JSONL metrics export. ``queue_depth`` is a
    registry Gauge whose high-water mark updates atomically inside every
    level change; ``max_queue_depth`` reads that mark.
    """

    _COUNTER_FIELDS = (
        "submitted", "served", "failed", "deadline_missed", "batches",
        "batch_rows", "batch_slots", "closed_full", "closed_deadline",
        "closed_drain", "swap_count", "refits", "rebuilds",
        "maintenance_errors", "stalled_behind_maintenance")
    _GAUGE_FIELDS = ("queue_depth", "maintenance_pending")
    _FIELDS = tuple(f.name for f in
                    dataclasses.fields(PipelineStatsSnapshot))

    submitted = _counter_prop("submitted")
    served = _counter_prop("served")
    failed = _counter_prop("failed")
    deadline_missed = _counter_prop("deadline_missed")
    batches = _counter_prop("batches")
    batch_rows = _counter_prop("batch_rows")
    batch_slots = _counter_prop("batch_slots")
    closed_full = _counter_prop("closed_full")
    closed_deadline = _counter_prop("closed_deadline")
    closed_drain = _counter_prop("closed_drain")
    swap_count = _counter_prop("swap_count")
    refits = _counter_prop("refits")
    rebuilds = _counter_prop("rebuilds")
    maintenance_errors = _counter_prop("maintenance_errors")
    stalled_behind_maintenance = _counter_prop("stalled_behind_maintenance")
    queue_depth = _gauge_prop("queue_depth")
    maintenance_pending = _gauge_prop("maintenance_pending")

    def __init__(self, registry=None, **legacy):
        self.registry = registry if registry is not None else MetricsRegistry()
        self._counters = {f: self.registry.counter(f"pipeline.{f}")
                          for f in self._COUNTER_FIELDS}
        self._gauges = {f: self.registry.gauge(f"pipeline.{f}")
                        for f in self._GAUGE_FIELDS}
        if legacy:
            # the API-v1 spelling: fields seeded by keyword, warned once
            unknown = sorted(set(legacy) - set(self._FIELDS))
            if unknown:
                raise TypeError(
                    f"PipelineStats got unexpected fields {unknown}")
            from ..core.index import _warn_deprecated
            _warn_deprecated(
                "PipelineStats.kwargs",
                "constructing PipelineStats with field keyword arguments is "
                "deprecated: the fields are now metrics in a telemetry "
                "MetricsRegistry (stats.registry); assign fields or use the "
                "registry instead")
            for k, v in legacy.items():
                if k == "max_queue_depth":
                    self._gauges["queue_depth"].note_high(int(v))
                else:
                    setattr(self, k, int(v))

    @property
    def max_queue_depth(self) -> int:
        """High-water mark of the queue-depth gauge — maintained inside
        the gauge's own lock, so it is race-free by construction."""
        return self._gauges["queue_depth"].high

    @max_queue_depth.setter
    def max_queue_depth(self, v):
        from ..core.index import _warn_deprecated
        _warn_deprecated(
            "PipelineStats.max_queue_depth",
            "assigning PipelineStats.max_queue_depth is deprecated: the "
            "high-water mark now updates atomically inside every "
            "queue_depth change; direct writes can only EXTEND it "
            "(note_high), never lower it")
        self._gauges["queue_depth"].note_high(int(v))

    @property
    def occupancy(self) -> float:
        return self.batch_rows / self.batch_slots if self.batch_slots else 0.0

    @property
    def miss_rate(self) -> float:
        return self.deadline_missed / self.served if self.served else 0.0

    def snapshot(self) -> PipelineStatsSnapshot:
        return PipelineStatsSnapshot(
            **{f: getattr(self, f) for f in self._FIELDS})

    def __repr__(self):
        body = ", ".join(f"{f}={getattr(self, f)}" for f in self._FIELDS)
        return f"PipelineStats({body})"


class Ticket:
    """Future for one submitted request. ``result()`` blocks until the
    scheduler delivers the :class:`Response` (or re-raises the dispatch
    failure); ``stats`` on the response carries queue_wait_us / service_us
    / deadline_missed alongside the usual route/bucket/version fields."""

    __slots__ = ("request", "deadline_us", "t_submit", "t_enqueued",
                 "_event", "_response", "_error")

    def __init__(self, request: Request, deadline_us: float | None,
                 t_submit: float):
        self.request = request
        self.deadline_us = deadline_us
        self.t_submit = t_submit
        self.t_enqueued = t_submit      # stamped again once actually queued
        self._event = threading.Event()
        self._response: Response | None = None
        self._error: BaseException | None = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: float | None = None) -> Response:
        if not self._event.wait(timeout):
            raise TimeoutError("request not served within "
                               f"{timeout}s (pipeline running?)")
        if self._error is not None:
            raise self._error
        return self._response

    # scheduler-side
    def _complete(self, response: Response):
        self._response = response
        self._event.set()

    def _fail(self, error: BaseException):
        self._error = error
        self._event.set()


class ServingPipeline:
    """Deadline-aware async frontend over IndexStore + Batcher + engine.
    Without a `store` it makes one on `device` (None: the CUDA card,
    raising without one; "cpu" for the plain twins). Over a sharded store
    of R > 1 ranks every rank makes one, and rank 0 leads (module
    docstring)."""

    #: lock discipline. _closing is a threading.Event, atomic on its own,
    #: because it is read under both conditions.
    _REPROLINT_GUARDED_BY = {"_queues": "_cv", "_est": "_cv",
                             "_stats": "_cv", "_maint": "_maint_cv",
                             "_maint_inflight": "_maint_cv"}

    def __init__(self, store: IndexStore | None = None,
                 engine: E.QueryEngine | None = None,
                 config: PipelineConfig | None = None, *, device=None):
        self.config = config or PipelineConfig()
        svc = self.config.service
        if store is not None:
            self.store = store
            self.engine = engine if engine is not None else store.engine
        else:
            self.engine = engine if engine is not None else E.QueryEngine()
            self.store = IndexStore(
                self.engine, rebuild_threshold=svc.rebuild_threshold,
                device=device)
        #: this process's rank in a sharded store's group (0 leads) and
        #: the group's size; 0 and 1 for a single-device store
        self.rank = getattr(self.store, "rank", 0)
        self.ranks = getattr(self.store, "ranks", 1)
        #: the exception that ended a follower's loops early (a broken
        #: group, a leader gone), None while they run or after the stop
        self.error: BaseException | None = None
        self.batcher = Batcher(svc.min_bucket)
        dev = self.store.device
        #: the maintenance thread's own stream on the card (None on the CPU)
        self.maintenance_stream = \
            torch.cuda.Stream(dev) if dev.type == "cuda" else None

        self._cv = threading.Condition()            # queues + stats
        self._queues: dict[tuple, collections.deque[Ticket]] = {}
        self._est: dict[tuple, float] = {}          # (key, bucket) -> EWMA us
        self._stats = PipelineStats()
        self._closing = threading.Event()           # atomic: read under
                                                    # BOTH cvs (see above)

        self._maint_cv = threading.Condition()      # maintenance inbox
        self._maint: collections.OrderedDict[str, object] = \
            collections.OrderedDict()
        self._maint_inflight = 0
        # the leader's maintenance-group broadcasts and the collectives
        # that follow each, one message at a time (create_index runs on
        # the caller's thread, updates and heartbeats on the maintenance
        # thread)
        self._maint_io = threading.Lock()
        # when the leader last sent on each group (its scheduler and its
        # maintenance thread each write their own)
        self._sent_serve = self._sent_maint = time.perf_counter()

        leader = self.rank == 0
        self._scheduler = threading.Thread(
            target=self._run_scheduler if leader else self._run_follower,
            name="repro-pipeline-scheduler", daemon=True)
        self._maintainer = threading.Thread(
            target=self._run_maintenance if leader
            else self._follow_maintenance,
            name="repro-pipeline-maintenance", daemon=True)
        self._scheduler.start()
        self._maintainer.start()

    # -- lifecycle ----------------------------------------------------------
    def __enter__(self) -> "ServingPipeline":
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self, timeout: float = 30.0):
        """Drain: serve everything already submitted, finish queued
        maintenance, stop both threads. Idempotent. On the leader of a
        sharded store this also stops every follower; on a follower it
        waits (at most `timeout` seconds a thread) for the leader's
        stop."""
        if self.rank == 0:
            self._closing.set()
            with self._cv:
                self._cv.notify_all()
            with self._maint_cv:
                self._maint_cv.notify_all()
        self._scheduler.join(timeout)
        self._maintainer.join(timeout)

    def _follower_refuses(self, what: str):
        if self.rank != 0:
            raise RuntimeError(
                f"{what} on rank {self.rank}: this pipeline follows rank 0 "
                f"of its {self.ranks}-rank store, which forms every group and "
                f"orders every index write; call {what} on rank 0")

    # -- index lifecycle ----------------------------------------------------
    def create_index(self, name: str, values,
                     indexable_getter=default_indexable_getter) -> IndexVersion:
        """Synchronous initial build — serving needs version 1 to exist.
        Over a sharded store of R > 1 ranks this is the leader's, with the
        global values: every rank builds its block."""
        if self.ranks == 1:
            return self.store.build(name, values, indexable_getter)
        self._follower_refuses("create_index")
        with self._maint_io:
            host = self._share("build", name, values, indexable_getter)
            return self.store.build(name, self._block(host),
                                    indexable_getter)

    def update_index(self, name: str, values):
        """Enqueue a refresh of `name` to moved `values` and return
        immediately; the maintenance worker refits-or-rebuilds a shadow
        index and publishes it via the store's atomic swap. Updates for
        the same name coalesce to the newest values (a moving-points
        stream only ever needs the latest geometry). Over a sharded store
        of R > 1 ranks this is the leader's, with the global values."""
        self._follower_refuses("update_index")
        ready = None
        if self.maintenance_stream is not None:
            # the values may still be in the making on the caller's stream
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.store.device))
        with self._maint_cv:
            if self._closing.is_set():
                raise RuntimeError("pipeline is closed")
            self._maint[name] = (values, ready)
            with self._cv:
                self._stats.maintenance_pending = \
                    len(self._maint) + self._maint_inflight
            self._maint_cv.notify()

    def wait_maintenance_idle(self, timeout: float = 30.0) -> bool:
        """Block until no update is queued or in flight (for tests/benches
        that need a published version before asserting)."""
        deadline = time.perf_counter() + timeout
        with self._maint_cv:
            while self._maint or self._maint_inflight:
                left = deadline - time.perf_counter()
                if left <= 0:
                    return False
                self._maint_cv.wait(left)
        return True

    # -- serving ------------------------------------------------------------
    def submit(self, request: Request, *,
               deadline_us: float | None = None) -> Ticket:
        """Enqueue one request; returns a Ticket future. `deadline_us` is
        the total latency budget from this call; None = best effort
        (bounded by max_linger_us of batching delay). Over a sharded
        store of R > 1 ranks clients submit to the leader only."""
        self._follower_refuses("submit")
        validate_kind(request.kind)
        with TEL.span("pipeline.submit", kind=request.kind):
            ticket = Ticket(request, deadline_us, time.perf_counter())
            with self._cv:
                if self._closing.is_set():
                    raise RuntimeError("pipeline is closed")
                key = self.batcher.group_key(request)
                self._queues.setdefault(key,
                                        collections.deque()).append(ticket)
                self._stats.submitted += 1
                # the queue-depth gauge tracks its own high-water mark
                # atomically inside this write — no separate (and
                # race-prone) max_queue_depth read-modify-write
                self._stats.queue_depth += 1
                self._cv.notify()
            ticket.t_enqueued = time.perf_counter()
        return ticket

    def stats(self) -> PipelineStatsSnapshot:
        with self._cv:
            return self._stats.snapshot()

    @property
    def metrics_registry(self):
        """The live telemetry :class:`MetricsRegistry` behind ``stats()``
        — hand it to ``telemetry.write_metrics_jsonl`` for the line-
        oriented dump."""
        with self._cv:
            return self._stats.registry

    def warmup(self, index: str, kinds_ks=None, max_bucket=None, dim=None):
        """Prepare the bucket ladder through the shared executable cache
        (same contract as ``QueryServer.warmup`` — all three kinds by
        default). Over a sharded store of R > 1 ranks the leader sends one
        best-effort request a (kind, k, bucket) through its own scheduler,
        so every rank's cache warms in the same order (they count in
        ``stats()``); on a follower this returns at once."""
        from .server import QueryServer, warmup_requests
        if self.ranks == 1:
            QueryServer(self.store, self.engine, self.config.service).warmup(
                index, kinds_ks, max_bucket, dim)
            return
        if self.rank != 0:
            return
        dim = dim if dim is not None else self.store.get(index).dim
        for reqs in warmup_requests(self.config.service, index, kinds_ks,
                                    max_bucket, dim):
            for t in [self.submit(r) for r in reqs]:
                t.result(self.store.timeout)

    # -- scheduler ----------------------------------------------------------
    # reprolint: holds=_cv
    def _close_by(self, key: tuple, tickets: collections.deque[Ticket],
                  now: float) -> float:
        """Absolute perf_counter time by which this group must dispatch:
        min over members of (submit + budget) - service estimate - slack."""
        cfg = self.config
        rows = sum(t.request.m for t in tickets)
        est = self._est.get((key, bucket_size(rows, self.batcher.min_bucket)),
                            cfg.default_service_est_us) * cfg.est_safety
        close = float("inf")
        for t in tickets:
            budget = t.deadline_us if t.deadline_us is not None \
                else cfg.max_linger_us
            close = min(close,
                        t.t_submit + (budget - est - cfg.deadline_slack_us)
                        * 1e-6)
        return close

    def _pick(self, now: float):  # reprolint: holds=_cv
        """Under the lock: choose one group ready to dispatch (full, out of
        deadline budget, or draining). Returns (key, tickets, reason) or
        (None, None, wait_seconds)."""
        max_rows = self.config.service.max_bucket
        wait = None
        for key, q in self._queues.items():
            if not q:
                continue
            rows = sum(t.request.m for t in q)
            if rows >= max_rows or self._closing.is_set():
                reason = "drain" if self._closing.is_set() and rows < max_rows \
                    else "full"
                # take members up to max_bucket rows (always >= 1 request:
                # a single over-sized request dispatches alone at its
                # natural bucket)
                taken, acc = [], 0
                while q and (not taken or acc + q[0].request.m <= max_rows):
                    t = q.popleft()
                    taken.append(t)
                    acc += t.request.m
                return key, taken, reason
            close = self._close_by(key, q, now)
            if now >= close:
                taken = list(q)
                q.clear()
                return key, taken, "deadline"
            wait = close - now if wait is None else min(wait, close - now)
        return None, None, wait

    def _run_scheduler(self):
        beat = HEARTBEAT_S if self.ranks > 1 else None
        while True:
            with self._cv:
                while True:
                    now = time.perf_counter()
                    key, taken, extra = self._pick(now)
                    if taken is not None:
                        self._stats.queue_depth -= len(taken)
                        break
                    if self._closing.is_set():
                        break
                    # extra is seconds until the earliest forced close (or
                    # None when idle); a leader also wakes for its next
                    # heartbeat. Clamp so a just-passed deadline doesn't
                    # busy-spin
                    if beat is not None:
                        quiet = self._sent_serve + beat - now
                        if quiet <= 0:
                            break
                        extra = quiet if extra is None else min(extra, quiet)
                    self._cv.wait(None if extra is None else max(extra, 1e-4))
            if taken is not None:
                self._dispatch(key, taken, extra, time.perf_counter())
            elif self._closing.is_set():
                if self.ranks > 1:
                    self._send_work(comm.Work(comm.STOP))
                return
            else:
                self._send_work(comm.Work(comm.NOP))

    def _send_work(self, work: comm.Work):
        """Hand `work` to the followers (the leader's scheduler thread)."""
        comm.broadcast_object(self.store._serve, work)
        self._sent_serve = time.perf_counter()

    def _run_follower(self):
        """A follower's scheduler thread: run the leader's groups in the
        leader's order until its stop."""
        store, svc = self.store, self.config.service
        while True:
            try:
                work = comm.broadcast_object(store._serve)
            except Exception as err:     # the group broke: nothing more comes
                self.error = err
                return
            if work.kind == comm.STOP:
                self._closing.set()
                return
            if work.kind == comm.NOP:
                continue
            group = Group(key=(work.index, work.kind, work.k,
                               work.a.shape[1]),
                          a=work.a, b=work.b, bucket=work.bucket,
                          n_real=work.n_real, members=work.members)
            entry = error = None
            try:
                entry = store.pin_published(work.index, work.version,
                                            store.timeout)
            except Exception as err:     # agreed on inside the group
                error = err
            ok = True
            try:
                with TEL.span("pipeline.follow", kind=work.kind,
                              bucket=work.bucket, version=work.version):
                    store.executor.execute_group(svc, entry, group, error)
            except Exception:
                ok = False
            finally:
                if entry is not None:
                    store.release(entry)
            with self._cv:
                s = self._stats
                if ok:
                    s.batches += 1
                    s.batch_rows += group.n_real
                    s.batch_slots += group.bucket
                else:
                    s.failed += len(group.members)

    def _dispatch(self, key: tuple, tickets: list[Ticket], reason: str,
                  t_picked: float | None = None):
        """Outside the lock: pin -> execute -> scatter -> account.
        `t_picked` is when the scheduler pulled the group off its queue —
        the queue/batch phase boundary in the request's span tree."""
        with TEL.span("pipeline.dispatch", reason=reason,
                      requests=len(tickets)) as dsp:
            group = self.batcher.plan([t.request for t in tickets])[0]
            dsp.annotate(index=group.index, bucket=group.bucket)
            t_disp = time.perf_counter()
            if t_picked is None:
                t_picked = t_disp
            try:
                entry = self.store.pin(group.index)
            except KeyError as err:
                miss = KeyError(f"no index named {group.index!r} "
                                "(create_index before submitting)")
                miss.__cause__ = err
                with self._cv:
                    self._stats.failed += len(tickets)
                for t in tickets:
                    t._fail(miss)
                return
            try:
                if self.ranks > 1:
                    self._send_work(comm.Work(
                        group.kind, k=group.k, bucket=group.bucket,
                        n_real=group.n_real, members=group.members,
                        index=group.index, version=entry.version,
                        a=group.a, b=group.b))
                responses = execute_group(self.engine, self.config.service,
                                          entry, group)
            except Exception as err:
                with self._cv:
                    self._stats.failed += len(tickets)
                for t in tickets:
                    t._fail(err)
                return
            finally:
                self.store.release(entry)
            t_done = time.perf_counter()

        service_us = (t_done - t_disp) * 1e6
        tracer = TEL.get_tracer() if TEL.enabled() else None
        missed = 0
        for rid, ticket in enumerate(tickets):
            resp = responses[rid]
            total_us = (t_done - ticket.t_submit) * 1e6
            late = (ticket.deadline_us is not None
                    and total_us > ticket.deadline_us)
            missed += late
            phases = self._phase_breakdown(ticket, t_picked, t_disp,
                                           service_us, resp.stats.kernel_us)
            span_id = 0
            if tracer is not None:
                span_id = self._emit_request_spans(tracer, ticket, phases,
                                                   t_done, late)
            stats = dataclasses.replace(
                resp.stats,
                queue_wait_us=(t_disp - ticket.t_submit) * 1e6,
                service_us=service_us, deadline_us=ticket.deadline_us,
                deadline_missed=late, phase_us=phases, span_id=span_id)
            ticket._complete(dataclasses.replace(resp, stats=stats))

        self._account(key, group, tickets, reason, service_us, missed)

    @staticmethod
    def _phase_breakdown(ticket: Ticket, t_picked: float, t_disp: float,
                         service_us: float, kernel_us: float) -> dict:
        """Tile one request's lifetime into the REQUEST_PHASES dict (µs).

        The boundaries are clamped monotonic (t_submit <= t_enqueued <=
        t_picked <= t_disp), so submit+queue+batch == queue_wait_us and
        dispatch+kernel == service_us EXACTLY — the acceptance criterion's
        span-sum property holds by construction, not by luck."""
        t_enq = min(max(ticket.t_enqueued, ticket.t_submit), t_picked)
        t_pk = min(max(t_picked, t_enq), t_disp)
        kern = min(max(kernel_us, 0.0), service_us)
        return {
            "submit": (t_enq - ticket.t_submit) * 1e6,
            "queue": (t_pk - t_enq) * 1e6,
            "batch": (t_disp - t_pk) * 1e6,
            "dispatch": service_us - kern,
            "kernel": kern,
        }

    @staticmethod
    def _emit_request_spans(tracer, ticket: Ticket, phases: dict,
                            t_done: float, late: bool) -> int:
        """Retroactively synthesize one request's span tree — a "request"
        root spanning submit->delivery with one child per phase — and
        return the root span id (propagated into RequestStats.span_id so
        a deadline-missed response can be found in the trace). Phases are
        only fully known at batch completion, hence add_span rather than
        live spans."""
        t0_ns = int(ticket.t_submit * 1e9)
        root = tracer.add_span(
            "request", t0_ns, int(t_done * 1e9), tid="requests",
            kind=ticket.request.kind, deadline_missed=bool(late),
            deadline_us=ticket.deadline_us)
        cursor = t0_ns
        for phase in REQUEST_PHASES:
            dur_ns = int(phases[phase] * 1e3)
            tracer.add_span(
                f"request.{phase}", cursor, cursor + dur_ns,
                parent_id=root, tid="requests",
                clock="device" if phase == "kernel" else "wall",
                deadline_missed=bool(late))
            cursor += dur_ns
        return root

    def _account(self, key: tuple, group, tickets: list[Ticket],
                 reason: str, service_us: float, missed: int):
        """Post-scatter bookkeeping: EWMA service estimate + counters."""
        ewma_key = (key, group.bucket)
        with self._cv:
            prev = self._est.get(ewma_key)
            a = self.config.est_alpha
            self._est[ewma_key] = service_us if prev is None \
                else a * service_us + (1 - a) * prev
            s = self._stats
            s.served += len(tickets)
            s.deadline_missed += missed
            s.batches += 1
            s.batch_rows += group.n_real
            s.batch_slots += group.bucket
            if reason == "full":
                s.closed_full += 1
            elif reason == "deadline":
                s.closed_deadline += 1
            else:
                s.closed_drain += 1

    # -- maintenance --------------------------------------------------------
    def _run_maintenance(self):
        beat = HEARTBEAT_S if self.ranks > 1 else None
        while True:
            item = None
            with self._maint_cv:
                while not self._maint and not self._closing.is_set():
                    if beat is None:
                        self._maint_cv.wait()
                        continue
                    quiet = self._sent_maint + beat - time.perf_counter()
                    if quiet <= 0:
                        break
                    self._maint_cv.wait(quiet)
                if self._maint:
                    item = self._maint.popitem(last=False)
                    self._maint_inflight += 1
            if item is None:
                # closing with nothing queued, or a quiet heartbeat
                closing = self._closing.is_set()
                if beat is not None:
                    with self._maint_io:
                        comm.broadcast_object(
                            self.store._maint,
                            (comm.STOP if closing else comm.NOP,))
                        self._sent_maint = time.perf_counter()
                if closing:
                    return
                continue
            name, (values, ready) = item
            action, failed = None, False
            try:
                # the slow part: shadow build/refit outside every lock the
                # serving path touches; publication inside is one dict swap
                with TEL.span("pipeline.maintenance", index=name):
                    action = self._on_stream(
                        lambda: self._update(name, values), ready)
            except Exception:
                failed = True
            finally:
                self._maintenance_done(action, failed)

    def _maintenance_done(self, action, failed: bool):
        # the counters move before the update stops counting as in
        # flight, so wait_maintenance_idle returns only after they are
        # final (_maint_cv, then _cv: update_index's order)
        with self._maint_cv:
            self._maint_inflight -= 1
            with self._cv:
                s = self._stats
                s.maintenance_pending = \
                    len(self._maint) + self._maint_inflight
                if failed:
                    s.maintenance_errors += 1
                elif action is not None:
                    s.swap_count += 1
                    if action == "refit":
                        s.refits += 1
                    else:
                        s.rebuilds += 1
            self._maint_cv.notify_all()

    def _update(self, name, values) -> str:
        """One refit-or-rebuild; over R > 1 ranks the leader first hands
        the values to the followers, and every rank updates its block."""
        if self.ranks == 1:
            return self.store.update(name, values).action
        with self._maint_io:
            getter = self.store.get(name).tree._getter
            host = self._share("update", name, values, getter)
            return self.store.update(name, self._block(host)).action

    def _on_stream(self, fn, ready=None):
        """fn() on the maintenance stream (the calling thread's current
        stream on the CPU), after `ready` (an event of the stream the
        values were made on); the stream is synchronized after, failed
        calls included."""
        stream = self.maintenance_stream
        if stream is None:
            return fn()
        try:
            with torch.cuda.stream(stream):
                if ready is not None:
                    stream.wait_event(ready)
                return fn()
        finally:
            stream.synchronize()

    # -- the leader's maintenance messages ----------------------------------
    def _share(self, op: str, name: str, values, getter):
        """The leader's half of a build or update over R > 1 ranks: the
        global `values` adapted as the store adapts them, sent to every
        follower on the maintenance group; returns them on the host."""
        values = DistributedTree._adapt_values(values, getter)
        host = comm.tree_map(lambda t: t.detach().cpu(), values)
        comm.broadcast_object(self.store._maint, (op, name, host, getter))
        self._sent_maint = time.perf_counter()
        return host

    def _block(self, values):
        """This rank's block of the global `values` (rank r: rows
        [r n / R, (r + 1) n / R))."""
        n = []
        comm.tree_map(lambda t: n.append(t.shape[0]), values)
        if n[0] % self.ranks:
            raise ValueError(f"{n[0]} values do not split into {self.ranks} "
                             "equal blocks, one a rank")
        nl = n[0] // self.ranks
        return comm.tree_map(
            lambda t: t[self.rank * nl:(self.rank + 1) * nl], values)

    def _follow_maintenance(self):
        """A follower's maintenance thread: run the leader's builds and
        updates in its order until its stop."""
        while True:
            try:
                msg = comm.broadcast_object(self.store._maint)
            except Exception as err:     # the group broke: nothing more comes
                self.error = err
                return
            if msg[0] == comm.STOP:
                return
            if msg[0] == comm.NOP:
                continue
            op, name, values, getter = msg
            with self._maint_cv:
                self._maint_inflight += 1
            action, failed = None, False
            try:
                # a build is the leader's create_index, which raises there
                # and counts nowhere; an update counts on every rank
                with TEL.span("pipeline.maintenance", index=name, op=op):
                    if op == "build":
                        self._on_stream(lambda: self.store.build(
                            name, self._block(values), getter))
                    else:
                        action = self._on_stream(lambda: self.store.update(
                            name, self._block(values)).action)
            except Exception:
                failed = op != "build"
            finally:
                self._maintenance_done(action, failed)
