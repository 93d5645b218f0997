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

A ``ShardedIndexStore`` is served at a world of one rank only. At more
ranks the constructor raises: every rank's scheduler would batch by its
own arrival times, so the ranks would form different groups and their
collectives would not line up (a leader that forms the groups and
followers that run them is a later item of ROADMAP.md).
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time

import torch

from ..core import engine as E
from ..core.access import default_indexable_getter
from ..telemetry import MetricsRegistry
from ..telemetry import tracer as TEL
from .batcher import Batcher, Request, bucket_size, validate_kind
from .index_store import IndexStore, IndexVersion
from .server import Response, ServiceConfig, execute_group

__all__ = ["PipelineConfig", "PipelineStats", "PipelineStatsSnapshot",
           "Ticket", "ServingPipeline", "REQUEST_PHASES"]

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

    def __init__(self, registry=None):
        self.registry = registry if registry is not None else MetricsRegistry()
        self._counters = {f: self.registry.counter(f"pipeline.{f}")
                          for f in self._COUNTER_FIELDS}
        self._gauges = {f: self.registry.gauge(f"pipeline.{f}")
                        for f in self._GAUGE_FIELDS}

    @property
    def max_queue_depth(self) -> int:
        """High-water mark of the queue-depth gauge — maintained inside
        the gauge's own lock, so it is race-free by construction."""
        return self._gauges["queue_depth"].high

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
    raising without one; "cpu" for the plain twins)."""

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
        if getattr(self.store, "ranks", 1) > 1:
            raise NotImplementedError(
                "ServingPipeline serves a ShardedIndexStore of one rank only "
                f"(this one spans {self.store.ranks}): each rank's scheduler "
                "batches by its own arrival times, so the ranks' groups and "
                "collectives would not line up; use QueryServer.handle with "
                "the same requests on every rank")
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

        self._scheduler = threading.Thread(
            target=self._run_scheduler, name="repro-pipeline-scheduler",
            daemon=True)
        self._maintainer = threading.Thread(
            target=self._run_maintenance, name="repro-pipeline-maintenance",
            daemon=True)
        self._scheduler.start()
        self._maintainer.start()

    # -- lifecycle ----------------------------------------------------------
    def __enter__(self) -> "ServingPipeline":
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self, timeout: float = 30.0):
        """Drain: serve everything already submitted, finish queued
        maintenance, stop both threads. Idempotent."""
        self._closing.set()
        with self._cv:
            self._cv.notify_all()
        with self._maint_cv:
            self._maint_cv.notify_all()
        self._scheduler.join(timeout)
        self._maintainer.join(timeout)

    # -- index lifecycle ----------------------------------------------------
    def create_index(self, name: str, values,
                     indexable_getter=default_indexable_getter) -> IndexVersion:
        """Synchronous initial build — serving needs version 1 to exist."""
        return self.store.build(name, values, indexable_getter)

    def update_index(self, name: str, values):
        """Enqueue a refresh of `name` to moved `values` and return
        immediately; the maintenance worker refits-or-rebuilds a shadow
        index and publishes it via the store's atomic swap. Updates for
        the same name coalesce to the newest values (a moving-points
        stream only ever needs the latest geometry)."""
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
        (bounded by max_linger_us of batching delay)."""
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
        default)."""
        from .server import QueryServer
        QueryServer(self.store, self.engine, self.config.service).warmup(
            index, kinds_ks, max_bucket, dim)

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
        while True:
            with self._cv:
                while True:
                    key, taken, extra = self._pick(time.perf_counter())
                    if taken is not None:
                        self._stats.queue_depth -= len(taken)
                        break
                    if self._closing.is_set():
                        return
                    # extra is seconds until the earliest forced close (or
                    # None when idle); clamp so a just-passed deadline
                    # doesn't busy-spin
                    self._cv.wait(None if extra is None else max(extra, 1e-4))
            self._dispatch(key, taken, extra, time.perf_counter())

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
        while True:
            with self._maint_cv:
                while not self._maint:
                    if self._closing.is_set():
                        return
                    self._maint_cv.wait()
                name, (values, ready) = self._maint.popitem(last=False)
                self._maint_inflight += 1
            action, failed = None, False
            try:
                # the slow part: shadow build/refit outside every lock the
                # serving path touches; publication inside is one dict swap
                with TEL.span("pipeline.maintenance", index=name):
                    action = self._update(name, values, ready)
            except Exception:
                failed = True
            finally:
                # the counters move before the update stops counting as in
                # flight, so wait_maintenance_idle returns only after they
                # are final (_maint_cv, then _cv: update_index's order)
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

    def _update(self, name, values, ready) -> str:
        """One refit-or-rebuild on the maintenance stream (the calling
        thread's current stream on the CPU); returns the action."""
        stream = self.maintenance_stream
        if stream is None:
            return self.store.update(name, values).action
        try:
            with torch.cuda.stream(stream):
                stream.wait_event(ready)
                return self.store.update(name, values).action
        finally:
            stream.synchronize()
