"""Tracing spans with explicit clocks, as ``repro.telemetry.tracer``.

One :class:`Tracer` per process (the module-level default) records
*spans* — named, nested, timed intervals — into a bounded ring buffer.
Three properties the serving stack leans on:

  * **zero-cost when disabled**: the module-level ``span()`` helper
    checks one flag and returns a shared no-op context manager, so an
    instrumented hot path costs one attribute load + one truth test per
    site when telemetry is off: no stream is synchronized and the
    engine's executable cache never sees telemetry;
  * **bounded memory**: spans land in a ``deque(maxlen=capacity)`` —
    a long-lived service can stay instrumented forever; old spans fall
    off the back;
  * **explicit clocks**: every span is wall-clock by default
    (``time.perf_counter_ns`` — monotonic, thread-safe). Kernel spans
    call :meth:`_SpanCtx.fence` on the result, which synchronizes the
    calling thread's current CUDA stream on every card the result lives
    on and marks the span ``clock="device"``: its duration then includes
    the device work of that stream, not just the asynchronous launch.
    Fencing only happens when telemetry is enabled, so the disabled
    path never waits for the device.

Nesting is tracked per thread (a ``threading.local`` stack), so spans
opened on the scheduler thread never parent spans opened on the
maintenance thread. Spans whose boundaries are only known after the
fact (per-request phase attribution in the pipeline) are recorded
retroactively with :meth:`Tracer.add_span`.

Every span is opened with ``with span(...)``, which closes it on every
exception path.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import os
import threading
import time

import torch

__all__ = ["Span", "Tracer", "span", "enable", "disable", "enabled",
           "get_tracer", "set_tracer"]


@dataclasses.dataclass(frozen=True)
class Span:
    """One recorded interval. Times are ``perf_counter_ns`` values; the
    exporters convert to trace-relative microseconds."""
    name: str
    span_id: int
    parent_id: int          # 0 = root
    tid: str                # thread name
    t0_ns: int
    dur_ns: int
    clock: str = "wall"     # "wall" | "device" (fenced by a stream sync)
    args: dict = dataclasses.field(default_factory=dict)


class _NullSpan:
    """Shared no-op context manager handed out while telemetry is
    disabled; every method is a pass so instrumented call sites need no
    enabled-checks of their own."""

    __slots__ = ()
    span_id = 0
    dur_us = 0.0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def annotate(self, **kw):
        return self

    def fence(self, value):
        return value


NULL_SPAN = _NullSpan()


class _SpanCtx:
    """Live (open) span: a context manager that records itself into the
    tracer ring on exit, including exception exits."""

    __slots__ = ("_tracer", "name", "span_id", "parent_id", "args",
                 "_t0", "_t_fence", "_dur", "clock")

    def __init__(self, tracer: "Tracer", name: str, args: dict):
        self._tracer = tracer
        self.name = name
        self.span_id = next(tracer._ids)
        self.parent_id = 0
        self.args = args
        self._t0 = 0
        self._t_fence = None
        self._dur = 0
        self.clock = "wall"

    def __enter__(self):
        stack = self._tracer._stack()
        self.parent_id = stack[-1] if stack else 0
        stack.append(self.span_id)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = self._t_fence if self._t_fence is not None \
            else time.perf_counter_ns()
        stack = self._tracer._stack()
        if stack and stack[-1] == self.span_id:
            stack.pop()
        if exc and exc[0] is not None:
            self.args = dict(self.args, error=getattr(
                exc[0], "__name__", str(exc[0])))
        self._dur = max(t1 - self._t0, 0)
        self._tracer._record(Span(
            name=self.name, span_id=self.span_id, parent_id=self.parent_id,
            tid=threading.current_thread().name, t0_ns=self._t0,
            dur_ns=self._dur, clock=self.clock, args=self.args))
        return False

    @property
    def dur_us(self) -> float:
        """Recorded duration in microseconds (0.0 until the span closes).
        Lets a caller reuse the span's own timing — e.g. the engine feeds
        it into ``ExecInfo.kernel_us`` — instead of re-measuring."""
        return self._dur / 1e3

    def annotate(self, **kw):
        self.args = dict(self.args, **kw)
        return self

    def fence(self, value):
        """Wait until `value` (tensors, possibly inside tuples, lists,
        dicts and dataclasses such as ``LBVH``) is computed, then stamp
        the span as device-clocked: its duration now covers the device
        work, not just the launch. For every CUDA device the value lives
        on, this synchronizes that device's current stream on the calling
        thread, never the whole device: work another thread queued on its
        own stream (the pipeline's maintenance stream) is not charged to
        this span. CPU tensors are computed already. Returns `value` for
        drop-in wrapping."""
        for dev in sorted(_cuda_devices(value, set()), key=str):
            torch.cuda.current_stream(dev).synchronize()
        self._t_fence = time.perf_counter_ns()
        self.clock = "device"
        return value


def _cuda_devices(value, found: set) -> set:
    """The CUDA devices of every tensor inside `value`."""
    if isinstance(value, torch.Tensor):
        if value.is_cuda:
            found.add(value.device)
    elif isinstance(value, (tuple, list)):
        for v in value:
            _cuda_devices(v, found)
    elif isinstance(value, dict):
        for v in value.values():
            _cuda_devices(v, found)
    elif dataclasses.is_dataclass(value) and not isinstance(value, type):
        for f in dataclasses.fields(value):
            _cuda_devices(getattr(value, f.name), found)
    return found


class Tracer:
    """Thread-safe ring-buffered span recorder."""

    def __init__(self, capacity: int = 8192):
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._tls = threading.local()
        self.epoch_ns = time.perf_counter_ns()

    # -- recording -----------------------------------------------------------
    def span(self, name: str, **args) -> _SpanCtx:
        """Open a nested span: ``with tracer.span("engine.kernel") as sp``.
        Always use ``with`` (or try/finally)."""
        return _SpanCtx(self, name, args)

    def add_span(self, name: str, t0_ns: int, t1_ns: int, *,
                 parent_id: int = 0, tid: str | None = None,
                 clock: str = "wall", **args) -> int:
        """Record a span whose boundaries were measured elsewhere (the
        pipeline's per-request phase attribution: the phases are only
        known once the batch completes). Returns the new span id."""
        sid = next(self._ids)
        self._record(Span(
            name=name, span_id=sid, parent_id=parent_id,
            tid=tid if tid is not None else threading.current_thread().name,
            t0_ns=t0_ns, dur_ns=max(t1_ns - t0_ns, 0), clock=clock,
            args=args))
        return sid

    def _record(self, span_: Span):
        with self._lock:
            self._ring.append(span_)

    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    # -- reading -------------------------------------------------------------
    def spans(self) -> list:
        """Snapshot of the ring (oldest first), without clearing."""
        with self._lock:
            return list(self._ring)

    def drain(self) -> list:
        """Snapshot AND clear the ring."""
        with self._lock:
            out = list(self._ring)
            self._ring.clear()
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)


class _Config:
    """Module-level switch + default tracer. ``enabled`` is a plain bool
    read once per ``span()`` call — the whole disabled-path cost."""

    __slots__ = ("enabled", "tracer")

    def __init__(self):
        self.enabled = os.environ.get(
            "REPRO_TELEMETRY", "") not in ("", "0", "off")
        self.tracer = Tracer()


_CONFIG = _Config()


def span(name: str, **args):
    """Module-level convenience: a span on the default tracer, or the
    shared no-op when telemetry is disabled."""
    if not _CONFIG.enabled:
        return NULL_SPAN
    return _CONFIG.tracer.span(name, **args)


def enabled() -> bool:
    return _CONFIG.enabled


def enable(capacity: int | None = None) -> Tracer:
    """Turn tracing on (optionally with a fresh ring of `capacity`);
    returns the active tracer."""
    if capacity is not None:
        _CONFIG.tracer = Tracer(capacity)
    _CONFIG.enabled = True
    return _CONFIG.tracer


def disable():
    _CONFIG.enabled = False


def get_tracer() -> Tracer:
    return _CONFIG.tracer


def set_tracer(tracer: Tracer):
    _CONFIG.tracer = tracer
