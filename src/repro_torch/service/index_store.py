"""Versioned index registry with atomic build-and-swap, as
``repro.service.index_store``.

Between simulation time steps the geometry moves but mostly keeps its
identity, so a full rebuild (Morton sort + Karras ranges + linking) is
wasted work: the topology is coordinate-free and only the boxes are
stale. ``update`` therefore refits by default (``lbvh.refit_with_quality``:
the refit climb and the SAH cost of the new boxes) and falls back to a
full rebuild when

  * the leaf count changed (topology can't be reused), or
  * the SAH-style quality monitor says the drifted Morton order has
    degraded the tree past ``rebuild_threshold`` × its at-build cost.

Swap semantics: builds and refits run OUTSIDE the registry lock (they
are the slow part); the publication of the finished :class:`IndexVersion`
is a single dict assignment under the lock. Readers that grabbed the
previous version keep a fully consistent immutable snapshot; recent
versions stay in a small history ring, and pinned ones past it, so
in-flight queries never see a half-updated index.

On the card a version is published only after the building thread's
current stream is synchronized (``_settle``): the tree a reader on any
other stream finds in the registry is complete. Indexes live on the
store's ``device``: the CUDA card unless the caller passes one (the CPU
with ``device="cpu"``); without a card the default raises.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time

import torch

from ..core import engine as E
from ..core import lbvh
from ..core.access import default_indexable_getter
from ..core.bvh import BVH
from ..core.index import ExecutionPolicy, resolve_device
from ..telemetry import tracer as TEL

__all__ = ["IndexStore", "IndexVersion"]


@dataclasses.dataclass(frozen=True)
class IndexVersion:
    """Immutable snapshot of one published index version."""
    name: str
    version: int
    bvh: BVH
    action: str                 # "build" | "refit" | "rebuild"
    sah: float                  # quality of THIS tree
    sah_built: float            # quality at the last full (re)build
    refits_since_build: int

    @property
    def degradation(self) -> float:
        """Current SAH cost relative to the last full build (1.0 = fresh)."""
        return self.sah / max(self.sah_built, 1e-30)

    @property
    def dim(self) -> int:
        """Coordinate dimension of the indexed geometry."""
        return int(self.bvh._boxes.dim)


def _settle(device: torch.device):
    """Wait for the calling thread's current stream on `device`, so what
    it built is complete before another stream can read it."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


class IndexStore:
    """Thread-safe name -> IndexVersion registry with refit-aware updates."""

    #: the registry maps and the pin refcounts form one invariant (_trim
    #: consults _pins while mutating _history), so all three share a lock
    _REPROLINT_GUARDED_BY = {"_live": "_lock", "_history": "_lock",
                             "_pins": "_lock"}

    def __init__(self, engine: E.QueryEngine | None = None, *,
                 rebuild_threshold: float = 1.5, keep_versions: int = 3,
                 device=None):
        self.device = resolve_device(device)
        self.engine = engine if engine is not None else E.QueryEngine()
        self.rebuild_threshold = float(rebuild_threshold)
        self.keep_versions = int(keep_versions)
        # a condition over a plain lock: pin_published waits on it for a
        # version that _swap has not published yet
        self._lock = threading.Condition(threading.Lock())
        self._live: dict[str, IndexVersion] = {}
        self._history: dict[str, dict[int, IndexVersion]] = {}
        self._pins: dict[tuple[str, int], int] = {}

    # -- reads -------------------------------------------------------------
    def get(self, name: str, version: int | None = None) -> IndexVersion:
        with self._lock:
            if version is None:
                return self._live[name]
            return self._history[name][version]

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._live)

    # -- pinning -----------------------------------------------------------
    # In-flight batches dispatch against ONE version grabbed at formation
    # time. A pin is a refcount on (name, version): while it is held the
    # version stays resolvable through get() even if later swaps roll the
    # history ring past ``keep_versions``. The server releases a pin only
    # after its batch's results are on the host, so no queued launch still
    # reads a version whose memory a release may free.

    def pin(self, name: str, version: int | None = None) -> IndexVersion:
        """Grab the live (or a specific) version and hold it against history
        eviction until the matching :meth:`release`."""
        with self._lock:
            entry = (self._live[name] if version is None
                     else self._history[name][version])
            key = (entry.name, entry.version)
            self._pins[key] = self._pins.get(key, 0) + 1
            return entry

    def pin_published(self, name: str, version: int,
                      timeout: float) -> IndexVersion:
        """Pin `version` of `name` once this store has published it,
        waiting at most `timeout` seconds (TimeoutError after); a version
        already trimmed from the history raises KeyError. A sharded
        pipeline's follower pins the version its leader pinned with
        this."""
        deadline = time.monotonic() + timeout
        with self._lock:
            while name not in self._live \
                    or self._live[name].version < version:
                left = deadline - time.monotonic()
                if left <= 0:
                    have = self._live[name].version \
                        if name in self._live else None
                    raise TimeoutError(
                        f"index {name!r} version {version} was not published "
                        f"within {timeout} s (this store holds {have})")
                self._lock.wait(left)
            entry = self._history[name][version]
            key = (entry.name, entry.version)
            self._pins[key] = self._pins.get(key, 0) + 1
            return entry

    def release(self, entry: IndexVersion):
        with self._lock:
            key = (entry.name, entry.version)
            n = self._pins.get(key, 0) - 1
            if n <= 0:
                self._pins.pop(key, None)
            else:
                self._pins[key] = n
            self._trim(entry.name)

    @contextlib.contextmanager
    def pinned(self, name: str, version: int | None = None):
        """``with store.pinned(name) as entry:``: pin and release balanced
        on every control-flow path."""
        entry = self.pin(name, version)
        try:
            yield entry
        finally:
            self.release(entry)

    # -- writes ------------------------------------------------------------
    def build(self, name: str, values,
              indexable_getter=default_indexable_getter) -> IndexVersion:
        """Build a fresh index and atomically publish it as the next version."""
        return self._publish(name, values.to(self.device), indexable_getter,
                             action="build")

    def update(self, name: str, values) -> IndexVersion:
        """Refit the live index to moved values; rebuild if quality demands.

        `values` must be indexable by the getter the index was created
        with. Refit requires an unchanged leaf count; anything else (or a
        degenerate index) rebuilds.
        """
        cur = self.get(name)
        getter = cur.bvh._getter
        values = values.to(self.device)
        boxes = getter(values)
        if cur.bvh.tree is None or len(boxes) != cur.bvh.size():
            return self._publish(name, values, getter, action="rebuild")

        with TEL.span("store.refit", index=name, n=cur.bvh.size()) as sp:
            new_tree, sah = lbvh.refit_with_quality(cur.bvh.tree, boxes)
            sp.fence(new_tree)
            sah = float(sah)
        if sah > self.rebuild_threshold * cur.sah_built:
            return self._publish(name, values, getter, action="rebuild")

        bvh = BVH.from_tree(values, new_tree, getter, policy=cur.bvh.policy)
        _settle(self.device)
        return self._swap(IndexVersion(
            name=name, version=0, bvh=bvh, action="refit", sah=sah,
            sah_built=cur.sah_built,
            refits_since_build=cur.refits_since_build + 1))

    # -- internals ---------------------------------------------------------
    def _publish(self, name, values, getter, *, action) -> IndexVersion:
        with TEL.span("store.build", index=name, action=action) as sp:
            bvh = BVH(values, getter, policy=ExecutionPolicy(
                engine=self.engine, device=self.device))
            if bvh.tree is not None:
                sp.fence(bvh.tree)
                sah = float(lbvh.sah_cost(bvh.tree))
            else:
                sah = 0.0
            sp.annotate(n=bvh.size())
        _settle(self.device)
        return self._swap(IndexVersion(
            name=name, version=0, bvh=bvh, action=action, sah=sah,
            sah_built=sah, refits_since_build=0))

    def _swap(self, entry: IndexVersion) -> IndexVersion:
        """The atomic publish: version assignment + one dict write, both
        under the lock (the slow build/refit already happened outside)."""
        with TEL.span("store.swap", index=entry.name,
                      action=entry.action), self._lock:
            prev = self._live.get(entry.name)
            entry = dataclasses.replace(
                entry, version=(prev.version + 1) if prev else 1)
            self._live[entry.name] = entry
            hist = self._history.setdefault(entry.name, {})
            hist[entry.version] = entry
            self._trim(entry.name)
            self._lock.notify_all()
        return entry

    def _trim(self, name: str):  # reprolint: holds=_lock
        """Evict unpinned versions beyond keep_versions (lock held). The
        newest keep_versions entries are always retained (a pinned old
        version must never push the LIVE version out of history), and
        pinned older ones are skipped; they evict on release."""
        hist = self._history.get(name, {})
        for v in sorted(hist)[:-self.keep_versions]:
            if (name, v) not in self._pins:
                del hist[v]
