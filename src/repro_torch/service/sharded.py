"""Sharded serving: ``DistributedTree`` behind the service layer, as
``repro.service.sharded``.

  * :class:`ShardedIndexStore`: an :class:`IndexStore` over a process
    group. Builds publish :class:`~repro_torch.core.distributed.
    DistributedTree` indexes (one local LBVH a rank); updates refit every
    rank's tree on its own (``lbvh.refit_with_quality``) and re-exchange
    the (R, dim) top boxes; everything lands through the inherited
    atomic version swap and pins.
  * :class:`ShardedExecutor`: what ``server.execute_group`` routes a
    sharded version to. A group runs four stages, each under its own
    telemetry span: ``sharded.gather`` (the ranks' blocks of the bucket
    all-gathered), ``sharded.local_traverse`` (every rank answers every
    query against its local tree), ``sharded.exchange`` (the partial
    results ``all_to_all`` back to the rank that owns each row) and
    ``sharded.merge`` (kNN lists by distance, CSR buffers valid-first,
    counts summed).

Refit quality is watched PER RANK: the store keeps an (R,) tuple of SAH
costs, and the WORST rank degrading past ``rebuild_threshold`` turns the
update into a rebuild of every rank.

The store and the server run as one program on every rank: every rank
makes the same store and server calls with the same request lists. Rank
r originates block r of each bucket (padded to a multiple of R), and the
merged blocks are all-gathered, so every rank's ``Response`` objects hold
the whole group. Builds and updates run their collectives on a second
process group made at construction, so a maintenance thread's
collectives never interleave with the serving thread's on one group (at
more than one rank that thread is the caller's own: the pipeline's runs
at one rank only).
``ServingPipeline`` takes a store of one rank only (see its docstring).
"""
from __future__ import annotations

import dataclasses
import datetime
import threading

import numpy as np
import torch
import torch.distributed as dist

from ..core import comm
from ..core import geometry as G
from ..core import lbvh
from ..core import predicates as P
from ..core.access import default_indexable_getter
from ..core.distributed import DistributedTree, merge_fill, merge_knn
from ..core.index import ExecutionPolicy
from ..telemetry import tracer as TEL
from .batcher import KIND_KNN, KIND_WITHIN, Group, _pad_edge
from .index_store import IndexStore, _settle
from .server import RequestStats, Response, ServiceConfig, _to_host

__all__ = ["ShardedExecutor", "ShardedIndexStore", "ShardedIndexVersion"]


@dataclasses.dataclass(frozen=True)
class ShardedIndexVersion:
    """Immutable snapshot of one published sharded index version, as
    :class:`~repro_torch.service.index_store.IndexVersion` with per-rank
    quality: ``sah`` / ``sah_built`` are (R,) tuples, and
    :attr:`degradation` is the worst rank's."""
    name: str
    version: int
    tree: DistributedTree
    action: str                 # "build" | "refit" | "rebuild"
    sah: tuple                  # per-rank quality of THIS tree
    sah_built: tuple            # per-rank quality at the last full build
    refits_since_build: int
    executor: "ShardedExecutor" = dataclasses.field(repr=False)

    #: the routing flag ``server.execute_group`` reads
    sharded = True

    @property
    def degradation(self) -> float:
        """The worst rank's SAH cost relative to its at-build cost."""
        return max(s / max(b, 1e-30)
                   for s, b in zip(self.sah, self.sah_built))

    @property
    def dim(self) -> int:
        return int(self.tree.dim)


@dataclasses.dataclass(frozen=True)
class _StagePlan:
    """The kind-specific stages of one (kind, k, capacity, n_local)
    family, between the tree's own gather and exchange; the tree arrives
    as an argument, so a refit of the same index reuses them. Nothing is
    compiled or sized for a plan: ``cache_hit`` says only that the key
    was served before, as the reference's plan cache reports it."""
    local: object
    merge: object


class ShardedExecutor:
    """Runs planned :class:`~repro_torch.service.batcher.Group` batches
    against a pinned :class:`ShardedIndexVersion` as four collective
    stages. With telemetry on, each stage is fenced under its own span,
    so the report shows where distributed time goes; off, nothing
    waits."""

    #: the plan cache is shared by every thread dispatching on this group
    _REPROLINT_GUARDED_BY = {"_stages": "_lock"}

    def __init__(self, group, device: torch.device):
        self.group = group
        self.R = comm.size(group)
        self.rank = comm.rank(group)
        self.device = device
        self._lock = threading.Lock()
        self._stages: dict[tuple, _StagePlan] = {}

    def _plan(self, kind: str, k: int, capacity: int,
              n_local: int) -> tuple[_StagePlan, bool]:
        key = (kind, k, capacity, n_local)
        with self._lock:
            plan = self._stages.get(key)
            warm = plan is not None
            if plan is None:
                plan = self._stages[key] = self._build_plan(kind, k, capacity)
        return plan, warm

    @staticmethod
    def _build_plan(kind, k, capacity) -> _StagePlan:
        if kind == KIND_WITHIN:
            def local(tree, centers, radii):
                return tree._local_fill(P.intersects(G.Spheres(
                    centers, radii)), capacity, tree.policy)

            def merge(count, gi):
                return merge_fill(count, gi, capacity)
        else:
            # kNN and ray-nearest share the merge: (Q, k) distances (the
            # ray parameter t for rays) and global indices
            def local(tree, a, b=None):
                preds = (P.nearest(G.Points(a), k=k) if kind == KIND_KNN
                         else P.RayNearest(G.Rays(a, b), k))
                return tree._local_knn(preds, tree.policy)

            def merge(d, gi):
                return merge_knn(d, gi, k)

        return _StagePlan(local, merge)

    def execute_group(self, config: ServiceConfig, entry: ShardedIndexVersion,
                      group: Group) -> dict[int, Response]:
        """Serve ONE planned group against a pinned sharded version and
        scatter the results to per-request Responses: the sharded
        counterpart of ``server.execute_group``, which routes here. Every
        rank calls it with the same group."""
        tree = entry.tree
        R = self.R
        qp = -(-group.bucket // R) * R
        q = qp // R
        rows = slice(self.rank * q, (self.rank + 1) * q)
        blocks = tuple(
            torch.from_numpy(np.ascontiguousarray(_pad_edge(x, qp)[rows]))
            .to(self.device) for x in (group.a, group.b) if x is not None)
        cap = config.capacity if group.kind == KIND_WITHIN else 0
        plan, warm = self._plan(group.kind, group.k, cap, tree.n_local)

        kernel_us = 0.0
        with TEL.span("sharded.execute_group", kind=group.kind,
                      bucket=group.bucket, shards=R, index=entry.name,
                      version=entry.version):
            with TEL.span("sharded.gather", kind=group.kind, q=qp) as sp:
                gathered = sp.fence(tree._gather(blocks))
            kernel_us += sp.dur_us
            with TEL.span("sharded.local_traverse", kind=group.kind,
                          n_local=tree.n_local) as sp:
                partial = sp.fence(plan.local(tree, *gathered))
            kernel_us += sp.dur_us
            with TEL.span("sharded.exchange", kind=group.kind) as sp:
                exchanged = sp.fence(tree._exchange(partial))
            kernel_us += sp.dur_us
            with TEL.span("sharded.merge", kind=group.kind) as sp:
                merged = sp.fence(plan.merge(*exchanged))
            kernel_us += sp.dur_us

            # every rank's merged block, so each rank holds the whole group
            with TEL.span("server.assemble", kind=group.kind):
                res_rows = _to_host(*comm.all_gather(self.group, merged))

            out: dict[int, Response] = {}
            with TEL.span("server.scatter", requests=len(group.members)):
                stats = RequestStats(
                    kind=group.kind, route="sharded", bucket=group.bucket,
                    index_name=entry.name, index_version=entry.version,
                    cache_hit=warm, kernel_us=kernel_us)
                if group.kind == KIND_WITHIN:
                    counts, buf = res_rows
                    over = counts > config.capacity
                    for rid, start, m in group.members:
                        sl = slice(start, start + m)
                        out[rid] = Response(
                            stats, counts=counts[sl], idxs=buf[sl],
                            overflow=bool(over[sl].any()))
                else:
                    d, i = res_rows
                    for rid, start, m in group.members:
                        sl = slice(start, start + m)
                        out[rid] = Response(stats, dists=d[sl], idxs=i[sl])
        return out


class ShardedIndexStore(IndexStore):
    """Thread-safe name -> :class:`ShardedIndexVersion` registry over the
    ranks of `group` (None: the default group).

    The :class:`IndexStore` contract (atomic swap under the registry
    lock, history ring, pins) with entries that wrap a
    :class:`DistributedTree`. `device` is where every rank's local tree
    lives (None: the card); `timeout` bounds each collective of the
    maintenance group this store makes."""

    def __init__(self, group=None, engine=None, *,
                 rebuild_threshold: float = 1.5, keep_versions: int = 3,
                 policy: ExecutionPolicy | None = None, device=None,
                 timeout: datetime.timedelta = datetime.timedelta(seconds=60)):
        group = comm.group_of(group)
        super().__init__(engine, rebuild_threshold=rebuild_threshold,
                         keep_versions=keep_versions, device=device)
        comm.check_device(group, self.device)
        self.group = group
        self.ranks = comm.size(group)
        self.rank = comm.rank(group)
        self._maint = dist.new_group(
            ranks=dist.get_process_group_ranks(group),
            backend=dist.get_backend(group), timeout=timeout)
        base = policy or ExecutionPolicy()
        self.policy = dataclasses.replace(
            base, engine=base.engine or self.engine, device=self.device)
        self.executor = ShardedExecutor(group, self.device)

    # -- writes --------------------------------------------------------------
    def build(self, name: str, values,
              indexable_getter=default_indexable_getter):
        """Build every rank's local tree over its block of `values` and
        atomically publish the next version."""
        return self._publish_sharded(name, values, indexable_getter,
                                     action="build")

    def update(self, name: str, values):
        """Refit every rank's local tree to its moved block on its own
        (the only exchange: the top boxes and the SAH costs); rebuild when
        any rank's leaf count changed or the WORST rank degraded past the
        threshold. Runs outside the registry lock; only the finished
        version swaps in."""
        cur = self.get(name)
        tree = cur.tree
        getter = tree._getter
        values = DistributedTree._adapt_values(values, getter)
        values = values.to(self.device)
        boxes = getter(values)
        same = comm.agree(self._maint, [len(boxes) == tree.n_local],
                          self.device)
        if not bool(same.all()):
            return self._publish_sharded(name, values, getter,
                                         action="rebuild")

        with TEL.span("store.refit", index=name, n=tree.size(),
                      shards=tree.R) as sp:
            new, sah = lbvh.refit_with_quality(tree.tree, boxes)
            row = comm.stack(self._maint, torch.cat(
                [new.node_lo[0], new.node_hi[0], sah.reshape(1)]))
            sp.fence(new)
            dim = tree.dim
            top_lo, top_hi = row[:, :dim], row[:, dim:2 * dim]
            sah = tuple(float(s) for s in row[:, 2 * dim].cpu())
            sp.annotate(degradation=max(
                s / max(b, 1e-30) for s, b in zip(sah, cur.sah_built)))
        if any(s > self.rebuild_threshold * b
               for s, b in zip(sah, cur.sah_built)):
            return self._publish_sharded(name, values, getter,
                                         action="rebuild")

        new_tree = DistributedTree.from_local_trees(
            self._maint, values, new, top_lo, top_hi, getter,
            policy=tree.policy)._with_group(self.group)
        _settle(self.device)
        return self._swap(ShardedIndexVersion(
            name=name, version=0, tree=new_tree, action="refit", sah=sah,
            sah_built=cur.sah_built,
            refits_since_build=cur.refits_since_build + 1,
            executor=self.executor))

    # -- internals -----------------------------------------------------------
    def _publish_sharded(self, name, values, getter, *, action):
        with TEL.span("store.build", index=name, action=action,
                      sharded=True) as sp:
            tree = DistributedTree(self._maint, values, getter,
                                   policy=self.policy)
            sah = comm.stack(self._maint, lbvh.sah_cost(tree.tree).reshape(1))
            sp.fence(tree.tree)
            sah = tuple(float(s) for s in sah[:, 0].cpu())
            sp.annotate(n=tree.size(), shards=tree.R)
        _settle(self.device)
        return self._swap(ShardedIndexVersion(
            name=name, version=0, tree=tree._with_group(self.group),
            action=action, sah=sah, sah_built=sah, refits_since_build=0,
            executor=self.executor))
