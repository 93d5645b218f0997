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
the whole group. Serving and maintenance each run their collectives on a
process group the store makes at construction, both bounded by the
store's `timeout`, so a maintenance thread's collectives never interleave
with the serving thread's. ``ServingPipeline`` serves a store of R > 1
ranks from a leader (rank 0), which forms the groups and hands each one
to its followers (see its docstring).

A step that fails on one rank is agreed on (``core.comm``): the ranks
raise :class:`~repro_torch.core.comm.RankFailure` together, a failed
update publishes on no rank, and a failed group leaves the group in step.
"""
from __future__ import annotations

import dataclasses
import datetime

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
from .server import _HOST_DTYPES, RequestStats, Response, ServiceConfig

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


class ShardedExecutor:
    """Runs planned :class:`~repro_torch.service.batcher.Group` batches
    against a pinned :class:`ShardedIndexVersion` as four collective
    stages. With telemetry on, each stage is fenced under its own span,
    so the report shows where distributed time goes; off, nothing
    waits.

    The local walk goes through the local engine's executable cache
    (``exec_knn``, ``exec_ray_nearest`` and ``exec_collect`` on the rank's
    local BVH, whose route table never takes brute force), and a
    response's ``cache_hit`` is that cache's. Every rank runs the same
    collectives whatever happens on it: a local step that fails, or a
    version a follower could not pin (`error`), leaves neutral rows in its
    place, the failure flag rides in the last collective, and every rank
    raises :class:`~repro_torch.core.comm.RankFailure` together, so the
    group stays in step for the next batch."""

    def __init__(self, group, device: torch.device):
        self.group = group
        self.R = comm.size(group)
        self.rank = comm.rank(group)
        self.device = device

    def _local(self, tree: DistributedTree, kind: str, k: int,
               capacity: int, a, b=None):
        """This rank's partials of every gathered query, with global
        indices, and whether the cache entry was warm."""
        local = tree.local
        engine = local.policy.resolve_engine()
        if kind == KIND_WITHIN:
            (count, idxs), info = engine.exec_collect(
                local, P.intersects(G.Spheres(a, b)), capacity)
            out = (count.to(torch.int32), tree._globalize(idxs))
        elif kind == KIND_KNN:
            (d, i), info = engine.exec_knn(local, P.nearest(G.Points(a), k=k))
            out = (d, tree._globalize(i))
        else:
            (d, i), info = engine.exec_ray_nearest(local, G.Rays(a, b), k)
            out = (d, tree._globalize(i))
        return out, info.cache_hit

    def _neutral(self, kind: str, q: int, k: int, capacity: int):
        """Rows a failed step leaves in place: no match, no neighbour."""
        dev = self.device
        if kind == KIND_WITHIN:
            return (torch.zeros((q,), dtype=torch.int32, device=dev),
                    torch.full((q, capacity), -1, dtype=torch.int32,
                               device=dev))
        return (torch.full((q, k), float("inf"), device=dev),
                torch.full((q, k), -1, dtype=torch.int32, device=dev))

    def execute_group(self, config: ServiceConfig,
                      entry: ShardedIndexVersion | None, group: Group,
                      error: BaseException | None = None
                      ) -> dict[int, Response]:
        """Serve ONE planned group against a pinned sharded version and
        scatter the results to per-request Responses: the sharded
        counterpart of ``server.execute_group``, which routes here. Every
        rank calls it with the same group; a rank that could not pin the
        version passes entry None and its `error`, and takes part all the
        same. Raises RankFailure on every rank when a step failed on any."""
        R = self.R
        qp = -(-group.bucket // R) * R
        q = qp // R
        rows = slice(self.rank * q, (self.rank + 1) * q)
        blocks = tuple(
            torch.from_numpy(np.ascontiguousarray(_pad_edge(x, qp)[rows]))
            .to(self.device) for x in (group.a, group.b) if x is not None)
        kind, k = group.kind, group.k
        cap = config.capacity if kind == KIND_WITHIN else 0
        tree = entry.tree if entry is not None else None
        name = entry.name if entry is not None else group.index
        version = entry.version if entry is not None else -1
        warm = False

        kernel_us = 0.0
        with TEL.span("sharded.execute_group", kind=kind,
                      bucket=group.bucket, shards=R, index=name,
                      version=version):
            with TEL.span("sharded.gather", kind=kind, q=qp) as sp:
                gathered = sp.fence(comm.all_gather(self.group, blocks))
            kernel_us += sp.dur_us
            with TEL.span("sharded.local_traverse", kind=kind,
                          n_local=tree.n_local if tree else 0) as sp:
                try:
                    if error is not None:
                        raise error
                    partial, warm = self._local(tree, kind, k, cap, *gathered)
                except Exception as err:    # agreed on after the exchange
                    error = err
                    partial = self._neutral(kind, qp, k, cap)
                partial = sp.fence(partial)
            kernel_us += sp.dur_us
            with TEL.span("sharded.exchange", kind=kind) as sp:
                exchanged = sp.fence(comm.all_to_all(self.group, tuple(
                    t.reshape((R, q) + t.shape[1:]) for t in partial)))
            kernel_us += sp.dur_us
            with TEL.span("sharded.merge", kind=kind) as sp:
                try:
                    merged = (merge_fill(*exchanged, cap)
                              if kind == KIND_WITHIN
                              else merge_knn(*exchanged, k))
                except Exception as err:
                    error = error or err
                    merged = self._neutral(kind, q, k, cap)
                merged = sp.fence(merged)
            kernel_us += sp.dur_us

            # every rank's merged block and its failure flag, in one
            # collective and one device-to-host copy
            with TEL.span("server.assemble", kind=kind):
                flag = torch.full((q, 1), int(error is not None),
                                  dtype=torch.int32, device=self.device)
                packed = comm.all_gather(self.group, torch.cat(
                    [m.reshape(q, -1).view(torch.int32) for m in merged]
                    + [flag], 1)).cpu().numpy()
            comm.raise_together(self.group, packed[::q, -1], error,
                                f"the sharded {kind} group on {name!r} "
                                f"v{version}")
            res_rows, at = [], 0
            for m in merged:
                w = m.reshape(q, -1).shape[1]
                host = packed[:, at:at + w].view(_HOST_DTYPES[m.dtype])
                res_rows.append(host.reshape((qp,) + tuple(m.shape[1:])))
                at += w

            out: dict[int, Response] = {}
            with TEL.span("server.scatter", requests=len(group.members)):
                stats = RequestStats(
                    kind=kind, route="sharded", bucket=group.bucket,
                    index_name=name, index_version=version,
                    cache_hit=warm, kernel_us=kernel_us)
                if kind == KIND_WITHIN:
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
        #: seconds every collective of this store's groups may wait
        self.timeout = timeout.total_seconds()
        ranks = dist.get_process_group_ranks(group)
        backend = dist.get_backend(group)
        # serving (the executor, the versions' query collectives) and
        # maintenance (builds, updates) each on a group of their own, so
        # a maintenance thread's collectives never interleave with the
        # serving thread's, and both bounded by `timeout`
        self._serve = dist.new_group(ranks=ranks, backend=backend,
                                     timeout=timeout)
        self._maint = dist.new_group(ranks=ranks, backend=backend,
                                     timeout=timeout)
        base = policy or ExecutionPolicy()
        self.policy = dataclasses.replace(
            base, engine=base.engine or self.engine, device=self.device)
        self.executor = ShardedExecutor(self._serve, self.device)

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
        version swaps in. A step that fails on one rank raises
        RankFailure on every rank, and none publishes."""
        cur = self.get(name)
        tree = cur.tree
        getter = tree._getter
        error, same = None, True
        try:
            values = DistributedTree._adapt_values(values, getter)
            values = values.to(self.device)
            boxes = getter(values)
            same = len(boxes) == tree.n_local
        except Exception as err:
            error = err
        table = comm.agree(self._maint, [same, error is not None],
                           self.device)
        comm.raise_together(self._maint, table[:, 1], error,
                            f"the update of {name!r}")
        if not bool(table[:, 0].all()):
            return self._publish_sharded(name, values, getter,
                                         action="rebuild")

        dim = tree.dim
        with TEL.span("store.refit", index=name, n=tree.size(),
                      shards=tree.R) as sp:
            # the top box, the SAH cost and a flag of the local refit in
            # one collective: a refit that failed on one rank raises on all
            try:
                new, sah = lbvh.refit_with_quality(tree.tree, boxes)
                row = torch.cat([new.node_lo[0], new.node_hi[0],
                                 sah.reshape(1), sah.new_ones((1,))])
            except Exception as err:
                error = err
                row = torch.zeros((2 * dim + 2,), dtype=boxes.lo.dtype,
                                  device=self.device)
            row = comm.stack(self._maint, row)
            comm.raise_together(self._maint, (row[:, -1] == 0).cpu(), error,
                                f"the refit of {name!r}")
            sp.fence(new)
            top_lo = row[:, :dim].contiguous()
            top_hi = row[:, dim:2 * dim].contiguous()
            sah = tuple(float(s) for s in row[:, 2 * dim].cpu())
            sp.annotate(degradation=max(
                s / max(b, 1e-30) for s, b in zip(sah, cur.sah_built)))
        if any(s > self.rebuild_threshold * b
               for s, b in zip(sah, cur.sah_built)):
            return self._publish_sharded(name, values, getter,
                                         action="rebuild")

        new_tree = DistributedTree.from_local_trees(
            self._maint, values, new, top_lo, top_hi, getter,
            policy=tree.policy)._with_group(self._serve)
        return self._commit(ShardedIndexVersion(
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
            error = None
            try:
                row = torch.cat([
                    lbvh.sah_cost(tree.tree).reshape(1).to(torch.float64),
                    torch.ones((1,), dtype=torch.float64,
                               device=self.device)])
            except Exception as err:
                error = err
                row = torch.zeros((2,), dtype=torch.float64,
                                  device=self.device)
            sah = comm.stack(self._maint, row)
            comm.raise_together(self._maint, (sah[:, 1] == 0).cpu(), error,
                                f"the {action} of {name!r}")
            sp.fence(tree.tree)
            sah = tuple(float(s) for s in sah[:, 0].cpu())
            sp.annotate(n=tree.size(), shards=tree.R)
        return self._commit(ShardedIndexVersion(
            name=name, version=0, tree=tree._with_group(self._serve),
            action=action, sah=sah, sah_built=sah, refits_since_build=0,
            executor=self.executor))

    def _commit(self, entry: ShardedIndexVersion) -> ShardedIndexVersion:
        """Settle this rank's stream, agree that every rank did, and
        publish: every rank swaps the version in, or none does."""
        error = None
        try:
            _settle(self.device)
        except Exception as err:
            error = err
        comm.check_all(self._maint, error, self.device,
                       f"the publication of {entry.name!r}")
        return self._swap(entry)
