"""Online geometric query service, as ``repro.service``.

A service layer that answers heterogeneous spatial / kNN / ray traffic
over *live* indexes, on the CUDA card unless the caller passes
``device="cpu"``:

  * :mod:`index_store` — versioned index registry with atomic
    build-and-swap, refit-or-rebuild updates (``lbvh.refit_with_quality``
    and the SAH quality monitor), and pinned versions for in-flight
    batches.
  * :mod:`batcher`     — shape-bucketed micro-batching: requests are
    grouped by predicate kind and padded to power-of-two buckets so every
    dispatch hits a warm entry of the engine's executable cache.
  * :mod:`server`      — synchronous ``QueryServer`` tying registry +
    batcher + ``QueryEngine`` together, with per-request stats (route,
    bucket, index version).
  * :mod:`sharded`     — distributed serving: ``ShardedIndexStore``
    builds and refits ``DistributedTree`` indexes, one local tree a rank
    of a ``torch.distributed`` process group, and publishes them through
    the same atomic swap; ``ShardedExecutor`` answers batches with
    all-gathered predicates, local traversals and ``all_to_all`` merges.
  * :mod:`pipeline`    — asynchronous, deadline-aware ``ServingPipeline``:
    clients ``submit(request, deadline_us=...)`` into a queue, a
    scheduler thread forms adaptive batches (close on full OR on deadline
    budget), and a background maintenance worker refits/rebuilds shadow
    indexes on a CUDA stream of its own and publishes via the atomic
    swap — maintenance never blocks serving.
"""
from .batcher import (SUPPORTED_KINDS, Batcher, Request, knn_request,
                      ray_request, within_request)
from .index_store import IndexStore, IndexVersion
from .pipeline import PipelineConfig, PipelineStats, ServingPipeline, Ticket
from .server import (QueryServer, RequestStats, Response, ServiceConfig,
                     execute_group)
from .sharded import ShardedExecutor, ShardedIndexStore, ShardedIndexVersion

__all__ = ["Batcher", "Request", "SUPPORTED_KINDS", "knn_request",
           "ray_request", "within_request", "IndexStore", "IndexVersion",
           "QueryServer", "RequestStats", "Response", "ServiceConfig",
           "execute_group", "ServingPipeline", "PipelineConfig",
           "PipelineStats", "Ticket", "ShardedExecutor", "ShardedIndexStore",
           "ShardedIndexVersion"]
