"""RouteTable: per-op crossover rules for the QueryEngine.

The port has two routes today: brute force (the all-pairs match matrix)
and the traversal kernels. The reference's TPU admission caps (a tree
staged whole in VMEM, a per-query output block in VMEM) and its kernel
block size do not carry over: the kernels read the tree from device
memory and write their buffers there. So the kernel route serves every
Points/Boxes-valued Intersects or Nearest batch that brute force does not
take, up to the k the kNN kernel's buckets reach
(``kernels.bvh_traverse.KNN_MAX_K``). Callback batches read no rule:
brute force never runs callbacks, and the loop route only serves what
the callback kernel cannot run, so there is no crossover to hold.

Defaults are built in; the reference's persisted ``ROUTE_TABLE.json``
is not read (it was measured on a CPU). An H100 table is measured by a
later slice.
"""
from __future__ import annotations

import dataclasses

__all__ = ["RouteRule", "RouteTable"]


@dataclasses.dataclass(frozen=True)
class RouteRule:
    """Crossover threshold for one op kind ("spatial" or "knn"):
    brute force serves a batch while N * Q is at most `bf_max_work`."""
    bf_max_work: int = 1 << 22


@dataclasses.dataclass(frozen=True)
class RouteTable:
    """Per-op routing rules; immutable, safe to share."""
    rules: dict            # op -> RouteRule ("default" is the fallback)

    def rule(self, op: str) -> RouteRule:
        return self.rules.get(op) or self.rules.get("default") or RouteRule()

    @classmethod
    def default(cls) -> "RouteTable":
        return cls(rules={"default": RouteRule()})
