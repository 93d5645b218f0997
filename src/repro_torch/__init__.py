"""ArborX 2.0 in PyTorch with hand-written CUDA kernels for Hopper: the
port of the JAX package ``repro`` (which stays the reference).

The main path builds an LBVH over points, boxes or spheres, then answers
batched spatial (CSR) and k-nearest queries through ``BVH(...).query()``,
callback queries (``query(callback=)``, ``query(out=)``) and DBSCAN
(``dbscan``). Entry points run on the CUDA card unless the caller asks
for the CPU with ``ExecutionPolicy(device="cpu")``, where the kernels'
plain PyTorch twins run instead.
"""
from .core import (BVH, BruteForce, EngineConfig, ExecutionPolicy, LBVH,
                   QueryEngine, QueryResult, RouteRule, RouteTable, build,
                   callbacks, dbscan, intersects, nearest, refit, sah_cost)
from .core.geometry import Boxes, Points, Spheres

__all__ = ["BVH", "BruteForce", "EngineConfig", "ExecutionPolicy", "LBVH",
           "QueryEngine", "QueryResult", "RouteRule", "RouteTable", "build",
           "callbacks", "dbscan", "intersects", "nearest", "refit",
           "sah_cost", "Points", "Boxes", "Spheres"]
