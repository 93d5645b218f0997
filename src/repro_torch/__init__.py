"""ArborX 2.0 in PyTorch with hand-written CUDA kernels for Hopper: the
port of the JAX package ``repro`` (which stays the reference).

The main path builds an LBVH over points, boxes, spheres or triangles,
then answers batched spatial (CSR) and k-nearest queries through
``BVH(...).query()``, callback queries (``query(callback=)``,
``query(out=)``), DBSCAN (``dbscan``) and ray tracing (``raytracing``:
``cast_nearest``, ``cast_intersect``, ``cast_ordered``). The stand-alone
kernel ops are ``kernels.ops`` (``morton64``, ``bruteforce_knn``,
``ray_box_nearest``, as ``repro.kernels.ops``), with their oracles in
``kernels.ref``; ``REPRO_SANITIZE=1`` arms the kernels' output-contract
checks (``kernels.sanitize``). Entry points run on the CUDA card unless
the caller asks for the CPU with ``ExecutionPolicy(device="cpu")`` (or
passes CPU tensors to a kernel op), where the kernels' plain PyTorch
twins run instead.
"""
from .core import (BVH, BruteForce, EngineConfig, ExecutionPolicy, LBVH,
                   QueryEngine, QueryResult, RayIntersect, RayNearest,
                   RayOrderedIntersect, RouteRule, RouteTable, build,
                   callbacks, dbscan, intersects, nearest, raytracing, refit,
                   sah_cost)
from .core.geometry import Boxes, Points, Rays, Spheres, Triangles

__all__ = ["BVH", "BruteForce", "EngineConfig", "ExecutionPolicy", "LBVH",
           "QueryEngine", "QueryResult", "RouteRule", "RouteTable", "build",
           "callbacks", "dbscan", "intersects", "nearest", "raytracing",
           "refit", "sah_cost", "Points", "Boxes", "Spheres", "Triangles",
           "Rays", "RayNearest", "RayIntersect", "RayOrderedIntersect"]
