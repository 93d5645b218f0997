"""ArborX 2.0 in PyTorch with hand-written CUDA kernels for Hopper: the
port of the JAX package ``repro`` (which stays the reference).

The main path builds an LBVH over points, boxes, spheres, triangles,
segments, tetrahedra or k-DOPs, then answers batched spatial (CSR) and
k-nearest queries through
``BVH(...).query()`` (``DistributedTree`` over a ``torch.distributed``
process group, one block of values a rank), callback queries (``query(callback=)``,
``query(out=)``), DBSCAN (``dbscan``), the Euclidean minimum spanning
tree (``emst``, over ``nearest(..., exclude=)``), MLS interpolation
(``mls_interpolate``) and ray tracing (``raytracing``: ``cast_nearest``,
``cast_intersect``, ``cast_ordered``). The stand-alone
kernel ops are ``kernels.ops`` (``morton64``, ``bruteforce_knn``,
``ray_box_nearest``, as ``repro.kernels.ops``), with their oracles in
``kernels.ref``; ``REPRO_SANITIZE=1`` arms the kernels' output-contract
checks (``kernels.sanitize``). The LM substrate is ``LM``
(``LM.from_config(get_config("tinyllama-1.1b"), seed=0)``), whose
``attn_impl="flash"`` runs ``kernels.ops.flash_attention``; it serves
(``models.serve``, ``launch.serve``) and trains (``models.lm.loss_fn``,
``optim``, ``train``, ``data``, ``checkpoint``, ``launch.train``). Entry points
run on the CUDA card unless the caller asks for the CPU with
``ExecutionPolicy(device="cpu")`` (``device="cpu"`` for ``LM`` and
``convert``, or CPU tensors for a kernel op), where the kernels' plain
PyTorch twins run instead.
"""
from .core import (BVH, BruteForce, DistributedTree, EngineConfig,
                   ExecutionPolicy, LBVH, QueryEngine, QueryResult,
                   RayIntersect, RayNearest, RayOrderedIntersect, RouteRule,
                   RouteTable, build, callbacks, dbscan, emst, intersects,
                   mls_interpolate, nearest, raytracing, refit, sah_cost)
from .configs import get_config
from .core.geometry import (Boxes, KDOPs, Points, Rays, Segments, Spheres,
                            Tetrahedra, Triangles, kdop_directions)
from .models import LM, ModelConfig

__all__ = ["BVH", "BruteForce", "DistributedTree", "EngineConfig",
           "ExecutionPolicy", "LBVH", "QueryEngine", "QueryResult",
           "RouteRule", "RouteTable", "build", "callbacks", "dbscan", "emst",
           "mls_interpolate", "intersects", "nearest", "raytracing", "refit",
           "sah_cost", "Points", "Boxes", "Spheres", "Triangles", "Segments",
           "Tetrahedra", "KDOPs", "kdop_directions", "Rays", "RayNearest",
           "RayIntersect", "RayOrderedIntersect", "LM", "ModelConfig",
           "get_config"]
