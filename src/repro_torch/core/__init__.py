"""The port's core: geometry, predicates, Morton codes, the LBVH build,
the query engine, the traversal walks and callbacks, the Index
implementations (BVH, BruteForce, and DistributedTree over a
``torch.distributed`` process group with its collectives in ``comm``),
and the algorithms: DBSCAN, EMST, MLS
interpolation and ray tracing."""
from . import (access, callbacks, comm, engine, geometry, morton, predicates,
               raytracing, route_table, traversal)
from .brute_force import BruteForce
from .bvh import BVH
from .dbscan import dbscan
from .distributed import DistributedTree
from .emst import emst
from .engine import (EngineConfig, QueryEngine, default_engine,
                     set_default_engine)
from .index import ExecutionPolicy, Index, QueryResult
from .interpolation import mls_interpolate
from .lbvh import LBVH, build, refit, refit_with_quality, sah_cost
from .predicates import (RayIntersect, RayNearest, RayOrderedIntersect,
                         intersects, nearest)
from .raytracing import cast_intersect, cast_nearest, cast_ordered
from .route_table import RouteRule, RouteTable

__all__ = [
    "Index", "ExecutionPolicy", "QueryResult", "BVH", "BruteForce",
    "DistributedTree", "LBVH",
    "build", "refit", "refit_with_quality", "sah_cost", "QueryEngine",
    "EngineConfig", "default_engine", "set_default_engine", "RouteRule",
    "RouteTable", "intersects", "nearest",
    "RayNearest", "RayIntersect", "RayOrderedIntersect", "dbscan", "emst",
    "mls_interpolate", "cast_nearest", "cast_intersect", "cast_ordered",
    "access", "callbacks", "comm", "engine", "geometry", "morton", "predicates",
    "raytracing", "route_table", "traversal",
]
