"""Ray tracing (ArborX 2.0 section 2.5): thin conveniences over
:meth:`~repro_torch.core.index.Index.query`, returning the reference's
tuples (``repro.core.raytracing``).

  * ``cast_nearest(index, rays, k)``: the first k hits along each ray,
    ``query(RayNearest(rays, k))``, ascending in the ray parameter t;
  * ``cast_intersect(index, rays)``: every hit, CSR (transparent
    objects), ``query(RayIntersect(rays))``;
  * ``cast_ordered(index, rays)``: every hit, CSR, sorted by t within
    each ray, ``query(RayOrderedIntersect(rays))``.

On a BVH, ``cast_intersect`` and ``cast_ordered`` run the callback kernel
twice (a counting pass, then a collect pass); ``cast_nearest`` runs the
ray kNN kernel once (``kernels.bvh_traverse.bvh_traverse_ray_knn``),
whose lists equal those of the general k-nearest walk the reference
compiles, bit for bit.
"""
from __future__ import annotations

from . import geometry as G
from . import predicates as P

__all__ = ["cast_nearest", "cast_intersect", "cast_ordered"]


def cast_nearest(index, rays: G.Rays, k: int = 1):
    """(t, idx) (R, k): the first k hits, ascending in t, (inf, -1)
    padded."""
    res = index.query(P.RayNearest(rays, k))
    return res.distances, res.indices


def cast_intersect(index, rays: G.Rays, capacity: int | None = None):
    """(values, idx, offsets): every hit, CSR, in walk order within a
    ray."""
    res = index.query(P.RayIntersect(rays), capacity=capacity)
    return res.values, res.indices, res.offsets


def cast_ordered(index, rays: G.Rays, capacity: int | None = None):
    """(idx, t, offsets): every hit, CSR, ascending in t within a ray
    (equal t in walk order)."""
    res = index.query(P.RayOrderedIntersect(rays), capacity=capacity)
    return res.indices, res.distances, res.offsets
