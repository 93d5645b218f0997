"""Hand-written CUDA kernels (``csrc/``) with their plain PyTorch twins.
Importing this package builds nothing: a kernel is compiled at its first
launch (see ``_build``). The stand-alone entry points are ``ops``
(``morton64``, ``bruteforce_knn``, ``ray_box_nearest``,
``flash_attention``, with the reference's signatures, as
``repro.kernels.ops``), and ``ref`` holds their oracles; the traversal kernels are reached through the core, and
exported here as the reference exports them. ``ray_box_nearest`` here is
the kernel's wrapper itself (float32 inputs, no tile keywords)."""
from . import ops, ref
from .bvh_traverse import bvh_traverse_knn, bvh_traverse_spatial
from .ops import bruteforce_knn, morton64
from .ray_box import ray_box_nearest

__all__ = ["ops", "ref", "morton64", "bruteforce_knn", "ray_box_nearest",
           "bvh_traverse_spatial", "bvh_traverse_knn"]
