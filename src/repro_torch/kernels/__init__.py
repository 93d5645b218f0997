"""Hand-written CUDA kernels (``csrc/``) with their plain PyTorch twins.
Importing this package builds nothing: a kernel is compiled at its first
launch (see ``_build``). ``ray_box_nearest`` is the stand-alone entry
point, as ``repro.kernels.ops.ray_box_nearest`` is the reference's; the
traversal kernels are reached through the core."""
from .ray_box import ray_box_nearest, ray_box_nearest_ref

__all__ = ["ray_box_nearest", "ray_box_nearest_ref"]
