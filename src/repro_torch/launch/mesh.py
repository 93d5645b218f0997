"""Device meshes: the port of ``repro.launch.mesh``, on
``torch.distributed.device_mesh``.

Single pod: (16, 16) = ("data", "model"), 256 ranks. Multi-pod: (2, 16,
16) = ("pod", "data", "model"), 512 ranks; "pod" is a further pure
data-parallel axis, the hop that gradient compression
(``train.make_train_step(pod_group=...)``) targets. The shapes and names
are the reference's, so that its specs and the port's compare one to one.
On H100 nodes of 8 GPUs a 16-wide "model" axis spans two nodes: its
collectives cross InfiniBand, not NVLink alone.

A mesh is made over the ranks of the current ``torch.distributed`` world,
row-major (rank r sits at ``np.unravel_index(r, shape)``, as JAX lays its
devices). Functions, not module constants: importing this module touches
no process group.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

__all__ = ["AbstractMesh", "make_production_mesh", "make_host_mesh",
           "mesh_dp_axes", "mesh_shape", "make_mesh"]


class AbstractMesh:
    """Axis names and sizes without ranks or devices (JAX's
    ``AbstractMesh``): what the spec functions of ``launch.sharding`` read,
    so that a production mesh's specs are computed in any process."""

    def __init__(self, shape, axes):
        if len(shape) != len(axes):
            raise ValueError(f"shape {shape} and axes {axes} differ in rank")
        self.shape = tuple(int(s) for s in shape)
        self.mesh_dim_names = tuple(axes)

    def __repr__(self):
        return f"AbstractMesh({self.shape}, {self.mesh_dim_names})"


def _device_type(device_type: str | None) -> str:
    if device_type is not None:
        return device_type
    return "cuda" if torch.cuda.is_available() else "cpu"


def make_mesh(shape, axes, device_type: str | None = None) -> DeviceMesh:
    """A mesh of `shape` named `axes` over the world's ranks (a world of
    one when no process group is initialised: the shape's product must be
    1 then). The ranks fill the shape row-major."""
    n = 1
    for s in shape:
        n *= int(s)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n != world:
        raise ValueError(f"a mesh of shape {tuple(shape)} needs {n} ranks; "
                         f"the world has {world}")
    ranks = torch.arange(n).reshape(tuple(int(s) for s in shape))
    dev = _device_type(device_type)
    if not dist.is_initialized():
        # a world of one: the mesh needs a default group to stand on
        return DeviceMesh(dev, ranks, mesh_dim_names=tuple(axes),
                          _init_backend=False, _rank=0)
    return DeviceMesh(dev, ranks, mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str | None = None) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_host_mesh(model: int = 1, device_type: str | None = None
                   ) -> DeviceMesh:
    """A ("data", "model") mesh over the ranks that exist: data = world
    size // model (tests, CPU gloo worlds, one card)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if model < 1 or world % model:
        raise ValueError(f"--model-parallel {model} does not divide the "
                         f"world of {world} ranks")
    return make_mesh((world // model, model), ("data", "model"), device_type)


def mesh_shape(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` or an ``AbstractMesh``, the
    reference's ``mesh.shape``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def mesh_dp_axes(mesh) -> tuple:
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))
