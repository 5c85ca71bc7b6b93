"""Device meshes: ``torch.distributed.device_mesh.DeviceMesh`` over the
ranks of the default process group.

Port of ``repro/launch/mesh.py``. A mesh is built by a function, never
at import: it needs the process group that ``launch.distributed``
initialises, and its size must be the world size.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch.distributed as dist

__all__ = ["PRODUCTION_MESHES", "make_mesh", "make_production_mesh"]

# (shape, axis names): 256 devices a pod; the multi-pod mesh adds the
# "pod" axis (cross-pod data parallelism, DESIGN.md §6).
PRODUCTION_MESHES = {
    False: ((16, 16), ("data", "model")),
    True: ((2, 16, 16), ("pod", "data", "model")),
}


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over every rank of
    the initialised default group. Its size must be the world size."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} / axes {axes} rank mismatch")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if math.prod(shape) != world:
        raise ValueError(f"mesh {dict(zip(axes, shape))} has "
                         f"{math.prod(shape)} devices; the world has {world} "
                         f"(run under torchrun or launch.distributed)")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(launch.distributed.init_distributed)")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """(16,16) data x model on one pod; (2,16,16) pod x data x model
    across two. Built only on a world of that many ranks."""
    shape, axes = PRODUCTION_MESHES[multi_pod]
    return make_mesh(shape, axes, device_type)
