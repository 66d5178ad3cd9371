"""Device meshes: the production mesh, 16 x 16 (data x model), or two of
them (a leading `pod` axis), and arbitrary ones for tests and reshapes
(the JAX package's `launch/mesh.py`).

Functions, not module-level constants: importing this module touches no
device and no process group.  `init_device_mesh` needs an initialized
process group of the mesh's size (a real one, or the dry-run's fake one).
The shapes and axis names are the reference's, so every spec compares.
"""
from __future__ import annotations

from typing import Sequence

PRODUCTION_SHAPE = (16, 16)
PRODUCTION_AXES = ("data", "model")


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device_type: str = "cuda"):
    """A DeviceMesh of `shape` over the process group's ranks (row-major)
    with axis names `axes`."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    shape = (2,) + PRODUCTION_SHAPE if multi_pod else PRODUCTION_SHAPE
    axes = ("pod",) + PRODUCTION_AXES if multi_pod else PRODUCTION_AXES
    return make_mesh(shape, axes, device_type)
