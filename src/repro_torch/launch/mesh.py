"""Device meshes over the initialised ``torch.distributed`` process group.

The counterpart of ``repro/launch/mesh.py``: the same axis names and
production shapes, as ``torch.distributed.device_mesh.DeviceMesh``es.
Functions, not module-level constants: importing this module touches no
process group.  A mesh is over ``"cuda"`` devices unless the caller asks
for ``"cpu"`` (gloo), as the tests do.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.distributed.sharding_rules import mesh_shape


def _world_size() -> int:
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("a mesh needs an initialised torch.distributed "
                           "process group (init_process_group)")
    return dist.get_world_size()


def make_production_mesh(multi_pod: bool = False, *, device: str = "cuda"):
    """``("data", "model")`` of (16, 16), or with ``multi_pod``
    ``("pod", "data", "model")`` of (2, 16, 16): raises unless the world
    size is their product."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = _world_size()
    if n != int(np.prod(shape)):
        raise ValueError(f"the production mesh {dict(zip(axes, shape))} "
                         f"needs {int(np.prod(shape))} ranks, the group has "
                         f"{n}")
    return init_device_mesh(device, shape, mesh_dim_names=axes)


def make_local_mesh(model_axis: int = 1, *, device: str = "cuda"):
    """``("data", "model")`` over every rank of the group, ``model_axis``
    of them along ``"model"``."""
    n = _world_size()
    if n % model_axis:
        raise ValueError(f"world size {n} is not a multiple of model_axis "
                         f"{model_axis}")
    return init_device_mesh(device, (n // model_axis, model_axis),
                            mesh_dim_names=("data", "model"))


def mesh_chips(mesh) -> int:
    return int(np.prod(list(mesh_shape(mesh).values())))


def batch_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh_shape(mesh))
