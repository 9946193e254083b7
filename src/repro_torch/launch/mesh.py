"""Production meshes over ``torch.distributed``.

Port of :mod:`repro.launch.mesh`. Defined as FUNCTIONS (never
module-level constants), so importing this module touches no process
group or device. Each needs a default process group of the mesh's world
size already initialised (``torch.distributed.init_process_group``; the
dry run uses the fake backend, one process standing for every device).
"""

from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """Single pod: (data=16, model=16) = 256 devices.
    Multi-pod: (pod=2, data=16, model=16) = 512 devices."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    mesh = init_device_mesh(device_type, shape, mesh_dim_names=axes)
    if multi_pod:
        # the data-parallel axes also as one flattened axis: a reduction
        # over both (a data-parallel gradient) is then one all-reduce over
        # their 32 devices, as XLA emits it, not one an axis
        mesh["pod", "data"]._flatten("dp")
    return mesh


def make_host_mesh(device_type: str = "cuda") -> DeviceMesh:
    """Every process of the group on one 'data' axis: one process a card,
    so on one host the visible cards."""
    return init_device_mesh(device_type, (dist.get_world_size(),),
                            mesh_dim_names=("data",))
