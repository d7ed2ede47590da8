"""Device meshes for the data-parallel sharded step, PyTorch port.

The counterpart of the reference's ``launch/mesh.py::make_host_mesh``: a
``torch.distributed`` :class:`DeviceMesh` with the reference's axis names
``("data", "model")``. Each rank of the process group is one device. The
mesh's ``data`` group carries the step's collectives (the all-gather of the
atmospheric-light candidates).

Nothing here runs at import time.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.core.pipeline import DeviceLike, resolve_device

AXES = ("data", "model")


def make_host_mesh(data: int = 1, model: int = 1,
                   device: DeviceLike = None) -> DeviceMesh:
    """A (data, model) mesh over the ranks of the default process group.

    With no process group yet, creates a one-rank group on ``device``
    (``None`` = CUDA, raising without a card): NCCL on CUDA, gloo on the
    CPU, rendezvous through an in-memory store, so no network is needed. A
    group of more ranks is the caller's to create (one process a device).
    The caller ends the group with ``torch.distributed.destroy_process_group()``.
    """
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev if dev.index is not None
                              else torch.cuda.current_device())
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    n = data * model
    if dist.get_world_size() != n:
        raise ValueError(f"a ({data}, {model}) mesh needs {n} ranks; the "
                         f"process group has {dist.get_world_size()}")
    return init_device_mesh(dev.type, (data, model), mesh_dim_names=AXES)


__all__ = ["AXES", "make_host_mesh"]
