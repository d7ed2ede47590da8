"""Device meshes for the data-parallel sharded step, PyTorch port.

The counterpart of the reference's ``launch/mesh.py``: ``torch.distributed``
device meshes with the reference's axis names, ``("data", "model")`` on a
host or a pod and ``("pod", "data", "model")`` across pods. Each rank
of the process group is one device. The frame axes' groups carry the
step's collectives (the all-gather of the atmospheric-light candidates);
:func:`batch_axes_for` picks the frame axes for a batch.

Nothing here runs at import time.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.core.pipeline import DeviceLike, resolve_device

AXES = ("data", "model")


def _init_group(device: DeviceLike) -> torch.device:
    """The device of this rank; with no process group yet, a one-rank
    group on it (see :func:`make_host_mesh`)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev if dev.index is not None
                              else torch.cuda.current_device())
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    return dev


def _check_size(shape: Tuple[int, ...]) -> None:
    """Raise unless the default group (one rank if none yet) holds a
    ``shape`` mesh."""
    n = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have != n:
        raise ValueError(f"a {shape} mesh needs {n} ranks; the process group "
                         f"has {have}")


def _mesh(device: DeviceLike, shape: Tuple[int, ...],
          axes: Tuple[str, ...]) -> DeviceMesh:
    _check_size(shape)
    dev = _init_group(device)
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


def make_host_mesh(data: int = 1, model: int = 1,
                   device: DeviceLike = None) -> DeviceMesh:
    """A (data, model) mesh over the ranks of the default process group.

    With no process group yet, creates a one-rank group on ``device``
    (``None`` = CUDA, raising without a card): NCCL on CUDA, gloo on the
    CPU, rendezvous through an in-memory store, so no network is needed. A
    group of more ranks is the caller's to create (one process a device).
    The caller ends the group with ``torch.distributed.destroy_process_group()``.
    """
    return _mesh(device, (data, model), AXES)


def production_mesh_spec(multi_pod: bool = False
                         ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """The production mesh's shape and axis names: one pod is (16, 16)
    ``("data", "model")`` = 256 devices; two pods are (2, 16, 16)
    ``("pod", "data", "model")`` = 512, the pod axis an outer data axis
    (frames shard over pod x data)."""
    if multi_pod:
        return (2, 16, 16), ("pod",) + AXES
    return (16, 16), AXES


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = None) -> DeviceMesh:
    """The production mesh (:func:`production_mesh_spec`) over the ranks of
    the default process group, which must have 256 (512 with
    ``multi_pod``) ranks: a group of another size, or none (one rank),
    raises ``ValueError`` before any group is made."""
    return _mesh(device, *production_mesh_spec(multi_pod))


def batch_axes_for(mesh, batch: int) -> Optional[Tuple[str, ...]]:
    """The longest prefix of ``("pod", "data")`` (of the axes ``mesh``
    has) whose size product divides ``batch``: ``("pod", "data")``, then
    ``("pod",)`` or ``("data",)``; None where no prefix divides (the
    batch then stays replicated). Reads ``mesh.mesh_dim_names`` and
    ``mesh.size(i)``."""
    names = tuple(mesh.mesh_dim_names)
    axes = [a for a in ("pod", "data") if a in names]
    for end in range(len(axes), 0, -1):
        prefix = axes[:end]
        size = 1
        for a in prefix:
            size *= mesh.size(names.index(a))
        if batch % size == 0:
            return tuple(prefix)
    return None


__all__ = ["AXES", "make_host_mesh", "production_mesh_spec",
           "make_production_mesh", "batch_axes_for"]
