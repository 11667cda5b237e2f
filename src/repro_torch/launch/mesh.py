"""Host meshes: a torch ``DeviceMesh`` over the ranks of the process group.

Counterpart of ``repro.launch.mesh``'s ``make_host_mesh``.  One rank is
one device.  The production mesh and the roofline's hardware table
(``make_production_mesh``, ``HW``) belong with the dry run, ROADMAP A14.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..device import resolve_device

__all__ = ["make_host_mesh"]

_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


def _process_group(dev: torch.device) -> None:
    """Start a world of one on ``dev``'s backend (NCCL on the card, gloo
    on the CPU) when no process group exists; refuse a group whose backend
    cannot serve ``dev``."""
    want = _BACKEND[dev.type]
    if not dist.is_initialized():
        dist.init_process_group(want, store=dist.HashStore(), rank=0,
                                world_size=1)
    backend = str(dist.get_backend())
    if want not in backend:
        raise ValueError(f"the process group's backend is {backend!r}; a "
                         f"{dev.type} mesh needs {want!r}")


def make_host_mesh(data: int = 1, model: int = 1, device=None):
    """A (data, model) ``DeviceMesh`` over the process group's ranks,
    clamped to the world size as the reference clamps to its devices.

    device: None means the card (NCCL), raising without one; "cpu" takes
    gloo.  Without a process group, starts a world of one itself.
    """
    dev = resolve_device(device)
    _process_group(dev)
    n = dist.get_world_size()
    data = min(data, n)
    model = min(model, max(n // data, 1))
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh(dev.type, torch.arange(data * model).reshape(
        data, model), mesh_dim_names=("data", "model"))
