"""Production mesh construction: the port of :mod:`repro.launch.mesh`, as
``torch.distributed`` device meshes over the process group that is up (one
rank a card; the caller starts the group with its address, world size and
rank).

Functions, not module constants: importing this module never touches
process groups or devices.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.kernels._build import resolve_device


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(resolve_device(device).type, shape, mesh_dim_names=axes)


def make_host_mesh(model_axis: int = 1, device="cuda"):
    """A ``(world // model_axis, model_axis)`` ``("data", "model")`` mesh over
    the ranks of the process group that is up.  With no group up it starts a
    one-rank group on ``device``'s backend (NCCL on ``cuda``, gloo on
    ``cpu``; no fallback from one to the other) over an in-process store."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev if dev.index is not None else torch.cuda.current_device())
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), world_size=1, rank=0)
    n = dist.get_world_size()
    data = max(n // model_axis, 1)
    return init_device_mesh(dev.type, (data, model_axis), mesh_dim_names=("data", "model"))
