"""Device meshes over ``torch.distributed`` (port of ``repro.launch.mesh``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with the
reference's axis names. One process drives one device: the mesh's ranks
are processes, and its collectives run on NCCL for ``"cuda"`` and on gloo
for ``"cpu"``. A ``"cuda"`` mesh on a machine without a card raises; it
never falls back to gloo or to the CPU. Meshes are built by functions,
never at import, so that importing this module touches no process group.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.common.device import DeviceLike, resolve_device

# the collective backend of each device type
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def ensure_process_group(device: DeviceLike = "cuda") -> int:
    """The default process group's world size. Starts a group of world
    size 1 from an in-process ``HashStore`` when none exists (one process
    on its own device). An existing group must run ``device``'s backend
    (NCCL for CUDA, gloo for the CPU)."""
    dev = resolve_device(device)
    backend = BACKENDS[dev.type]
    if not dist.is_initialized():
        kw = {}
        if dev.type == "cuda":
            kw["device_id"] = torch.device("cuda",
                                           torch.cuda.current_device())
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, **kw)
    elif backend not in dist.get_backend():
        raise RuntimeError(
            f"a {dev.type} mesh needs the {backend} backend; the process "
            f"group runs {dist.get_backend()}")
    return dist.get_world_size()


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = "cuda") -> DeviceMesh:
    """16x16 over ("data", "model"), or 2x16x16 over ("pod", "data",
    "model") with ``multi_pod``: one rank per device, so the process
    group must already hold that many ranks."""
    dev = resolve_device(device)
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 1
    for s in shape:
        need *= s
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != need:
        raise ValueError(f"the {'x'.join(map(str, shape))} production mesh "
                         f"needs a process group of world size {need}; "
                         f"this one has {world}")
    ensure_process_group(dev)
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


def make_local_mesh(device: DeviceLike = "cuda") -> DeviceMesh:
    """A (1, world) mesh over ("data", "model") on every rank of the
    process group (one rank, started here, when there is none)."""
    dev = resolve_device(device)
    world = ensure_process_group(dev)
    return init_device_mesh(dev.type, (1, world),
                            mesh_dim_names=("data", "model"))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """Ranks along the mesh axis named ``axis``."""
    return mesh.shape[mesh.mesh_dim_names.index(axis)]


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device of ``mesh``: its current CUDA device, or the
    CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)
