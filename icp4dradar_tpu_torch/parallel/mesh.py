"""Device meshes over a `torch.distributed` process group (PyTorch port of
`icp4dradar_tpu/parallel/mesh.py`).

JAX builds a mesh from the devices one process sees; here one rank drives
one device, so the mesh is a `DeviceMesh` over the ranks of the default
process group (NCCL on the card, gloo on the CPU), which the caller
initialises. The other `parallel` modules read an axis's size, this rank's
place on it and its process group through `axis_size`, `axis_rank` and
`axis_group`."""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def _require_group(name: str) -> None:
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(f"{name}: no torch.distributed process group is initialised; "
                           "call torch.distributed.init_process_group first")


def device_count() -> int:
    """Devices of the mesh: the ranks of the default process group."""
    _require_group("device_count")
    return dist.get_world_size()


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Sequence[str] = ("dp",),
    shape: Optional[Sequence[int]] = None,
    device_type: str = "cuda",
) -> DeviceMesh:
    """1-D (or reshaped) mesh over the n ranks of the process group, one
    device a rank (`device_type` "cuda", or "cpu" for gloo ranks).

    Single-axis "dp" shards scans and factors; a multi-axis mesh needs its
    `shape`, as in the JAX package. n_devices defaults to the world size
    and must equal it: a rank outside the mesh would have no part in the
    collectives."""
    _require_group("make_mesh")
    world = dist.get_world_size()
    if n_devices is None:
        n_devices = world
    if n_devices != world:
        raise ValueError(f"make_mesh: {n_devices} devices in a process group of {world} "
                         "ranks (one rank a device)")
    if shape is None:
        shape = (n_devices,) if len(axis_names) == 1 else None
    if shape is None:
        raise ValueError("shape required for multi-axis meshes")
    if len(shape) != len(axis_names) or math.prod(shape) != n_devices:
        raise ValueError(f"make_mesh: shape {tuple(shape)} for axes {tuple(axis_names)} "
                         f"over {n_devices} devices")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh: device_type 'cuda' without a CUDA device; pass "
                           "device_type='cpu' for gloo ranks")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axis_names))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_rank(mesh: DeviceMesh, axis: str) -> int:
    return mesh.get_local_rank(axis)


def axis_group(mesh: DeviceMesh, axis: str):
    return mesh.get_group(axis)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device on the mesh."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)
