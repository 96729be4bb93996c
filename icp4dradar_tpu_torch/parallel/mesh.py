"""Device meshes over a `torch.distributed` process group (PyTorch port of
`icp4dradar_tpu/parallel/mesh.py`).

JAX builds a mesh from the devices one process sees; here one rank drives
one device, so the mesh is a `DeviceMesh` over the ranks of the default
process group (NCCL on the card, gloo on the CPU), which the caller
initialises. The other `parallel` modules read an axis's size, this rank's
place on it and its process group through `axis_size`, `axis_rank` and
`axis_group`, and run their collectives through `all_gather_rows`,
`all_reduce_sum` and `all_reduce_max` (one collective a call, whatever the
number of tensors)."""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

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


def all_gather_rows(tensors: List[torch.Tensor], mesh: DeviceMesh,
                    axis: str) -> List[torch.Tensor]:
    """Every rank's rows of each tensor (same leading length L on every
    rank), concatenated in rank order: one all-gather of the rows packed
    as bytes."""
    n = axis_size(mesh, axis)
    L = tensors[0].shape[0]
    parts = [t.contiguous().reshape(L, -1).view(torch.uint8) for t in tensors]
    packed = torch.cat(parts, dim=1)
    got = [torch.empty_like(packed) for _ in range(n)]
    dist.all_gather(got, packed, group=axis_group(mesh, axis))
    rows = torch.cat(got)
    out, at = [], 0
    for t, p in zip(tensors, parts):
        w = p.shape[1]
        out.append(rows[:, at:at + w].contiguous().view(t.dtype)
                   .reshape((n * L,) + tuple(t.shape[1:])))
        at += w
    return out


def all_reduce_sum(tensors, mesh: DeviceMesh, axis: str):
    """The tensors summed over the ranks: one all-reduce of their values
    packed into one flat buffer."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=axis_group(mesh, axis))
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].reshape(t.shape))
        at += t.numel()
    return out


def all_reduce_max(x: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    x = x.clone()
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=axis_group(mesh, axis))
    return x
