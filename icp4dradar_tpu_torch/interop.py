"""Carry state from the JAX package across as numpy.

The port never imports jax, so anything coming from `icp4dradar_tpu` (a
config, a scan, a stacked sequence, a voxel map) crosses as plain dicts of
numpy arrays:

    cfg = config_from_dict(jax_cfg.to_dict())
    scans = scans_from_numpy({k: np.asarray(getattr(jax_scans, k))
                              for k in SCAN_FIELDS})
    vmap = voxel_map_from_numpy({k: np.asarray(getattr(jax_map, k))
                                 for k in VOXEL_MAP_FIELDS},
                                voxel_size=jax_map.voxel_size,
                                max_probes=jax_map.max_probes)

A map or stack of scans with a leading stream axis (B, ...), as the JAX
package's `run_scan_to_map_batch` makes them, crosses the same way. A pose
graph crosses as a dict of its poses and of each factor container's
fields:

    graph = pose_graph_from_numpy(
        {"poses": np.asarray(jax_graph.poses),
         "rel": {f: np.asarray(getattr(jax_graph.rel, f))
                 for f in POSE_GRAPH_FACTOR_FIELDS["rel"]}, ...})

Tensors land on the card unless the caller names another device.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from icp4dradar_tpu_torch.config import PipelineConfig
from icp4dradar_tpu_torch.graph.gauss_newton import (
    LineFactors,
    Plane3Factors,
    PlaneFactors,
    PointFactors,
    PoseGraph,
    RelPoseFactors,
)
from icp4dradar_tpu_torch.io.scan import RadarScan
from icp4dradar_tpu_torch.mapping.voxel_hash import VoxelHashMap

SCAN_FIELDS = ("xyz", "doppler", "intensity", "mask", "time")
VOXEL_MAP_FIELDS = ("keys", "points", "intensity", "occupied", "stat_n",
                    "stat_sum", "stat_sq")
_FACTOR_TYPES = {"rel": RelPoseFactors, "points": PointFactors, "lines": LineFactors,
                 "planes": PlaneFactors, "planes3": Plane3Factors}
# the fields of each factor container of a PoseGraph, in both packages
POSE_GRAPH_FACTOR_FIELDS = {name: tuple(cls.__dataclass_fields__)
                            for name, cls in _FACTOR_TYPES.items()}


def config_from_dict(d: Mapping) -> PipelineConfig:
    """The port's PipelineConfig from `PipelineConfig.to_dict()` of either
    package."""
    return PipelineConfig.from_dict(dict(d))


def scan_from_numpy(arrays: Mapping[str, np.ndarray], device="cuda") -> RadarScan:
    """RadarScan from {xyz, doppler, intensity, mask, time} numpy arrays
    (float32), placed on `device`. Leading batch axes are kept, so a stacked
    (F, ...) sequence converts the same way."""
    missing = [k for k in SCAN_FIELDS if k not in arrays]
    if missing:
        raise KeyError(f"scan arrays lack fields {missing}")
    return RadarScan(**{
        k: torch.tensor(np.asarray(arrays[k], dtype=np.float32), device=device)
        for k in SCAN_FIELDS
    })


def scans_from_numpy(arrays: Mapping[str, np.ndarray], device="cuda") -> RadarScan:
    """Stacked (F, ...) RadarScan from stacked numpy arrays, or (B, F, ...)
    streams for `run_scan_to_map_batch`."""
    if np.ndim(arrays["xyz"]) not in (3, 4):
        raise ValueError(f"stacked xyz must be (F, N, 3) or (B, F, N, 3), got "
                         f"{np.shape(arrays['xyz'])}")
    return scan_from_numpy(arrays, device)


def voxel_map_from_numpy(arrays: Mapping[str, np.ndarray], voxel_size: float = 0.5,
                         max_probes: int = 8, device="cuda") -> VoxelHashMap:
    """VoxelHashMap from {keys (C,3) int32, points, intensity, occupied,
    stat_n, stat_sum, stat_sq (float32)} numpy arrays, placed on `device`.
    Arrays with a leading (B,) axis, the leaves of the JAX package's vmapped
    map, give a batched map of B tables."""
    missing = [k for k in VOXEL_MAP_FIELDS if k not in arrays]
    if missing:
        raise KeyError(f"voxel map arrays lack fields {missing}")
    return VoxelHashMap(
        **{k: torch.tensor(np.asarray(arrays[k],
                                      dtype=np.int32 if k == "keys" else np.float32),
                           device=device)
           for k in VOXEL_MAP_FIELDS},
        voxel_size=float(voxel_size), max_probes=int(max_probes))


def voxel_map_to_numpy(vmap: VoxelHashMap) -> dict:
    """{field: numpy array} of a VoxelHashMap (its tables, (B, C, ...) for a
    batched map), host copies."""
    return {k: getattr(vmap, k).detach().cpu().numpy() for k in VOXEL_MAP_FIELDS}


def pose_graph_from_numpy(arrays: Mapping, device="cuda") -> PoseGraph:
    """PoseGraph from {"poses": (K,4,4), and for each factor container
    present ("rel", "points", "lines", "planes", "planes3") a dict of its
    fields as numpy arrays}, placed on `device`; a container that is absent
    or None stays None. Indices become int64, everything else float32."""
    def container(name):
        d = arrays.get(name)
        if d is None:
            return None
        cls = _FACTOR_TYPES[name]
        missing = [f for f in cls.__dataclass_fields__ if f not in d]
        if missing:
            raise KeyError(f"{name} arrays lack fields {missing}")
        return cls(**{f: torch.tensor(np.asarray(d[f], dtype=np.int64 if f in ("i", "j", "k")
                                                 else np.float32), device=device)
                      for f in cls.__dataclass_fields__})

    return PoseGraph(poses=torch.tensor(np.asarray(arrays["poses"], np.float32),
                                        device=device),
                     **{name: container(name) for name in _FACTOR_TYPES})
