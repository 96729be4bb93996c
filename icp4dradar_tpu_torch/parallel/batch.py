"""Data-parallel scan processing over the ranks of a mesh (PyTorch port of
`icp4dradar_tpu/parallel/batch.py`): REVE preprocessing, pairwise ICP and
B-stream scan-to-map serving, one rank a contiguous 1/n of the frames or
streams, with no collective until the end.

torch has no global array, so a batch is whole on every rank: each rank
computes its own contiguous share and one all-gather at the end returns
the whole result to every rank (the fields packed as bytes, so it is one
collective whatever their types). The random draws of frame or stream f
are those of its global index f, the JAX package's split of the key over
all F (or B) (`utils.threefry`), so the result does not depend on the
number of ranks; a rank makes its draws in one call over its keys."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from icp4dradar_tpu_torch.config import PipelineConfig
from icp4dradar_tpu_torch.io.scan import RadarScan
from icp4dradar_tpu_torch.models.scan_to_map import (
    ScanToMapOutput,
    ScanToMapState,
    run_scan_to_map_batch,
)
from icp4dradar_tpu_torch.parallel.mesh import all_gather_rows as _all_gather_rows
from icp4dradar_tpu_torch.parallel.mesh import axis_rank, axis_size, mesh_device
from icp4dradar_tpu_torch.preprocess.reve import (
    EgoVelocityEstimate,
    estimate_ego_velocity,
    reve_hypotheses,
)
from icp4dradar_tpu_torch.registration.icp import icp_point_to_point
from icp4dradar_tpu_torch.utils import threefry


def _share(total: int, mesh: DeviceMesh, axis: str) -> slice:
    """This rank's contiguous 1/n of `total` rows."""
    n = axis_size(mesh, axis)
    if total % n:
        raise ValueError(f"batch {total} must divide the mesh size {n}")
    per = total // n
    r = axis_rank(mesh, axis)
    return slice(r * per, (r + 1) * per)


def _gather_dataclass(obj, mesh: DeviceMesh, axis: str):
    names = [f.name for f in dataclasses.fields(obj)]
    whole = _all_gather_rows([getattr(obj, k) for k in names], mesh, axis)
    return dataclasses.replace(obj, **dict(zip(names, whole)))


def shard_scan_batch(scans: RadarScan, mesh: DeviceMesh, axis: str = "dp") -> RadarScan:
    """A stacked (F, ...) batch placed for the mesh: on this rank's device,
    F a multiple of the mesh size (each rank then works on its contiguous
    1/n of the frames)."""
    _share(scans.xyz.shape[0], mesh, axis)
    return scans.to(mesh_device(mesh))


def batched_preprocess(
    scans: RadarScan,
    key: np.ndarray,
    mesh: DeviceMesh,
    cfg: PipelineConfig = PipelineConfig(),
    axis: str = "dp",
) -> EgoVelocityEstimate:
    """REVE ego velocity over a (F, ...) batch, each rank its 1/n of the
    frames: frame f draws from split(key, F)[f], as the JAX package's
    vmapped REVE does. `key`: key data (2,) uint32 (`utils.threefry.key`).
    Returns the (F, ...) estimate on every rank."""
    F = scans.xyz.shape[0]
    sl = _share(F, mesh, axis)
    H = reve_hypotheses(cfg.reve)
    u = torch.from_numpy(threefry.uniform(threefry.split(key, F)[sl], 3 * H))
    est = estimate_ego_velocity(scans[sl], u.to(scans.xyz.device), cfg.reve)
    return _gather_dataclass(est, mesh, axis)


def batched_icp_pairs(
    src_scans: RadarScan,
    tgt_scans: RadarScan,
    mesh: DeviceMesh,
    cfg: PipelineConfig = PipelineConfig(),
    axis: str = "dp",
) -> torch.Tensor:
    """Register F independent scan pairs across the mesh, each rank its 1/n
    in one batched ICP (the ICP-moments kernel on the card); returns the
    (F,4,4) transforms on every rank."""
    sl = _share(src_scans.xyz.shape[0], mesh, axis)
    src, tgt = src_scans[sl], tgt_scans[sl]
    T = icp_point_to_point(src.xyz, tgt.xyz, src.mask, tgt.mask, cfg=cfg.icp).transform
    return _all_gather_rows([T], mesh, axis)[0]


def sharded_scan_to_map_batch(
    scans: RadarScan,
    mesh: DeviceMesh,
    cfg: PipelineConfig = PipelineConfig(),
    key: Optional[np.ndarray] = None,
    axis: str = "dp",
    block: int = 0,
    **kwargs,
):
    """Track B independent radar streams with B/n streams a rank: each rank
    runs `run_scan_to_map_batch` over its streams (VGICP on the sweep
    kernel, or kNN GICP on the 1-NN kernel, as the config names), each
    stream with a private map, and no collective runs until the results
    are gathered.

    `scans`: stacked (B, F, ...) with B divisible by the mesh size. Stream
    b draws as the JAX package's single-stream runner with the key
    split(key, B)[b] (key data (2,) uint32, by default key(cfg.seed)).
    With block > 1 the blocked runner's `sequential_fallback` defaults to
    True, as the JAX package's vmapped runner leaves it here. Returns the
    batched (state, outputs) of all B streams on every rank."""
    B, F = scans.xyz.shape[:2]
    sl = _share(B, mesh, axis)
    if key is None:
        key = threefry.key(cfg.seed)
    H = reve_hypotheses(cfg.reve)
    u = threefry.reve_uniforms(cfg.seed, F, block, H, threefry.split(key, B)[sl])
    if block > 1:
        kwargs.setdefault("sequential_fallback", True)
    state, out = run_scan_to_map_batch(scans[sl], cfg, uniforms=torch.from_numpy(u).to(
        scans.xyz.device), block=block, **kwargs)
    tables = list(state.vmap.tables())
    names = [f.name for f in dataclasses.fields(ScanToMapOutput)]
    whole = _all_gather_rows([state.world_T] + tables + [getattr(out, k) for k in names],
                             mesh, axis)
    state = ScanToMapState(world_T=whole[0],
                           vmap=state.vmap.with_tables(whole[1:1 + len(tables)]))
    return state, ScanToMapOutput(**dict(zip(names, whole[1 + len(tables):])))
