"""End-to-end multi-device scan-to-map odometry: the tracked-frame loop of
`main_task` (src/radar_odometry.cpp:311-434) with the map sharded over the
ranks of a mesh the whole time (PyTorch port of
`icp4dradar_tpu/parallel/distributed_pipeline.py`).

Every rank receives the whole sequence and runs the same frame loop:

  1. REVE ego velocity and inliers, replicated (every rank computes every
     frame's estimate; a scan is ~80 KB). Frame f draws from
     split(key, F)[f], the JAX package's keys, made in one call.
  2. The pose prediction: the measured prior, or the Doppler step, once
     the map exists (its occupancy all-reduced).
  3. The sector submap: each rank compacts its own slots' sector voxels
     and Gaussians to `per` rows (`shard_local_sector_stats`); the submap
     is born sharded.
  4. Ring VGICP GN against the submap's shards (`ring_vgicp.RingTarget`:
     K4 with `return_best` once a ring step, K5 once a GN iteration, one
     all-reduce of the sums), in the frame centred on the prediction.
  5. The tracking gate (`models/scan_to_map.py::_apply_tracking_gate`).
  6. The sharded insert of the corrected points (`shard_local_insert`).
  7. With a finite forget radius: forget-far on the rank's slots, and the
     distributed rehash once the tombstones of all shards pass their
     fraction (`shard_local_maybe_rehash`).

`block > 1` amortises the map's fixed costs as the JAX package's blocked
variant does: per-frame warm-up frames, then per block ONE sector query
and ONE batched insert, the frames of a block registering in turn against
the submap frozen at the block start, with the const-velocity rotation
prior (a measured prior supersedes it).

Every output is the same on every rank; the map is returned sharded.
`save_distributed_state` / `load_distributed_state` checkpoint it in the
JAX package's npz layout, so a file either package writes loads in the
other, on a mesh of another size too."""

from __future__ import annotations

import json
import math
from typing import Optional

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from icp4dradar_tpu_torch.config import PipelineConfig
from icp4dradar_tpu_torch.geom.linalg import small_matmul as mm
from icp4dradar_tpu_torch.geom.se3 import se3_apply, se3_inverse
from icp4dradar_tpu_torch.geom.so3 import matrix_to_rpy
from icp4dradar_tpu_torch.io.scan import RadarScan
from icp4dradar_tpu_torch.mapping.voxel_hash import voxel_map_create
from icp4dradar_tpu_torch.models.scan_to_map import (
    _add_doppler_step,
    _apply_tracking_gate,
    _estimate_frames,
    _with_rotation,
)
from icp4dradar_tpu_torch.ops.vgicp_fused import radar_point_covariances_packed
from icp4dradar_tpu_torch.parallel.mesh import (
    all_reduce_sum,
    axis_rank,
    axis_size,
    mesh_device,
)
from icp4dradar_tpu_torch.parallel.ring_vgicp import RingTarget, scan_slice_operands
from icp4dradar_tpu_torch.parallel.sharded_map import (
    ShardedVoxelMap,
    forget_far,
    shard_from_table,
    shard_local_insert,
    shard_local_maybe_rehash,
    shard_local_sector_stats,
    sharded_map_create,
)
from icp4dradar_tpu_torch.preprocess.reve import reve_hypotheses
from icp4dradar_tpu_torch.utils import threefry

OUTPUT_NAMES = ("world_T", "correction", "velocity", "velocity_valid", "fitness",
                "num_inliers", "submap_points", "iterations")


class _Tracker:
    """One rank's frame loop: the precomputed per-frame inputs, the sharded
    map and the registration against the ring."""

    def __init__(self, scans, mesh, axis, cfg, est, covs, priors):
        self.scans, self.mesh, self.axis, self.cfg = scans, mesh, axis, cfg
        self.est, self.covs, self.priors = est, covs, priors
        self.forget = math.isfinite(cfg.voxel_map.forget_radius)
        # each shard's sector rows: submap_max_points / n, times the slack
        # against hash imbalance rounded up to a multiple of 8
        self.per = cfg.voxel_map.submap_max_points // axis_size(mesh, axis)
        slack = float(cfg.voxel_map.shard_quota_slack)
        if slack != 1.0:
            self.per = -(-int(self.per * slack) // 8) * 8

    def submap(self, smap: ShardedVoxelMap, pose):
        """This rank's shard of the sector submap around `pose`, centred on
        its translation: (ring target, local count, centre)."""
        vm, g = self.cfg.voxel_map, self.cfg.gicp
        center = pose[:3, 3]
        heading = matrix_to_rpy(pose[:3, :3])[2]
        _, tmask, cnt, tm, tc = shard_local_sector_stats(
            smap, center, vm.sector_radius, heading, vm.sector_half_angle_deg, self.per)
        ring = RingTarget(torch.cat([tm - center, tc, tmask[:, None]], dim=-1), self.mesh,
                          self.axis, True, g.max_correspondence_dist, g.cov_epsilon)
        return ring, cnt, center

    def register(self, ring, center, pose, f):
        """Frame f's ring GN from `pose` -> (gated pose, insert mask, fitness,
        iterations)."""
        g = self.cfg.gicp
        T0 = pose.clone()
        T0[:3, 3] -= center
        inl = self.est.inlier_mask[f]
        ops = scan_slice_operands(self.scans.xyz[f], inl, self.covs[f], self.mesh, self.axis)
        T, fitness, iters = ring.align(T0, ops, g.lm_lambda, g.max_iterations,
                                       g.vgicp_transformation_epsilon)
        T = T.clone()
        T[:3, 3] += center
        new_T, insert_mask, _ = _apply_tracking_gate(self.cfg, pose, T, fitness, inl)
        return new_T, insert_mask, fitness, iters

    def insert(self, smap, xyz, mask, intensity, position):
        smap = shard_local_insert(smap, xyz, mask, intensity)
        if self.forget:
            vm = self.cfg.voxel_map
            smap = forget_far(smap, position, vm.forget_radius)
            smap = shard_local_maybe_rehash(smap, vm.rehash_tombstone_fraction)
        return smap

    def output(self, f, pose, new_T, fitness, cnt, iters):
        e = self.est
        return (new_T, mm(new_T, se3_inverse(pose)), e.velocity[f], e.valid[f], fitness,
                torch.sum(e.inlier_mask[f]), cnt, iters)

    def frame(self, smap, pose, f, use_doppler_prior):
        """One per-frame step: predict, query, register, gate, insert."""
        has_map = smap.num_voxels > 0.5
        if self.priors is not None:
            pose = torch.where(has_map, mm(pose, self.priors[f]), pose)
        if use_doppler_prior:
            pose = _add_doppler_step(pose, self.est.velocity[f], self.est.valid[f] & has_map)
        ring, cnt, center = self.submap(smap, pose)
        new_T, insert_mask, fitness, iters = self.register(ring, center, pose, f)
        smap = self.insert(smap, se3_apply(new_T, self.scans.xyz[f]), insert_mask,
                           self.scans.intensity[f], new_T[:3, 3])
        return smap, new_T, self.output(f, pose, new_T, fitness, cnt, iters)

    def block(self, smap, pose, prev_rot, frames, use_doppler_prior, use_cv_rot):
        """One block: one sector query at the block-start pose, the frames
        registered in turn against it, one batched insert."""
        ring, cnt, center = self.submap(smap, pose)
        outs, pts, masks = [], [], []
        for f in frames:
            pose_in = pose
            if self.priors is not None:
                pose = mm(pose, self.priors[f])
            elif use_cv_rot:
                pose = mm(pose, prev_rot)
            if use_doppler_prior:
                pose = _add_doppler_step(pose, self.est.velocity[f], self.est.valid[f])
            new_T, insert_mask, fitness, iters = self.register(ring, center, pose, f)
            prev_rot = _with_rotation(mm(se3_inverse(pose_in), new_T)[:3, :3])
            outs.append(self.output(f, pose, new_T, fitness, cnt, iters))
            pts.append(se3_apply(new_T, self.scans.xyz[f]))
            masks.append(insert_mask)
            pose = new_T
        smap = self.insert(smap, torch.cat(pts), torch.cat(masks),
                           self.scans.intensity[frames[0]:frames[-1] + 1].reshape(-1),
                           pose[:3, 3])
        return smap, pose, prev_rot, outs


def run_scan_to_map_distributed(
    scans: RadarScan,
    mesh: DeviceMesh,
    cfg: PipelineConfig = PipelineConfig(),
    key: Optional[np.ndarray] = None,
    axis: str = "dp",
    use_doppler_prior: bool = True,
    block: int = 0,
    use_const_velocity_rot: bool = False,
    init_map: Optional[ShardedVoxelMap] = None,
    init_pose: Optional[torch.Tensor] = None,
    priors: Optional[torch.Tensor] = None,
    uniforms: Optional[torch.Tensor] = None,
):
    """Track a stacked (F, ...) sequence, given whole to every rank, with
    the map sharded over the mesh axis. Returns (the final
    `ShardedVoxelMap`, a dict of the per-frame world_T / correction /
    velocity / velocity_valid / fitness / num_inliers / submap_points /
    iterations, the same on every rank).

    `key`: key data (2,) uint32 (`utils.threefry.key`), by default
    key(cfg.seed); frame f draws its REVE uniforms from split(key, F)[f].
    `uniforms` (F, 3H): the draws themselves, in place of the key's (a run
    resumed from a checkpoint continues the draws of the run it resumes).
    `init_map` / `init_pose`: resume from checkpointed state
    (`load_distributed_state`). `block > 1`: one sector query and one
    batched insert per `block` frames, needing (F - block) % block == 0;
    `use_const_velocity_rot` (blocked only) predicts each frame's heading
    change from the previous refined body delta. `priors` (F, 4, 4):
    body-frame motion priors (e.g. `preprocess.imu_prior_deltas`), composed
    into the prediction once the map exists; in blocked mode they supersede
    the const-velocity rotation.

    Requires `gicp.use_vgicp` (the registration is the ring VGICP), the
    capacity and the submap budget divisible by the mesh size, and the scan
    point budget too (the ring shards the scan). Each shard compacts its
    sector voxels to submap_max_points / n rows: when the sector's
    occupancy nears the budget a hot shard can truncate while others have
    slack, so size the submap with headroom (or `shard_quota_slack`)."""
    n = axis_size(mesh, axis)
    vmcfg = cfg.voxel_map
    if not cfg.gicp.use_vgicp:
        raise ValueError("distributed pipeline requires cfg.gicp.use_vgicp")
    if vmcfg.capacity % n or vmcfg.submap_max_points % n:
        raise ValueError(
            f"capacity {vmcfg.capacity} and submap_max_points {vmcfg.submap_max_points} "
            f"must be divisible by mesh size {n}")
    if scans.xyz.shape[1] % n:
        raise ValueError(
            f"scan point budget {scans.xyz.shape[1]} must be divisible by mesh size {n} "
            "(the ring sweep shards the scan)")
    F = scans.xyz.shape[0]
    if block > 1 and (F - block) % block != 0:
        raise ValueError(f"blocked distributed run needs (F - block) % block == 0, got "
                         f"F={F}, block={block}")
    dev, dt = mesh_device(mesh), scans.xyz.dtype
    scans = scans.to(dev)
    if priors is not None:
        priors = torch.as_tensor(priors, dtype=dt).to(dev)
        if tuple(priors.shape) != (F, 4, 4):
            raise ValueError(f"priors must be (F, 4, 4) = ({F}, 4, 4), got "
                             f"{tuple(priors.shape)}")
    if init_map is not None:
        if init_map.capacity != vmcfg.capacity:
            raise ValueError(f"init_map capacity {init_map.capacity} != config capacity "
                             f"{vmcfg.capacity}")
        smap = init_map
    else:
        smap = sharded_map_create(mesh, capacity=vmcfg.capacity, voxel_size=vmcfg.voxel_size,
                                  max_probes=vmcfg.max_probes, axis=axis, dtype=dt)
    pose = (torch.eye(4, dtype=dt, device=dev) if init_pose is None
            else torch.as_tensor(init_pose, dtype=dt).to(dev))
    if uniforms is None:
        k = threefry.key(cfg.seed) if key is None else np.asarray(key, np.uint32)
        uniforms = torch.from_numpy(threefry.uniform(threefry.split(k, F),
                                                     3 * reve_hypotheses(cfg.reve)))
    uniforms = uniforms.to(dev)

    est = _estimate_frames(scans, uniforms, cfg)
    g = cfg.gicp
    covs = radar_point_covariances_packed(scans.xyz, g.sigma_range, g.sigma_azimuth,
                                          g.sigma_elevation)
    trk = _Tracker(scans, mesh, axis, cfg, est, covs, priors)
    outs = []
    warm = F if block <= 1 else block
    for f in range(warm):
        smap, pose, out = trk.frame(smap, pose, f, use_doppler_prior)
        outs.append(out)
    if block > 1:
        # bootstrap the const-velocity rotation from the last warm-up delta
        prev_rot = _with_rotation(mm(se3_inverse(outs[-2][0]), outs[-1][0])[:3, :3])
        for b0 in range(warm, F, block):
            smap, pose, prev_rot, blk = trk.block(smap, pose, prev_rot,
                                                  list(range(b0, b0 + block)),
                                                  use_doppler_prior, use_const_velocity_rot)
            outs.extend(blk)
    stacked = [torch.stack(x) for x in zip(*outs)]
    # the shards' submap counts of every frame, summed in one all-reduce
    stacked[6] = all_reduce_sum([stacked[6]], mesh, axis)[0]
    return smap, dict(zip(OUTPUT_NAMES, stacked))


def save_distributed_state(path: str, smap: ShardedVoxelMap, pose: torch.Tensor,
                           frame: int = 0) -> None:
    """Checkpoint a distributed run: the map gathered (one all-gather), the
    pose and the frame index, in the JAX package's npz layout
    (`utils/checkpoint.py`) with its metadata; rank 0 of the axis writes the
    file, and every rank returns once it is written. The reference's only
    analog is its CSV record/replay fixture
    (src/iterative_closest_point.cpp:188-206)."""
    from icp4dradar_tpu_torch.utils.checkpoint import save_checkpoint

    vm = smap.gather()
    if axis_rank(smap.mesh, smap.axis) == 0:
        save_checkpoint(path, {"map": vm, "pose": torch.as_tensor(pose)},
                        metadata={"frame": int(frame), "capacity": int(smap.capacity),
                                  "voxel_size": float(smap.voxel_size),
                                  "max_probes": int(smap.max_probes)})
    # a host read of an all-reduce that rank 0 joins after writing
    float(all_reduce_sum([torch.zeros((), device=vm.points.device)], smap.mesh, smap.axis)[0])


def load_distributed_state(path: str, mesh: DeviceMesh, axis: str = "dp"):
    """Restore (`ShardedVoxelMap`, pose (4,4), frame index) from a
    `save_distributed_state` checkpoint of either package, each rank taking
    its slice of the saved table: the mesh may differ in size from the
    one that saved (the capacity must stay divisible)."""
    from icp4dradar_tpu_torch.utils.checkpoint import load_checkpoint

    with np.load(path if path.endswith(".npz") else path + ".npz") as f:
        meta = json.loads(bytes(f["__meta__"]).decode())
    if "capacity" not in meta:
        raise ValueError(f"checkpoint {path} has no 'capacity' metadata: not a "
                         "save_distributed_state checkpoint")
    template = voxel_map_create(capacity=int(meta["capacity"]),
                                voxel_size=meta.get("voxel_size", 0.5),
                                max_probes=int(meta.get("max_probes", 8)), device="cpu")
    state, meta = load_checkpoint(path, {"map": template, "pose": torch.eye(4)})
    vm = template.with_tables(torch.from_numpy(np.asarray(x)) for x in state["map"].tables())
    dev = mesh_device(mesh)
    return (shard_from_table(vm, mesh, axis), torch.from_numpy(np.asarray(state["pose"])).to(dev),
            int(meta.get("frame", 0)))

