"""Scan-to-map odometry (VGICP or kNN GICP) against the voxel-hash map, the
`radar_odometry` pipeline (PyTorch port of
`icp4dradar_tpu/models/scan_to_map.py`).

Reference main_task (src/radar_odometry.cpp:311-434): REVE ego velocity
extracts the inlier scan (:328-342); the first scan builds the map
(:344-350); each tracked frame sector-searches an 80 m +-60 deg submap
around the current position (:392-396), registers the scan against it
(:399-406), composes the correction (:411-412) and inserts the corrected
scan (:382-390). As in the JAX package, registration runs BEFORE insertion
and the pipeline's own pose tracks the map.

- `run_scan_to_map`: the per-frame tracker, a Python frame loop.
- `run_scan_to_map_blocked`: one sector query and one batched insert per
  `block` frames; the frames of a block register jointly against the frozen
  block submap in one frame-parallel GN (one fused sweep per iteration for
  the whole block), with a sequential re-track of blocks that look lost.

RANSAC draws for REVE are an input, (F, 3H) (`preprocess/reve.py`); when
absent they come from a `torch.Generator` seeded with `cfg.seed`.

Registration is VGICP against the voxel Gaussians by default, or, with
`gicp.use_vgicp=False`, the reference-faithful kNN GICP (FastGICP,
src/radar_odometry.cpp:399-411): world-frame points against the sector
submap's stored points, target covariances from submap-local k-NN or, with
`gicp.use_exact_map_knn`, from the exact whole-map k-NN, and the
correction composed on the left. As in the JAX package, the blocked runner
honours `use_vgicp` in its warm-up frames only: its blocks always run
VGICP (`ROADMAP.md` queue 3).

Not ported yet, each raising NotImplementedError that names its place in
`ROADMAP.md`: a finite `voxel_map.forget_radius` (forget + rehash),
`gt_poses` / `insert_before_registration` and `run_scan_to_map_batch`
(queue 1 item 16); `rigid_union`, `accumulate_scans > 1` and its
`aux_world_xyz` / `insert_override` are left out for good ("Not ported").
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from icp4dradar_tpu_torch.config import PipelineConfig
from icp4dradar_tpu_torch.geom.se3 import se3_apply, se3_inverse
from icp4dradar_tpu_torch.geom.so3 import matrix_to_rpy, so3_project
from icp4dradar_tpu_torch.io.scan import RadarScan
from icp4dradar_tpu_torch.mapping import (
    VoxelHashMap,
    voxel_map_create,
    voxel_map_insert,
    voxel_map_knn_exact,
    voxel_map_sector_search,
    voxel_map_sector_search_with_stats,
)
from icp4dradar_tpu_torch.ops.vgicp_fused import radar_point_covariances_packed
from icp4dradar_tpu_torch.preprocess.reve import (
    EgoVelocityEstimate,
    draw_reve_uniforms,
    estimate_ego_velocity,
)
from icp4dradar_tpu_torch.registration.gicp import covariances_from_neighbors, gicp_align
from icp4dradar_tpu_torch.registration.vgicp import vgicp_align, vgicp_align_block

# Blocks of `run_scan_to_map_blocked` in this process that fell back to the
# sequential re-track (a lost or unhealthy joint registration).
SEQUENTIAL_FALLBACK_BLOCKS = 0

# Frames per REVE chunk in the blocked runner's precompute: the (frames, N,
# H) residual tile is 310 MB for 248 frames at N = 2048, H = 152.
REVE_FRAME_CHUNK = 64


def _not_ported(what: str, where: str = "queue 1 item 16") -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to icp4dradar_tpu_torch "
                               f"(ROADMAP.md {where})")


def _check_cfg(cfg: PipelineConfig) -> None:
    if math.isfinite(cfg.voxel_map.forget_radius):
        raise _not_ported("a finite voxel_map.forget_radius (forget + rehash)")
    if int(cfg.accumulate_scans) > 1:
        raise _not_ported("accumulate_scans > 1", "'Not ported'")


def _tracking_gate_enabled(cfg: PipelineConfig) -> bool:
    t = cfg.tracking
    return (math.isfinite(t.max_fitness) or math.isfinite(t.max_correction_t)
            or math.isfinite(t.max_correction_rot_deg))


def _apply_tracking_gate(cfg: PipelineConfig, pose, new_T, fitness, insert_mask):
    """Reject implausible corrections: keep the predicted pose and zero the
    insert mask (a bad registration must not poison the map). Batched over
    leading axes; identity when all gates are inf."""
    if not _tracking_gate_enabled(cfg):
        return new_T, insert_mask, torch.ones(fitness.shape, dtype=torch.bool,
                                              device=fitness.device)
    t = cfg.tracking
    corr_t = torch.linalg.vector_norm(new_T[..., :3, 3] - pose[..., :3, 3], dim=-1)
    # rotation-correction angle from the relative rotation's trace (a
    # rotation-first walk-off can keep translation and fitness plausible)
    dR = pose[..., :3, :3].transpose(-1, -2) @ new_T[..., :3, :3]
    trace = dR[..., 0, 0] + dR[..., 1, 1] + dR[..., 2, 2]
    corr_r = torch.rad2deg(torch.arccos(torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)))
    accept = ((fitness < t.max_fitness) & (corr_t < t.max_correction_t)
              & (corr_r < t.max_correction_rot_deg))
    new_T = torch.where(accept[..., None, None], new_T, pose)
    insert_mask = insert_mask * accept[..., None].to(insert_mask.dtype)
    return new_T, insert_mask, accept


@dataclass(frozen=True)
class ScanToMapState:
    world_T: torch.Tensor       # (4,4) current odometry (ref currOdom)
    vmap: VoxelHashMap


@dataclass(frozen=True)
class ScanToMapOutput:
    """Per-frame record; stacked (F, ...) from the runners."""

    world_T: torch.Tensor         # (4,4) pose after this frame
    correction: torch.Tensor      # (4,4) correction transform
    velocity: torch.Tensor        # (3,) REVE ego velocity
    velocity_sigma: torch.Tensor  # (3,)
    velocity_valid: torch.Tensor  # () bool
    fitness: torch.Tensor         # () registration fitness
    num_inliers: torch.Tensor     # () inlier point count
    submap_points: torch.Tensor   # () sector submap size
    iterations: torch.Tensor      # () GN iterations the registration ran
    insert_mask: torch.Tensor     # (N,) gated inlier mask actually inserted


def _stack_outputs(outs) -> ScanToMapOutput:
    return ScanToMapOutput(**{f.name: torch.stack([getattr(o, f.name) for o in outs])
                              for f in dataclasses.fields(ScanToMapOutput)})


def _cat_outputs(parts) -> ScanToMapOutput:
    return ScanToMapOutput(**{f.name: torch.cat([getattr(o, f.name) for o in parts])
                              for f in dataclasses.fields(ScanToMapOutput)})


@contextlib.contextmanager
def _phase(times: Optional[Dict[str, float]], name: str, device):
    """Host-clock time of a phase, added to times[name]; synchronizes the
    device before and after, and does nothing when `times` is None."""
    if times is None:
        yield
        return
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    yield
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    times[name] = times.get(name, 0.0) + time.perf_counter() - t0


def scan_to_map_init(cfg: PipelineConfig = PipelineConfig(), dtype=torch.float32,
                     device="cuda") -> ScanToMapState:
    vm = voxel_map_create(capacity=cfg.voxel_map.capacity,
                          voxel_size=cfg.voxel_map.voxel_size,
                          max_probes=cfg.voxel_map.max_probes,
                          dtype=dtype, device=device)
    return ScanToMapState(world_T=torch.eye(4, dtype=dtype, device=device), vmap=vm)


def _with_rotation(R: torch.Tensor) -> torch.Tensor:
    """(...,3,3) -> (...,4,4) pure rotation, projected onto SO(3)."""
    out = torch.eye(4, dtype=R.dtype, device=R.device).expand(R.shape[:-2] + (4, 4)).clone()
    out[..., :3, :3] = so3_project(R)
    return out


def _add_doppler_step(pose, velocity, valid):
    """Advance the pose by one frame of body-frame ego velocity where
    `valid`."""
    out = pose.clone()
    step = pose[..., :3, :3] @ velocity[..., None]
    out[..., :3, 3] += torch.where(valid[..., None], step[..., 0], 0.0)
    return out


def scan_to_map_step(
    state: ScanToMapState,
    scan: RadarScan,
    uniforms: torch.Tensor,
    cfg: PipelineConfig = PipelineConfig(),
    gt_pose: Optional[torch.Tensor] = None,
    insert_before_registration: bool = False,
    use_doppler_prior: bool = False,
    prior_delta: Optional[torch.Tensor] = None,
    aux_world_xyz: Optional[torch.Tensor] = None,
    aux_mask: Optional[torch.Tensor] = None,
    insert_override=None,
    phase_times: Optional[Dict[str, float]] = None,
) -> Tuple[ScanToMapState, ScanToMapOutput]:
    """One tracked frame: VGICP, or kNN GICP with `gicp.use_vgicp=False`.
    An empty map (first frame) gives an identity correction and seeds the
    map. uniforms: (3H,) REVE draws. `prior_delta` (4,4): body-frame motion
    prior composed into the prediction once the map exists."""
    _check_cfg(cfg)
    if gt_pose is not None or insert_before_registration:
        raise _not_ported("gt_pose / insert_before_registration")
    if aux_world_xyz is not None or aux_mask is not None or insert_override is not None:
        raise _not_ported("aux_world_xyz / insert_override (scan accumulation)",
                          "'Not ported'")
    vmcfg = cfg.voxel_map
    dev = scan.device
    with _phase(phase_times, "reve", dev):
        est = estimate_ego_velocity(scan, uniforms, cfg.reve)
    inlier_mask = est.inlier_mask

    pose = state.world_T
    has_map = state.vmap.num_voxels > 0
    if prior_delta is not None:
        pose = torch.where(has_map, pose @ prior_delta, pose)
    if use_doppler_prior:
        # the first scan seeds the map at the initial pose
        pose = _add_doppler_step(pose, est.velocity, est.valid & has_map)

    heading = matrix_to_rpy(pose[:3, :3])[2]
    if cfg.gicp.use_vgicp:
        with _phase(phase_times, "sector_query", dev):
            _, submask, sub_n, sub_mean, sub_cov = voxel_map_sector_search_with_stats(
                state.vmap, pose[:3, 3], vmcfg.sector_radius, heading,
                vmcfg.sector_half_angle_deg, vmcfg.submap_max_points,
                min_count=vmcfg.stats_min_count, fallback_var=vmcfg.stats_fallback_var)
        with _phase(phase_times, "gn", dev):
            src_cov6 = radar_point_covariances_packed(
                scan.xyz, cfg.gicp.sigma_range, cfg.gicp.sigma_azimuth,
                cfg.gicp.sigma_elevation)
            g = vgicp_align(scan.xyz, sub_mean, sub_cov, inlier_mask, submask,
                            src_cov6=src_cov6, init_transform=pose, cfg=cfg.gicp,
                            tgt_count=sub_n)
        reg_T = g.transform
    else:
        with _phase(phase_times, "sector_query", dev):
            submap, submask, sub_n = voxel_map_sector_search(
                state.vmap, pose[:3, 3], vmcfg.sector_radius, heading,
                vmcfg.sector_half_angle_deg, vmcfg.submap_max_points)
        tgt_cov = None
        if cfg.gicp.use_exact_map_knn:
            # the submap's covariance neighbourhoods from the exact
            # whole-map k-NN, gated at max_correspondence_dist
            with _phase(phase_times, "map_knn", dev):
                d2n, pn = voxel_map_knn_exact(state.vmap, submap,
                                              cfg.gicp.k_correspondences,
                                              max_dist=cfg.gicp.max_correspondence_dist)
                tgt_cov = covariances_from_neighbors(submap, pn, torch.isfinite(d2n),
                                                     cfg.gicp.cov_epsilon)
        with _phase(phase_times, "gn", dev):
            g = gicp_align(se3_apply(pose, scan.xyz), submap, inlier_mask, submask,
                           cfg=cfg.gicp, tgt_cov=tgt_cov)
        reg_T = g.transform @ pose                  # left-compose (ref :412)
    new_T, insert_mask, _ = _apply_tracking_gate(cfg, pose, reg_T, g.fitness,
                                                 inlier_mask)
    with _phase(phase_times, "insert", dev):
        vmap = voxel_map_insert(state.vmap, se3_apply(new_T, scan.xyz), insert_mask,
                                scan.intensity)
    out = ScanToMapOutput(
        world_T=new_T, correction=new_T @ se3_inverse(pose), velocity=est.velocity,
        velocity_sigma=est.sigma, velocity_valid=est.valid, fitness=g.fitness,
        num_inliers=torch.sum(inlier_mask), submap_points=sub_n,
        iterations=g.iterations, insert_mask=insert_mask,
    )
    return ScanToMapState(world_T=new_T, vmap=vmap), out


def _uniforms_for(scans: RadarScan, cfg: PipelineConfig, uniforms, generator):
    if uniforms is not None:
        return uniforms
    dev = scans.device
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(cfg.seed)
    return draw_reve_uniforms((scans.xyz.shape[0],), cfg.reve, generator, dev)


def run_scan_to_map(
    scans: RadarScan,
    cfg: PipelineConfig = PipelineConfig(),
    uniforms: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    gt_poses: Optional[torch.Tensor] = None,
    insert_before_registration: bool = False,
    use_doppler_prior: bool = True,
    prior_deltas: Optional[torch.Tensor] = None,
    use_const_velocity_rot: bool = False,
    init_state: Optional[ScanToMapState] = None,
    phase_times: Optional[Dict[str, float]] = None,
) -> Tuple[ScanToMapState, ScanToMapOutput]:
    """Track a stacked (F, ...) sequence frame by frame. Returns (final
    state incl. the built map, stacked per-frame outputs). uniforms: (F, 3H)
    REVE draws. `prior_deltas` (F,4,4): per-frame body motion priors.
    `use_const_velocity_rot`: predict each frame's heading change from the
    previous frame's refined body delta. `init_state`: continue from an
    existing {pose, map}."""
    _check_cfg(cfg)
    if gt_poses is not None or insert_before_registration:
        raise _not_ported("gt_poses / insert_before_registration")
    F = scans.xyz.shape[0]
    dt, dev = scans.xyz.dtype, scans.device
    uniforms = _uniforms_for(scans, cfg, uniforms, generator)
    state = init_state if init_state is not None else scan_to_map_init(cfg, dt, dev)
    prev_rot = torch.eye(4, dtype=dt, device=dev)
    outs = []
    for f in range(F):
        pd = prior_deltas[f] if prior_deltas is not None else (
            prev_rot if use_const_velocity_rot else None)
        new_state, out = scan_to_map_step(
            state, scans[f], uniforms[f], cfg, use_doppler_prior=use_doppler_prior,
            prior_delta=pd, phase_times=phase_times)
        delta = se3_inverse(state.world_T) @ new_state.world_T
        prev_rot = _with_rotation(delta[:3, :3])
        state = new_state
        outs.append(out)
    return state, _stack_outputs(outs)


def _sort_scans_by_sensor_x(scans: RadarScan) -> RadarScan:
    """Reorder every scan's points by sensor-frame x, invalid rows last
    (stable). Point order inside a scan is contractually meaningless, but
    sorted order makes each source block of the fused sweep a narrow band
    along the forward axis, the precondition of the Pallas kernel's band
    gating; the port keeps the order so that every stage sees the same
    rows as the JAX package."""
    key = torch.where(scans.mask > 0.5, scans.xyz[..., 0], math.inf)
    idx = torch.sort(key, dim=-1, stable=True).indices
    return scans.replace(
        xyz=torch.gather(scans.xyz, -2, idx[..., None].expand(scans.xyz.shape)),
        doppler=torch.gather(scans.doppler, -1, idx),
        intensity=torch.gather(scans.intensity, -1, idx),
        mask=torch.gather(scans.mask, -1, idx))


def _sort_submap_by_axis(sub_mean, sub_cov, submask, axis2):
    """Sort compacted submap rows by their projection onto `axis2` (2,)
    (stable); invalid rows keep +inf keys so the front-packed live count
    stays valid."""
    u = torch.where(submask > 0.5, sub_mean[:, 0] * axis2[0] + sub_mean[:, 1] * axis2[1],
                    math.inf)
    idx = torch.sort(u, stable=True).indices
    return sub_mean[idx], sub_cov[idx], submask[idx]


def _estimate_frames(scans: RadarScan, uniforms, cfg: PipelineConfig):
    """REVE over stacked frames in chunks of REVE_FRAME_CHUNK."""
    parts = [estimate_ego_velocity(scans[s:s + REVE_FRAME_CHUNK],
                                   uniforms[s:s + REVE_FRAME_CHUNK], cfg.reve)
             for s in range(0, scans.xyz.shape[0], REVE_FRAME_CHUNK)]
    return EgoVelocityEstimate(**{f.name: torch.cat([getattr(p, f.name) for p in parts])
                                  for f in dataclasses.fields(EgoVelocityEstimate)})


def run_scan_to_map_blocked(
    scans: RadarScan,
    cfg: PipelineConfig = PipelineConfig(),
    uniforms: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    block: int = 4,
    use_doppler_prior: bool = True,
    prior_deltas: Optional[torch.Tensor] = None,
    use_const_velocity_rot: bool = False,
    use_band_gating: bool = True,
    parallel_frames: bool = True,
    init_state: Optional[ScanToMapState] = None,
    rigid_union: bool = False,
    sequential_fallback: bool = True,
    phase_times: Optional[Dict[str, float]] = None,
) -> Tuple[ScanToMapState, ScanToMapOutput]:
    """Scan-to-map tracking with map updates amortized over `block` frames:
    ONE sector query and ONE batched insert per block; frames inside a
    block register against the submap frozen at the block start.

    The first `block` frames run the per-frame tracker to build the map
    (warm-up); they honour `gicp.use_vgicp`, while the blocks always run
    VGICP (the JAX package's behaviour) and ignore `gicp.inner_gn_steps`.
    `parallel_frames` (default): predict every pose of the block
    by chaining the motion priors from the block-start pose and register
    all frames in one joint GN (`vgicp_align_block`); False registers them
    one after another, each seeding the next prediction. With
    `sequential_fallback` a block whose joint registration looks lost
    (effective fitness >= `tracking.max_fitness`, including a matched
    weight below a quarter of the inliers) is re-tracked sequentially: one
    host-side branch per block. Frames whose REVE estimate is invalid
    dead-reckon on the last valid velocity (velocity hold).

    uniforms: (F, 3H) REVE draws (warm-up frames first). `phase_times`:
    when a dict, host-clock seconds per phase (reve, sort, sector_query,
    map_knn, gn, insert) are added to it, with a device synchronize around each
    phase. Requires (F - block) % block == 0 (F % block == 0 with
    `init_state`)."""
    global SEQUENTIAL_FALLBACK_BLOCKS
    _check_cfg(cfg)
    if rigid_union:
        raise _not_ported("rigid_union", "'Not ported'")
    F = scans.xyz.shape[0]
    dt, dev = scans.xyz.dtype, scans.device
    uniforms = _uniforms_for(scans, cfg, uniforms, generator)
    if block <= 1 or (init_state is None and F <= block):
        return run_scan_to_map(scans, cfg, uniforms=uniforms,
                               use_doppler_prior=use_doppler_prior,
                               prior_deltas=prior_deltas,
                               use_const_velocity_rot=use_const_velocity_rot,
                               init_state=init_state, phase_times=phase_times)
    if init_state is not None:
        if F % block != 0:
            raise ValueError(f"run_scan_to_map_blocked with init_state needs "
                             f"F % block == 0, got F={F}, block={block}")
        F0 = 0
    elif (F - block) % block != 0:
        raise ValueError(f"run_scan_to_map_blocked needs (F - block) % block == 0, "
                         f"got F={F}, block={block}")
    else:
        F0 = block                      # warm-up frames (per-frame updates)
    vmcfg = cfg.voxel_map
    nblocks = (F - F0) // block
    if use_band_gating:
        with _phase(phase_times, "sort", dev):
            scans = _sort_scans_by_sensor_x(scans)

    if F0 > 0:
        state, warm_outs = run_scan_to_map(
            scans[:F0], cfg, uniforms=uniforms[:F0], use_doppler_prior=use_doppler_prior,
            prior_deltas=None if prior_deltas is None else prior_deltas[:F0],
            use_const_velocity_rot=use_const_velocity_rot, phase_times=phase_times)
        warm_delta = se3_inverse(warm_outs.world_T[-2]) @ warm_outs.world_T[-1]
        prev_rot = _with_rotation(warm_delta[:3, :3])
    else:
        state, warm_outs = init_state, None
        prev_rot = torch.eye(4, dtype=dt, device=dev)

    # Frame-parallel precompute: REVE and the measurement-model scan
    # covariances depend only on the raw scan, never on the pose chain.
    rest = scans[F0:]
    with _phase(phase_times, "reve", dev):
        est_all = _estimate_frames(rest, uniforms[F0:], cfg)
    with _phase(phase_times, "gn", dev):
        cov_all = radar_point_covariances_packed(
            rest.xyz, cfg.gicp.sigma_range, cfg.gicp.sigma_azimuth,
            cfg.gicp.sigma_elevation)

    def frame_step(pose, prev_rot, frozen, k):
        """Register frame k of the rest against the frozen block submap."""
        sub_mean, sub_cov, submask, sub_n, axis2 = frozen
        pose_in = pose
        if prior_deltas is not None:
            pose = pose @ prior_deltas[F0 + k]
        elif use_const_velocity_rot:
            pose = pose @ prev_rot
        if use_doppler_prior:
            pose = _add_doppler_step(pose, held_vel[k], held_valid[k])
        inl = est_all.inlier_mask[k]
        g = vgicp_align(rest.xyz[k], sub_mean, sub_cov, inl, submask,
                        src_cov6=cov_all[k], init_transform=pose, cfg=cfg.gicp,
                        tgt_count=sub_n, gate_axis=axis2)
        new_T, insert_mask, _ = _apply_tracking_gate(cfg, pose, g.transform,
                                                     g.fitness, inl)
        delta = se3_inverse(pose_in) @ new_T
        out = ScanToMapOutput(
            world_T=new_T, correction=new_T @ se3_inverse(pose),
            velocity=held_vel[k], velocity_sigma=est_all.sigma[k],
            velocity_valid=held_valid[k], fitness=g.fitness,
            num_inliers=torch.sum(inl), submap_points=sub_n,
            iterations=g.iterations, insert_mask=insert_mask)
        return new_T, _with_rotation(delta[:3, :3]), out

    def sequential(pose, prev_rot, frozen, ks):
        outs = []
        for k in ks:
            pose, prev_rot, out = frame_step(pose, prev_rot, frozen, k)
            outs.append(out)
        return pose, prev_rot, _stack_outputs(outs)

    # velocity hold over the whole sequence (a running "last valid"):
    # frames with an invalid REVE estimate dead-reckon on the last valid
    # ego velocity instead of freezing
    hv = torch.zeros(3, dtype=dt, device=dev)
    hb = torch.zeros((), dtype=torch.bool, device=dev)
    vels, valids = [], []
    for k in range(F - F0):
        hv = torch.where(est_all.valid[k], est_all.velocity[k], hv)
        hb = hb | est_all.valid[k]
        vels.append(hv)
        valids.append(hb)
    held_vel, held_valid = torch.stack(vels), torch.stack(valids)

    block_outs = []
    for blk in range(nblocks):
        ks = list(range(blk * block, (blk + 1) * block))
        k0, k1 = ks[0], ks[-1] + 1
        pose0 = state.world_T
        heading = matrix_to_rpy(pose0[:3, :3])[2]
        with _phase(phase_times, "sector_query", dev):
            _, submask, sub_n, sub_mean, sub_cov = voxel_map_sector_search_with_stats(
                state.vmap, pose0[:3, 3], vmcfg.sector_radius, heading,
                vmcfg.sector_half_angle_deg, vmcfg.submap_max_points,
                min_count=vmcfg.stats_min_count, fallback_var=vmcfg.stats_fallback_var)
        axis2 = None
        if use_band_gating:
            # sort the frozen submap by the block-start forward axis
            with _phase(phase_times, "sort", dev):
                hrad = heading * (math.pi / 180.0)
                axis2 = torch.stack([torch.cos(hrad), torch.sin(hrad)])
                sub_mean, sub_cov, submask = _sort_submap_by_axis(
                    sub_mean, sub_cov, submask, axis2)
        frozen = (sub_mean, sub_cov, submask, sub_n, axis2)
        with _phase(phase_times, "gn", dev):
            if parallel_frames:
                # predict every pose in the block by chaining priors from the
                # refined block-start pose; corrections are absolute against
                # the shared frozen submap, so prior drift does not compound
                preds, pose = [], pose0
                for k in ks:
                    if prior_deltas is not None:
                        pose = pose @ prior_deltas[F0 + k]
                    elif use_const_velocity_rot:
                        pose = pose @ prev_rot
                    if use_doppler_prior:
                        pose = _add_doppler_step(pose, held_vel[k], held_valid[k])
                    preds.append(pose)
                preds = torch.stack(preds)
                inl = est_all.inlier_mask[k0:k1]
                g, wsum = vgicp_align_block(
                    rest.xyz[k0:k1], sub_mean, sub_cov, inl, submask, cov_all[k0:k1],
                    preds, cfg=cfg.gicp, tgt_count=sub_n, gate_axis=axis2)
                # a frame that matches nothing reports fitness 0: fold the
                # matched fraction into an EFFECTIVE fitness so both the
                # fallback test and the tracking gate see the failure
                nval = torch.clamp(torch.sum(inl, dim=-1), min=1.0)
                fitness = torch.where(wsum / nval < 0.25, 1e6, g.fitness)
                healthy = True
                if sequential_fallback:
                    healthy = bool(torch.all((fitness < cfg.tracking.max_fitness)
                                             & torch.isfinite(fitness)))
                if healthy:
                    new_T, masks, _ = _apply_tracking_gate(cfg, preds, g.transform,
                                                           fitness, inl)
                    outs = ScanToMapOutput(
                        world_T=new_T, correction=new_T @ se3_inverse(preds),
                        velocity=held_vel[k0:k1], velocity_sigma=est_all.sigma[k0:k1],
                        velocity_valid=held_valid[k0:k1], fitness=fitness,
                        num_inliers=torch.sum(inl, dim=-1),
                        submap_points=sub_n.expand(block), iterations=g.iterations,
                        insert_mask=masks)
                    pose = new_T[-1]
                    # cv-rot seed for the next block from the last two
                    # CORRECTED poses
                    prev_rot = _with_rotation(
                        (se3_inverse(new_T[-2]) @ new_T[-1])[:3, :3])
                else:
                    SEQUENTIAL_FALLBACK_BLOCKS += 1
                    pose, prev_rot, outs = sequential(pose0, prev_rot, frozen, ks)
            else:
                pose, prev_rot, outs = sequential(pose0, prev_rot, frozen, ks)
        with _phase(phase_times, "insert", dev):
            lb = vmcfg.block_insert_leader_budget
            world_pts = se3_apply(outs.world_T, rest.xyz[k0:k1])
            vmap = voxel_map_insert(state.vmap, world_pts.reshape(-1, 3),
                                    outs.insert_mask.reshape(-1),
                                    rest.intensity[k0:k1].reshape(-1),
                                    leader_budget=lb if lb > 0 else None)
        state = ScanToMapState(world_T=pose, vmap=vmap)
        block_outs.append(outs)

    if warm_outs is not None:
        block_outs.insert(0, warm_outs)
    return state, _cat_outputs(block_outs)


def run_scan_to_map_batch(scans: RadarScan, cfg: PipelineConfig = PipelineConfig(),
                          **kwargs):
    """B independent sequences, each with its own map (serving): not ported."""
    raise _not_ported("run_scan_to_map_batch (batched serving)")
