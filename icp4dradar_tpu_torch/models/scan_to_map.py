"""Scan-to-map odometry (VGICP or kNN GICP) against the voxel-hash map, the
`radar_odometry` pipeline (PyTorch port of
`icp4dradar_tpu/models/scan_to_map.py`).

Reference main_task (src/radar_odometry.cpp:311-434): REVE ego velocity
extracts the inlier scan (:328-342); the first scan builds the map
(:344-350); each tracked frame sector-searches an 80 m +-60 deg submap
around the current position (:392-396), registers the scan against it
(:399-406), composes the correction (:411-412) and inserts the corrected
scan (:382-390). As in the JAX package, registration runs BEFORE insertion
and the pipeline's own pose tracks the map. With a finite
`voxel_map.forget_radius` each insert is followed by forgetting the voxels
beyond it and, once tombstones pile up, a rehash.

- `run_scan_to_map`: the per-frame tracker, a Python frame loop.
- `run_scan_to_map_blocked`: one sector query and one batched insert per
  `block` frames; the frames of a block register jointly against the frozen
  block submap in one frame-parallel GN (one fused sweep per iteration for
  the whole block), with a sequential re-track of blocks that look lost.
- `run_scan_to_map_batch`: B independent streams, each with its own map
  (serving). Every stage batches over the streams inside its launches: one
  REVE pass, one sector query, one joint GN (one sweep an iteration over
  all B x block frames, each stream against its own submap) and one insert
  per block for all streams; no Python loop over streams. The
  single-stream runners run their stream as a batch of one, so that a
  stream tracks alike, bit for bit, alone and in a batch.

A runner's call is the span `s2m.replay` (`utils/profiling.py`); each
phase (reve, sort, sector_query, map_knn, gn, insert, forget) is a span
`s2m.<phase>`, the blocked runner's warm-up frames `s2m.warmup` and its
sequential re-track `s2m.fallback`.

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

Mapping on ground truth: with `gt_pose(s)` the prediction is the given
pose (no motion prior, no Doppler step) and registration only reports a
correction; `insert_before_registration` inserts the scan at the predicted
(or ground-truth) pose before registering, and not again after. The
per-frame runner and the per-frame batch take `gt_poses`; the blocked
runner has no such argument, as in the JAX package.

Sparse-vendor tracking, as in the JAX package. With `accumulate_scans` =
k > 1 the per-frame tracker keeps a ring of the last k - 1 refined, gated
scans that are not in the map yet: they join each frame's registration as
extra sources (`aux_world_xyz`, re-expressed in the predicted sensor frame
for VGICP, kept in the world frame for kNN GICP), and the oldest of them is
what the frame inserts (`insert_override`; frame 0 still seeds the empty
map). Only the per-frame tracker reads `accumulate_scans`: the blocked
runner's warm-up frames accumulate, its blocks do not, and a step, a
session or the distributed pipeline runs as with k = 1. The override is
ignored under `insert_before_registration`, as in the JAX package. The
blocked runner's `rigid_union` registers each block's scans as one rigid
cloud in the block-end predicted sensor frame: one GN correction for the
whole block, applied to every prediction of the block, with no sequential
re-track.
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
from icp4dradar_tpu_torch.geom.linalg import small_matmul as mm
from icp4dradar_tpu_torch.geom.se3 import se3_apply, se3_inverse
from icp4dradar_tpu_torch.geom.so3 import matrix_to_rpy, so3_project
from icp4dradar_tpu_torch.io.scan import RadarScan
from icp4dradar_tpu_torch.mapping import (
    VoxelHashMap,
    voxel_map_create,
    voxel_map_forget_far,
    voxel_map_insert,
    voxel_map_knn_exact,
    voxel_map_maybe_rehash,
    voxel_map_sector_search,
    voxel_map_sector_search_with_stats,
)
from icp4dradar_tpu_torch.ops.vgicp_fused import radar_point_covariances_packed
from icp4dradar_tpu_torch.preprocess.reve import (
    EgoVelocityEstimate,
    draw_reve_uniforms,
    estimate_ego_velocity,
)
from icp4dradar_tpu_torch.registration.gicp import (
    covariances_from_neighbors,
    gicp_align_streams,
)
from icp4dradar_tpu_torch.registration.vgicp import vgicp_align_block, vgicp_align_streams
from icp4dradar_tpu_torch.utils.profiling import count, span

# Blocks of `run_scan_to_map_blocked` in this process that fell back to the
# sequential re-track (a lost or unhealthy joint registration); a batch
# counts each stream's block.
SEQUENTIAL_FALLBACK_BLOCKS = 0

# Frames per REVE chunk in the blocked runner's precompute: the (frames, N,
# H) residual tile is 310 MB for 248 frames at N = 2048, H = 152.
REVE_FRAME_CHUNK = 64


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
    dR = mm(pose[..., :3, :3].transpose(-1, -2), new_T[..., :3, :3])
    trace = dR[..., 0, 0] + dR[..., 1, 1] + dR[..., 2, 2]
    corr_r = torch.rad2deg(torch.arccos(torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)))
    accept = ((fitness < t.max_fitness) & (corr_t < t.max_correction_t)
              & (corr_r < t.max_correction_rot_deg))
    new_T = torch.where(accept[..., None, None], new_T, pose)
    insert_mask = insert_mask * accept[..., None].to(insert_mask.dtype)
    return new_T, insert_mask, accept


@dataclass(frozen=True)
class ScanToMapState:
    world_T: torch.Tensor       # ([B,] 4,4) current odometry (ref currOdom)
    vmap: VoxelHashMap          # one table, or one per stream (a batch)


@dataclass(frozen=True)
class ScanToMapOutput:
    """Per-frame record; stacked (F, ...) from the runners, (B, F, ...) from
    a batch."""

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


def _map_outputs(fn, *outs) -> ScanToMapOutput:
    return ScanToMapOutput(**{f.name: fn([getattr(o, f.name) for o in outs])
                              for f in dataclasses.fields(ScanToMapOutput)})


def _stream_outputs(out: ScanToMapOutput, b) -> ScanToMapOutput:
    return _map_outputs(lambda xs: xs[0][b], out)


def _lift_state(state: Optional[ScanToMapState]) -> Optional[ScanToMapState]:
    """A single-stream state as a batch of one (views)."""
    if state is None:
        return None
    return ScanToMapState(world_T=state.world_T[None],
                          vmap=state.vmap.with_tables(t[None] for t in state.vmap.tables()))


def _stream_state(state: ScanToMapState, b) -> ScanToMapState:
    return ScanToMapState(world_T=state.world_T[b], vmap=state.vmap.stream(b))


def _stack_outputs(outs, dim=0) -> ScanToMapOutput:
    return _map_outputs(lambda xs: torch.stack(xs, dim), *outs)


def _cat_outputs(parts, dim=0) -> ScanToMapOutput:
    return _map_outputs(lambda xs: torch.cat(xs, dim), *parts)


def _phase(times: Optional[Dict[str, float]], name: str, device, prefix: str = "s2m."):
    """The phase `name` as the span `<prefix><name>`, which never
    synchronizes; when `times` is a dict, also the phase's host-clock time,
    added to times[name], with the device synchronized before and after."""
    if times is None:
        return span(prefix + name)
    return _timed_phase(times, name, device, prefix)


@contextlib.contextmanager
def _timed_phase(times: Dict[str, float], name: str, device, prefix: str):
    with span(prefix + name):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        times[name] = times.get(name, 0.0) + time.perf_counter() - t0


def scan_to_map_init(cfg: PipelineConfig = PipelineConfig(), dtype=torch.float32,
                     device="cuda", streams: Optional[int] = None) -> ScanToMapState:
    """A fresh pose and map; with `streams` = B, B of each (a batch)."""
    vm = voxel_map_create(capacity=cfg.voxel_map.capacity,
                          voxel_size=cfg.voxel_map.voxel_size,
                          max_probes=cfg.voxel_map.max_probes,
                          dtype=dtype, device=device, streams=streams)
    eye = torch.eye(4, dtype=dtype, device=device)
    return ScanToMapState(world_T=eye if streams is None else eye.repeat(streams, 1, 1),
                          vmap=vm)


def _with_rotation(R: torch.Tensor) -> torch.Tensor:
    """(...,3,3) -> (...,4,4) pure rotation, projected onto SO(3)."""
    out = torch.eye(4, dtype=R.dtype, device=R.device).expand(R.shape[:-2] + (4, 4)).clone()
    out[..., :3, :3] = so3_project(R)
    return out


def _add_doppler_step(pose, velocity, valid):
    """Advance the pose by one frame of body-frame ego velocity where
    `valid`."""
    out = pose.clone()
    step = mm(pose[..., :3, :3], velocity[..., None])
    out[..., :3, 3] += torch.where(valid[..., None], step[..., 0], 0.0)
    return out


def _forget(vmap: VoxelHashMap, pose, cfg: PipelineConfig, phase_times, dev) -> VoxelHashMap:
    """With a finite `voxel_map.forget_radius`: tombstone the voxels beyond
    it around the pose ([B,] 4,4), then rehash the tables whose tombstones
    exceed `rehash_tombstone_fraction` (the JAX runners' step after each
    insert, `scan_to_map.py:253-255, 741-748`)."""
    vmcfg = cfg.voxel_map
    if not math.isfinite(vmcfg.forget_radius):
        return vmap
    with _phase(phase_times, "forget", dev):
        vmap = voxel_map_forget_far(vmap, pose[..., :3, 3], vmcfg.forget_radius)
        return voxel_map_maybe_rehash(vmap, vmcfg.rehash_tombstone_fraction)


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
    prior composed into the prediction once the map exists. `gt_pose`
    (4,4): predict this pose instead (the prior and the Doppler step are
    skipped). `insert_before_registration`: insert the scan at the
    predicted pose before registering it, and not after.

    Scan accumulation (`run_scan_to_map` with `accumulate_scans` > 1):
    `aux_world_xyz` (A,3) and `aux_mask` (A,) are world-frame points that
    join the registration only, re-expressed in the predicted sensor frame
    (VGICP: N + A sources) or as they are (kNN GICP); they must not be in
    the map. `insert_override` (xyz_world (N,3), mask (N,), intensity (N,))
    is inserted in place of the corrected scan, which still seeds an empty
    map; it is ignored under `insert_before_registration`, as in the JAX
    package.

    On a batched state (B poses, a map of B tables) the frame is one scan
    per stream, (B, N) fields, uniforms (B, 3H), prior_delta and gt_pose
    (B,4,4), aux points (B, A, 3) / (B, A) and the override's fields (B,
    N, ...): one REVE pass, one sector query, one `vgicp_align_streams` (or
    `gicp_align_streams`) and one insert (two with an override) for all
    streams. A single-stream state steps as a batch of one, so that a
    stream tracks alike, bit for bit, alone and in a batch."""
    if state.vmap.streams is None:
        def lift(x):
            return None if x is None else x[None]

        new_state, out = scan_to_map_step(
            _lift_state(state), scan[None], uniforms[None], cfg, gt_pose=lift(gt_pose),
            insert_before_registration=insert_before_registration,
            use_doppler_prior=use_doppler_prior, prior_delta=lift(prior_delta),
            aux_world_xyz=lift(aux_world_xyz), aux_mask=lift(aux_mask),
            insert_override=None if insert_override is None else tuple(
                x[None] for x in insert_override),
            phase_times=phase_times)
        return _stream_state(new_state, 0), _stream_outputs(out, 0)
    vmcfg = cfg.voxel_map
    dev = scan.device
    with _phase(phase_times, "reve", dev):
        est = estimate_ego_velocity(scan, uniforms, cfg.reve)
    inlier_mask = est.inlier_mask

    pose = state.world_T if gt_pose is None else gt_pose
    has_map = state.vmap.num_voxels > 0
    if prior_delta is not None and gt_pose is None:
        pose = torch.where(has_map[..., None, None], mm(pose, prior_delta), pose)
    if use_doppler_prior and gt_pose is None:
        # the first scan seeds the map at the initial pose
        pose = _add_doppler_step(pose, est.velocity, est.valid & has_map)

    vmap = state.vmap
    if insert_before_registration:
        with _phase(phase_times, "insert", dev):
            vmap = voxel_map_insert(vmap, se3_apply(pose, scan.xyz), inlier_mask,
                                    scan.intensity)
    heading = matrix_to_rpy(pose[..., :3, :3])[..., 2]
    reg_mask = inlier_mask
    if aux_world_xyz is not None:
        am = (torch.ones(aux_world_xyz.shape[:-1], dtype=inlier_mask.dtype, device=dev)
              if aux_mask is None else aux_mask.to(inlier_mask.dtype))
        reg_mask = torch.cat([inlier_mask, am], dim=-1)
    if cfg.gicp.use_vgicp:
        with _phase(phase_times, "sector_query", dev):
            _, submask, sub_n, sub_mean, sub_cov = voxel_map_sector_search_with_stats(
                vmap, pose[..., :3, 3], vmcfg.sector_radius, heading,
                vmcfg.sector_half_angle_deg, vmcfg.submap_max_points,
                min_count=vmcfg.stats_min_count, fallback_var=vmcfg.stats_fallback_var)
        with _phase(phase_times, "gn", dev):
            reg_xyz = scan.xyz
            if aux_world_xyz is not None:
                # past scans in the current predicted sensor frame: exact at
                # the prediction, moved by the residual correction only
                reg_xyz = torch.cat([scan.xyz, se3_apply(se3_inverse(pose), aux_world_xyz)],
                                    dim=-2)
            src_cov6 = radar_point_covariances_packed(
                reg_xyz, cfg.gicp.sigma_range, cfg.gicp.sigma_azimuth,
                cfg.gicp.sigma_elevation)
            g = vgicp_align_streams(reg_xyz, sub_mean, sub_cov, reg_mask, submask,
                                    src_cov6, pose, cfg.gicp, tgt_count=sub_n)
        reg_T, fitness, iterations = g.transform, g.fitness, g.iterations
    else:
        # kNN GICP in the world frame, every stream against its own sector
        # submap in the same launches
        with _phase(phase_times, "sector_query", dev):
            submap, submask, sub_n = voxel_map_sector_search(
                vmap, pose[..., :3, 3], vmcfg.sector_radius, heading,
                vmcfg.sector_half_angle_deg, vmcfg.submap_max_points)
        tgt_cov = None
        if cfg.gicp.use_exact_map_knn:
            # the submap's covariance neighbourhoods from the exact
            # whole-map k-NN, gated at max_correspondence_dist
            with _phase(phase_times, "map_knn", dev):
                d2n, pn = voxel_map_knn_exact(vmap, submap, cfg.gicp.k_correspondences,
                                              max_dist=cfg.gicp.max_correspondence_dist)
                tgt_cov = covariances_from_neighbors(submap, pn, torch.isfinite(d2n),
                                                     cfg.gicp.cov_epsilon)
        with _phase(phase_times, "gn", dev):
            reg_world = se3_apply(pose, scan.xyz)
            if aux_world_xyz is not None:
                reg_world = torch.cat([reg_world, aux_world_xyz], dim=-2)
            g = gicp_align_streams(reg_world, submap, reg_mask, submask, cfg=cfg.gicp,
                                   tgt_cov=tgt_cov)
        reg_T = mm(g.transform, pose)                     # left-compose (ref :412)
        fitness, iterations = g.fitness, g.iterations
    new_T, insert_mask, _ = _apply_tracking_gate(cfg, pose, reg_T, fitness, inlier_mask)
    if not insert_before_registration:
        with _phase(phase_times, "insert", dev):
            mask = insert_mask
            if insert_override is not None:
                # the window's oldest scan enters the map; the current scan
                # seeds it only while it is empty
                vmap = voxel_map_insert(vmap, *insert_override)
                mask = insert_mask * (~has_map)[..., None].to(insert_mask.dtype)
            vmap = voxel_map_insert(vmap, se3_apply(new_T, scan.xyz), mask, scan.intensity)
    vmap = _forget(vmap, new_T, cfg, phase_times, dev)
    out = ScanToMapOutput(
        world_T=new_T, correction=mm(new_T, se3_inverse(pose)), velocity=est.velocity,
        velocity_sigma=est.sigma, velocity_valid=est.valid, fitness=fitness,
        num_inliers=torch.sum(inlier_mask, dim=-1), submap_points=sub_n,
        iterations=iterations, insert_mask=insert_mask,
    )
    return ScanToMapState(world_T=new_T, vmap=vmap), out


def _uniforms_for(scans: RadarScan, cfg: PipelineConfig, uniforms, generator):
    """The given REVE draws, or draws for every frame ((F, 3H), or (B, F,
    3H) for stacked streams, drawn stream by stream) from `generator`, by
    default one seeded with cfg.seed."""
    if uniforms is not None:
        return uniforms
    dev = scans.device
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(cfg.seed)
    lead = scans.time.shape
    if len(lead) == 1:
        return draw_reve_uniforms(lead, cfg.reve, generator, dev)
    return torch.stack([draw_reve_uniforms(lead[1:], cfg.reve, generator, dev)
                        for _ in range(lead[0])])


def _track_frames(scans, cfg, uniforms, use_doppler_prior, prior_deltas,
                  use_const_velocity_rot, init_state, phase_times, gt_poses=None,
                  insert_before_registration=False):
    """The per-frame tracker over (B, F, ...) scans: every frame of every
    stream in one batched step. gt_poses: (B, F, 4, 4) or None. With
    `accumulate_scans` = k > 1 each stream carries a ring (B, k - 1, N,
    ...) of its last k - 1 refined, gated scans, not yet inserted: they
    register with the frame, and the oldest is what the frame inserts."""
    B, F, N = scans.xyz.shape[:3]
    dt, dev = scans.xyz.dtype, scans.device
    state = init_state if init_state is not None else scan_to_map_init(cfg, dt, dev, streams=B)
    prev_rot = torch.eye(4, dtype=dt, device=dev).expand(state.world_T.shape)
    k = max(int(cfg.accumulate_scans), 1)
    ring = None
    if k > 1:
        ring = (torch.zeros((B, k - 1, N, 3), dtype=dt, device=dev),
                torch.zeros((B, k - 1, N), dtype=scans.mask.dtype, device=dev),
                torch.zeros((B, k - 1, N), dtype=dt, device=dev))
    outs = []
    for f in range(F):
        pd = prior_deltas[:, f] if prior_deltas is not None else (
            prev_rot if use_const_velocity_rot else None)
        aux = {}
        if ring is not None:
            aux = dict(aux_world_xyz=ring[0].flatten(1, 2), aux_mask=ring[1].flatten(1, 2),
                       insert_override=tuple(x[:, 0] for x in ring))
        scan = scans[:, f]
        new_state, out = scan_to_map_step(
            state, scan, uniforms[:, f], cfg,
            gt_pose=None if gt_poses is None else gt_poses[:, f],
            insert_before_registration=insert_before_registration,
            use_doppler_prior=use_doppler_prior, prior_delta=pd, phase_times=phase_times,
            **aux)
        delta = mm(se3_inverse(state.world_T), new_state.world_T)
        prev_rot = _with_rotation(delta[..., :3, :3])
        if ring is not None:
            # push this frame at its refined pose with its GATED inlier mask
            # (the raw mask would readmit what REVE filtered); the inserted
            # oldest shifts out
            push = (se3_apply(new_state.world_T, scan.xyz), out.insert_mask, scan.intensity)
            ring = tuple(torch.cat([r[:, 1:], x[:, None]], dim=1) for r, x in zip(ring, push))
        state = new_state
        outs.append(out)
    return state, _stack_outputs(outs, dim=1)


def _alone(run, scans, uniforms, prior_deltas, init_state, *args):
    """Run a batched tracker on one (F, ...) stream as a batch of one, the
    op forms of a stream of a batch, and return its unbatched state and
    (F, ...) outputs."""
    state, out = run(scans[None], uniforms[None],
                     None if prior_deltas is None else prior_deltas[None],
                     _lift_state(init_state), *args)
    return _stream_state(state, 0), _stream_outputs(out, 0)


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
    previous frame's refined body delta (a frame with a ground-truth pose
    ignores it). `gt_poses` (F,4,4): map on ground truth, each frame
    predicted at its pose. `insert_before_registration`: insert each scan
    at its predicted pose before registering it. `init_state`: continue
    from an existing {pose, map}. With `cfg.accumulate_scans` = k > 1 the
    last k - 1 refined scans register with each frame and enter the map k
    - 1 frames late (`scan_to_map_step`'s `aux_world_xyz` and
    `insert_override`)."""
    gt = None if gt_poses is None else gt_poses[None]
    with span("s2m.replay", anchor=True):
        return _alone(lambda sc, u, pd, st: _track_frames(
            sc, cfg, u, use_doppler_prior, pd, use_const_velocity_rot, st, phase_times,
            gt_poses=gt, insert_before_registration=insert_before_registration),
            scans, _uniforms_for(scans, cfg, uniforms, generator), prior_deltas, init_state)


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
    """Sort compacted submap rows ([S,] P) by their projection onto `axis2`
    ([S,] 2) (stable); invalid rows keep +inf keys so the front-packed live
    count stays valid."""
    u = torch.where(submask > 0.5, sub_mean[..., 0] * axis2[..., 0, None]
                    + sub_mean[..., 1] * axis2[..., 1, None], math.inf)
    idx = torch.sort(u, dim=-1, stable=True).indices

    def take(x):
        return torch.gather(x, -2, idx[..., None].expand(x.shape))

    return take(sub_mean), take(sub_cov), torch.gather(submask, -1, idx)


def _estimate_frames(scans: RadarScan, uniforms, cfg: PipelineConfig):
    """REVE over stacked frames, (F, ...) or (B, F, ...) for stacked
    streams, in chunks of REVE_FRAME_CHUNK frames."""
    lead = uniforms.shape[:-1]
    flat = RadarScan(**{f.name: getattr(scans, f.name).reshape((-1,) + getattr(
        scans, f.name).shape[len(lead):]) for f in dataclasses.fields(RadarScan)})
    u = uniforms.reshape(-1, uniforms.shape[-1])
    parts = [estimate_ego_velocity(flat[s:s + REVE_FRAME_CHUNK],
                                   u[s:s + REVE_FRAME_CHUNK], cfg.reve)
             for s in range(0, u.shape[0], REVE_FRAME_CHUNK)]
    return EgoVelocityEstimate(**{
        f.name: torch.cat([getattr(p, f.name) for p in parts]).unflatten(0, lead)
        for f in dataclasses.fields(EgoVelocityEstimate)})


def _velocity_hold(velocity, valid):
    """(..., F, 3), (..., F) -> the last valid velocity at or before each
    frame (zeros before the first) and whether one exists: frames with an
    invalid REVE estimate dead-reckon on it instead of freezing."""
    F = valid.shape[-1]
    frame = torch.arange(F, device=valid.device)
    last = torch.cummax(torch.where(valid, frame, -1), dim=-1).values
    held = torch.gather(velocity, -2, last.clamp(min=0)[..., None].expand(velocity.shape))
    return torch.where((last >= 0)[..., None], held, 0.0), last >= 0


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
    map_knn, gn, insert, forget) are added to it, with a device synchronize
    around each phase. Requires (F - block) % block == 0 (F % block == 0
    with `init_state`).

    `rigid_union` (sparse vendors; with `parallel_frames`): each block's
    scans go into the block-end predicted sensor frame through the chained
    priors and register as ONE rigid cloud of block x N points, and that
    one correction moves every prediction of the block; fitness,
    convergence and iterations are the union's, for every frame. No block
    re-tracks sequentially then."""
    with span("s2m.replay", anchor=True):
        return _alone(lambda sc, u, pd, st: _run_blocked(
            sc, cfg, u, block, use_doppler_prior, pd, use_const_velocity_rot, use_band_gating,
            parallel_frames, st, sequential_fallback, phase_times, rigid_union),
            scans, _uniforms_for(scans, cfg, uniforms, generator), prior_deltas, init_state)


def _run_blocked(scans, cfg, uniforms, block, use_doppler_prior, prior_deltas,
                 use_const_velocity_rot, use_band_gating, parallel_frames, init_state,
                 sequential_fallback, phase_times, rigid_union=False):
    """The blocked tracker over (B, F, ...) scans (uniforms (B, F, 3H),
    prior_deltas (B, F, 4, 4), a batched init_state), every stage running
    all streams in its launches. The sequential re-track of an unhealthy
    block steps frame by frame over the unhealthy streams alone;
    `parallel_frames=False` steps frame by frame, all streams together.
    `rigid_union`: one `vgicp_align_streams` a block for all streams, each
    stream's union of block x N sources against its own submap."""
    global SEQUENTIAL_FALLBACK_BLOCKS
    F = scans.xyz.shape[1]
    dt, dev = scans.xyz.dtype, scans.device

    def frames(x, k):
        """Frame(s) k of every stream of a (B, F, ...) tensor or scan."""
        return x[:, k]

    if block <= 1 or (init_state is None and F <= block):
        return _track_frames(scans, cfg, uniforms, use_doppler_prior, prior_deltas,
                             use_const_velocity_rot, init_state, phase_times)
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
        warm = slice(0, F0)
        with span("s2m.warmup"):
            state, warm_outs = _track_frames(
                frames(scans, warm), cfg, frames(uniforms, warm), use_doppler_prior,
                None if prior_deltas is None else frames(prior_deltas, warm),
                use_const_velocity_rot, None, phase_times)
            warm_delta = mm(se3_inverse(frames(warm_outs.world_T, -2)),
                            frames(warm_outs.world_T, -1))
            prev_rot = _with_rotation(warm_delta[..., :3, :3])
    else:
        state, warm_outs = init_state, None
        prev_rot = torch.eye(4, dtype=dt, device=dev).expand(state.world_T.shape)

    # Frame-parallel precompute: REVE and the measurement-model scan
    # covariances depend only on the raw scan, never on the pose chain.
    rest = frames(scans, slice(F0, None))
    with _phase(phase_times, "reve", dev):
        est_all = _estimate_frames(rest, frames(uniforms, slice(F0, None)), cfg)
        # velocity hold: frames with an invalid REVE estimate dead-reckon
        # on the last valid ego velocity instead of freezing
        held_vel, held_valid = _velocity_hold(est_all.velocity, est_all.valid)
    with _phase(phase_times, "gn", dev):
        cov_all = radar_point_covariances_packed(
            rest.xyz, cfg.gicp.sigma_range, cfg.gicp.sigma_azimuth,
            cfg.gicp.sigma_elevation)

    def pick(x, k, idx):
        """Frame k of the rest for the streams idx: an index tensor or
        slice(None) (all)."""
        return x[idx, k]

    def predict(pose, prev_rot, k, idx):
        """The prior step of frame k of the rest."""
        if prior_deltas is not None:
            pose = mm(pose, pick(prior_deltas, F0 + k, idx))
        elif use_const_velocity_rot:
            pose = mm(pose, prev_rot)
        if use_doppler_prior:
            pose = _add_doppler_step(pose, pick(held_vel, k, idx), pick(held_valid, k, idx))
        return pose

    def frame_step(pose, prev_rot, frozen, k, idx):
        """Register frame k of the rest of the streams idx against their
        frozen block submaps."""
        sub_mean, sub_cov, submask, sub_n, axis2 = frozen
        pred = predict(pose, prev_rot, k, idx)
        inl = pick(est_all.inlier_mask, k, idx)
        xyz, cov = pick(rest.xyz, k, idx), pick(cov_all, k, idx)
        g = vgicp_align_streams(xyz, sub_mean, sub_cov, inl, submask, cov, pred,
                                cfg.gicp, tgt_count=sub_n, gate_axis=axis2)
        new_T, insert_mask, _ = _apply_tracking_gate(cfg, pred, g.transform, g.fitness, inl)
        delta = mm(se3_inverse(pose), new_T)
        out = ScanToMapOutput(
            world_T=new_T, correction=mm(new_T, se3_inverse(pred)),
            velocity=pick(held_vel, k, idx), velocity_sigma=pick(est_all.sigma, k, idx),
            velocity_valid=pick(held_valid, k, idx), fitness=g.fitness,
            num_inliers=torch.sum(inl, dim=-1), submap_points=sub_n,
            iterations=g.iterations, insert_mask=insert_mask)
        return new_T, _with_rotation(delta[..., :3, :3]), out

    def sequential(pose, prev_rot, frozen, ks, idx):
        outs = []
        for k in ks:
            pose, prev_rot, out = frame_step(pose, prev_rot, frozen, k, idx)
            outs.append(out)
        return pose, prev_rot, _stack_outputs(outs, dim=1)

    block_outs = []
    for blk in range(nblocks):
        ks = list(range(blk * block, (blk + 1) * block))
        kb = slice(ks[0], ks[-1] + 1)
        pose0 = state.world_T
        heading = matrix_to_rpy(pose0[..., :3, :3])[..., 2]
        with _phase(phase_times, "sector_query", dev):
            _, submask, sub_n, sub_mean, sub_cov = voxel_map_sector_search_with_stats(
                state.vmap, pose0[..., :3, 3], vmcfg.sector_radius, heading,
                vmcfg.sector_half_angle_deg, vmcfg.submap_max_points,
                min_count=vmcfg.stats_min_count, fallback_var=vmcfg.stats_fallback_var)
        axis2 = None
        if use_band_gating:
            # sort each frozen submap by its block-start forward axis
            with _phase(phase_times, "sort", dev):
                hrad = heading * (math.pi / 180.0)
                axis2 = torch.stack([torch.cos(hrad), torch.sin(hrad)], dim=-1)
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
                    pose = predict(pose, prev_rot, k, slice(None))
                    preds.append(pose)
                preds = torch.stack(preds, dim=-3)                  # ([B,] block, 4, 4)
                inl = frames(est_all.inlier_mask, kb)
                if rigid_union:
                    # one rigid cloud in the block-END predicted sensor
                    # frame: scan i rides at inv(pred_last) pred_i, so the
                    # one correction found applies to every prediction
                    inv_last = se3_inverse(frames(preds, -1))
                    union = se3_apply(mm(inv_last[:, None], preds), frames(rest.xyz, kb))
                    gu = vgicp_align_streams(
                        union.flatten(1, 2), sub_mean, sub_cov, inl.flatten(1, 2), submask,
                        frames(cov_all, kb).flatten(1, 2), frames(preds, -1), cfg.gicp,
                        tgt_count=sub_n, gate_axis=axis2)
                    corr = mm(gu.transform, inv_last)
                    transform = mm(corr[:, None], preds)
                    fitness = gu.fitness[:, None].expand(inl.shape[:2])
                    iterations = gu.iterations[:, None].expand(inl.shape[:2])
                else:
                    g, wsum = vgicp_align_block(
                        frames(rest.xyz, kb), sub_mean, sub_cov, inl, submask,
                        frames(cov_all, kb), preds, cfg=cfg.gicp, tgt_count=sub_n,
                        gate_axis=axis2)
                    # a frame that matches nothing reports fitness 0: fold
                    # the matched fraction into an EFFECTIVE fitness so both
                    # the fallback test and the tracking gate see the
                    # failure
                    nval = torch.clamp(torch.sum(inl, dim=-1), min=1.0)
                    fitness = torch.where(wsum / nval < 0.25, 1e6, g.fitness)
                    transform, iterations = g.transform, g.iterations
                new_T, masks, _ = _apply_tracking_gate(cfg, preds, transform, fitness, inl)
                outs = ScanToMapOutput(
                    world_T=new_T, correction=mm(new_T, se3_inverse(preds)),
                    velocity=frames(held_vel, kb), velocity_sigma=frames(est_all.sigma, kb),
                    velocity_valid=frames(held_valid, kb), fitness=fitness,
                    num_inliers=torch.sum(inl, dim=-1),
                    submap_points=sub_n[..., None].expand(fitness.shape),
                    iterations=iterations, insert_mask=masks)
                pose = frames(new_T, -1)
                # cv-rot seed for the next block from the last two
                # CORRECTED poses
                next_rot = _with_rotation(
                    mm(se3_inverse(frames(new_T, -2)), frames(new_T, -1))[..., :3, :3])
                healthy = torch.all((fitness < cfg.tracking.max_fitness)
                                    & torch.isfinite(fitness), dim=-1)
                if sequential_fallback and not rigid_union:
                    # only the streams whose block looks lost re-track, all
                    # of them together (one host read a block)
                    count("host_syncs")
                    lost = torch.nonzero(~healthy)[:, 0]
                    if lost.numel():
                        SEQUENTIAL_FALLBACK_BLOCKS += lost.numel()
                        with span("s2m.fallback"):
                            p_l, r_l, o_l = sequential(
                                pose0[lost], prev_rot[lost],
                                tuple(None if x is None else x[lost] for x in frozen), ks, lost)
                            pose, next_rot = pose.index_copy(0, lost, p_l), \
                                next_rot.index_copy(0, lost, r_l)
                            outs = _map_outputs(lambda xs: xs[0].index_copy(0, lost, xs[1]),
                                                outs, o_l)
                prev_rot = next_rot
            else:
                pose, prev_rot, outs = sequential(pose0, prev_rot, frozen, ks, slice(None))
        with _phase(phase_times, "insert", dev):
            lb = vmcfg.block_insert_leader_budget
            world_pts = se3_apply(outs.world_T, frames(rest.xyz, kb))
            vmap = voxel_map_insert(state.vmap, world_pts.flatten(-3, -2),
                                    outs.insert_mask.flatten(-2, -1),
                                    frames(rest.intensity, kb).flatten(-2, -1),
                                    leader_budget=lb if lb > 0 else None)
        vmap = _forget(vmap, pose, cfg, phase_times, dev)
        state = ScanToMapState(world_T=pose, vmap=vmap)
        block_outs.append(outs)

    if warm_outs is not None:
        block_outs.insert(0, warm_outs)
    return state, _cat_outputs(block_outs, dim=1)


def run_scan_to_map_batch(
    scans: RadarScan,
    cfg: PipelineConfig = PipelineConfig(),
    uniforms: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    block: int = 0,
    **kwargs,
) -> Tuple[ScanToMapState, ScanToMapOutput]:
    """Track B independent sequences at once (serving): `scans` has a
    leading stream axis (B, F, ...), each stream gets its own map, and every
    stage (REVE, sector query, VGICP sweep, insert, forget) runs all streams
    in the same launches. `block` > 1 runs the blocked tracker (the keyword
    arguments of `run_scan_to_map_blocked`; `sequential_fallback` defaults
    to False, as the JAX package sets it under vmap, and with True only the
    unhealthy streams of a block re-track), else the per-frame one (those
    of `run_scan_to_map`; `gt_poses` then (B, F, 4, 4), or (F, 4, 4) for
    every stream, which is what the JAX batch takes).

    uniforms: (B, F, 3H) REVE draws; without them each stream draws its
    (F, 3H) in turn from `generator`, by default one seeded with cfg.seed.
    Returns the batched state (world_T (B,4,4), a map of B tables) and
    (B, F, ...) outputs. With `gicp.use_vgicp=False` the per-frame batch
    registers by kNN GICP (`gicp_align_streams`: one K2 launch a GN
    iteration for all streams); the blocked batch runs VGICP in its blocks
    and kNN GICP in its warm-up frames, as the single-stream runner does."""
    if scans.xyz.dim() != 4:
        raise ValueError(f"run_scan_to_map_batch takes (B, F, N, 3) scans, got "
                         f"{tuple(scans.xyz.shape)}")
    with span("s2m.replay", anchor=True):
        uniforms = _uniforms_for(scans, cfg, uniforms, generator)
        if block > 1:
            kwargs.setdefault("sequential_fallback", False)
            return _batch_blocked(scans, cfg, uniforms, block, **kwargs)
        return _batch_frames(scans, cfg, uniforms, **kwargs)


def _batch_frames(scans, cfg, uniforms, gt_poses=None, insert_before_registration=False,
                  use_doppler_prior=True, prior_deltas=None, use_const_velocity_rot=False,
                  init_state=None, phase_times=None):
    if gt_poses is not None and gt_poses.dim() == 3:
        # one (F, 4, 4) track for every stream: the JAX batch closes over
        # its keyword arguments instead of mapping them over the streams
        gt_poses = gt_poses.expand((scans.xyz.shape[0],) + tuple(gt_poses.shape))
    return _track_frames(scans, cfg, uniforms, use_doppler_prior, prior_deltas,
                         use_const_velocity_rot, init_state, phase_times, gt_poses=gt_poses,
                         insert_before_registration=insert_before_registration)


def _batch_blocked(scans, cfg, uniforms, block, use_doppler_prior=True, prior_deltas=None,
                   use_const_velocity_rot=False, use_band_gating=True, parallel_frames=True,
                   init_state=None, rigid_union=False, sequential_fallback=False,
                   phase_times=None):
    return _run_blocked(scans, cfg, uniforms, block, use_doppler_prior, prior_deltas,
                        use_const_velocity_rot, use_band_gating, parallel_frames,
                        init_state, sequential_fallback, phase_times, rigid_union)
