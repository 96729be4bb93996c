"""Odometry + keyframe pose-graph back end (PyTorch port of
`icp4dradar_tpu/models/pose_graph_odometry.py`): an odometry front end, a
keyframe graph with odometry-chain and proximity loop-closure factors, and
the block-sparse SE(3) Gauss-Newton refinement — the subsystem the
reference links Ceres for but never runs (include/radarFactor.hpp).

Flow:
1. the front end: scan-to-scan (one batched ICP on K1) or scan-to-map
   (VGICP on K4, blocked by `pose_graph.front_end_block`)
2. keyframes every `keyframe_every` frames; chain factors = the odometry's
   relative transforms between consecutive keyframes (high weight)
3. loop-closure candidates: keyframe pairs near in space and far in time
   under the odometry (the nearest `max_loop_candidates`), each verified
   by ICP between the keyframe scans — all candidates in ONE batched
   `icp_point_to_point` (one K1 launch an iteration), gated on fitness
4. the wrong-closure gating pass, then the pose-graph GN
   (`graph.optimize_pose_graph_block`), with structure-factor mining rounds
   on request
5. every frame re-anchors rigidly to its segment's refined keyframe.

Graph construction and the gates are numpy on the host, as in the JAX
package; the front end, the loop ICP, the structure miner and the solver
run on the scans' device.
"""

from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from icp4dradar_tpu_torch.config import PipelineConfig
from icp4dradar_tpu_torch.graph import PoseGraph, RelPoseFactors, optimize_pose_graph_block
from icp4dradar_tpu_torch.io.scan import RadarScan
from icp4dradar_tpu_torch.models.scan_to_map import _phase
from icp4dradar_tpu_torch.registration.icp import icp_point_to_point


@dataclass
class PoseGraphOdometryResult:
    poses: np.ndarray             # (F,4,4) refined trajectory
    odom_poses: np.ndarray        # (F,4,4) raw odometry trajectory
    keyframe_indices: np.ndarray  # (K,)
    keyframe_poses: np.ndarray    # (K,4,4) refined
    num_loop_closures: int
    cost: float


def _relative_between(odom: np.ndarray, a_idx: np.ndarray,
                      b_idx: np.ndarray) -> np.ndarray:
    """Batched inv(odom[a]) @ odom[b]: the odometry's relative transform
    between frame pairs, the SE(3) inverse in closed form (R^T, -R^T t)."""
    Ta = odom[a_idx]
    Tb = odom[b_idx]
    Rat = np.swapaxes(Ta[:, :3, :3], -1, -2)
    out = np.tile(np.eye(4, dtype=odom.dtype), (len(a_idx), 1, 1))
    out[:, :3, :3] = np.einsum("kij,kjl->kil", Rat, Tb[:, :3, :3])
    out[:, :3, 3] = np.einsum("kij,kj->ki", Rat, Tb[:, :3, 3] - Ta[:, :3, 3])
    return out


def _front_end(scans: RadarScan, cfg: PipelineConfig, front_end: str,
               uniforms) -> np.ndarray:
    """The front end's world poses (F,4,4), as a host array."""
    F = scans.xyz.shape[0]
    if front_end == "scan_to_map":
        from icp4dradar_tpu_torch.models.scan_to_map import (
            run_scan_to_map,
            run_scan_to_map_blocked,
        )

        block = cfg.pose_graph.front_end_block
        if block > 1 and not (F > block and (F - block) % block == 0):
            warnings.warn(
                f"scan_to_map front-end: F={F} does not fit "
                f"pose_graph.front_end_block={block} (needs F > block and "
                f"F % block == 0); falling back to the ~2x-slower per-frame "
                f"path — pad or trim the sequence, or set the block to a "
                f"divisor of F", RuntimeWarning, stacklevel=3)
            block = 0
        if block > 1:
            _, out = run_scan_to_map_blocked(scans, cfg, uniforms, block=block,
                                             use_const_velocity_rot=True)
        else:
            _, out = run_scan_to_map(scans, cfg, uniforms)
    elif front_end == "scan_to_scan":
        from icp4dradar_tpu_torch.models.scan_to_scan import run_scan_to_scan

        out = run_scan_to_scan(scans, cfg, uniforms=uniforms, use_doppler_prior=True)
    else:
        raise ValueError(f"unknown front_end: {front_end!r}")
    return out.world_T.cpu().numpy()


def _mine_structure_factors(scans: RadarScan, cfg: PipelineConfig, kf: np.ndarray,
                            frame_poses: np.ndarray, kf_poses: np.ndarray) -> dict:
    """Keyframe-to-map edge/plane factor mining at the given alignment
    (graph/structure_factors.py): every frame inserts into a fresh voxel map
    of capacity `voxel_map.capacity` in one batch (compacted to at most
    capacity // 2 voxel leaders), and each keyframe's first
    `structure.points_per_keyframe` valid points match against its
    Gaussians."""
    from icp4dradar_tpu_torch.graph.structure_factors import build_structure_factors
    from icp4dradar_tpu_torch.mapping import voxel_map_create, voxel_map_insert
    from icp4dradar_tpu_torch.ops.compaction import mask_compact

    sc = cfg.structure
    dev, dt = scans.xyz.device, scans.xyz.dtype
    poses = torch.from_numpy(frame_poses.astype(np.float32)).to(dev)
    world = (torch.einsum("fij,fnj->fni", poses[:, :3, :3], scans.xyz)
             + poses[:, None, :3, 3])
    vm = voxel_map_create(capacity=cfg.voxel_map.capacity,
                          voxel_size=cfg.voxel_map.voxel_size, dtype=dt, device=dev)
    # whole-trajectory batch insert, compacted to per-voxel leaders (unique
    # voxels cannot exceed the capacity anyway); the overflow is dropped
    rows = world.shape[0] * world.shape[1]
    budget = min(rows, cfg.voxel_map.capacity // 2)
    vm = voxel_map_insert(vm, world.reshape(-1, 3), scans.mask.reshape(-1),
                          leader_budget=budget if budget < rows else None)
    kf_t = torch.from_numpy(kf).to(dev)
    comp, cmask, _ = mask_compact(scans.xyz[kf_t], scans.mask[kf_t], sc.points_per_keyframe)
    K = len(kf)
    kf_ids = torch.arange(K, device=dev).repeat_interleave(sc.points_per_keyframe)
    kf_T = torch.from_numpy(kf_poses.astype(np.float32)).to(dev)
    p_world = (torch.einsum("kij,knj->kni", kf_T[:, :3, :3], comp)
               + kf_T[:, None, :3, 3]).reshape(-1, 3)
    planes, lines, points = build_structure_factors(
        kf_ids, comp.reshape(-1, 3), p_world, cmask.reshape(-1), vm, sc)
    out = dict(planes=planes, lines=lines)
    if sc.use_point_factors:
        out["points"] = points
    return out


def run_pose_graph_odometry(
    scans: RadarScan,
    cfg: PipelineConfig = PipelineConfig(),
    keyframe_every: int = 5,
    loop_radius: float = 5.0,
    min_loop_gap: int = 20,
    max_loop_candidates: int = 16,
    loop_gated_fitness_max: float = 0.5,
    loop_min_inlier_fraction: float = 0.3,
    odom_weight: float = 100.0,
    loop_weight: float = 10.0,
    mesh=None,
    front_end: str = "scan_to_scan",
    structure_factors: bool = False,
    loop_residual_gate_t: float = 2.0,
    loop_residual_gate_r_deg: float = 10.0,
    loop_residual_gate_t_per_frame: float = 0.02,
    loop_residual_gate_r_deg_per_frame: float = 0.05,
    inject_loop_factors=None,
    uniforms: Optional[torch.Tensor] = None,
    phase_times: Optional[Dict[str, float]] = None,
) -> PoseGraphOdometryResult:
    """The full pipeline on the scans' device (the JAX package's
    arguments). With `mesh` (`parallel.make_mesh`, a process group of one
    rank a device) every solve runs the distributed block GN
    (`parallel.distributed_optimize_pose_graph_block`): each rank assembles
    its shard of the chain and structure factors, the block normal
    equations are summed over the ranks, loop closures stay replicated,
    and the solve is replicated; every rank runs the whole pipeline on the
    same inputs and returns the same result.

    Wrong-closure containment: a gating pass optimises with every loop
    factor's weight capped at odom_weight / 100, then drops each loop factor
    whose relative-pose residual there exceeds its gate, and the final
    optimisation restarts from the odometry keyframes. The gates scale with
    the loop's frame span (a legitimate closure's residual at the gating
    solution is about the odometry drift around the loop):
    `loop_residual_gate_t + loop_residual_gate_t_per_frame * span` [m] and
    the rotation analogue [deg]. Set the gates to inf for a single pass.

    `inject_loop_factors`: list of (kf_i, kf_j, T_meas (4,4), weight)
    appended UNVERIFIED to the factor set (a fault-injection hook for the
    containment path).

    `front_end`: "scan_to_scan" or "scan_to_map". `structure_factors`: also
    mine keyframe-to-map line/plane (and, with
    `structure.use_point_factors`, point) factors from a voxel map's
    Gaussians, `structure.rounds` mine -> optimise rounds.

    Port additions: `uniforms`, the front end's RANSAC draws ((F, 2, H)
    for scan_to_scan, (F, 3H) for scan_to_map; by default drawn from a
    generator seeded with cfg.seed; `utils.threefry` gives the JAX
    package's); `phase_times`, when a dict, gets host-clock seconds per
    phase (front_end, loop_icp, gate, structure, optimize), with a device
    synchronize around each."""
    if mesh is not None and not isinstance(mesh, DeviceMesh):
        raise TypeError(f"run_pose_graph_odometry: mesh is a {type(mesh).__name__}, not a "
                        "DeviceMesh (parallel.make_mesh)")
    dev = scans.xyz.device
    F = scans.xyz.shape[0]
    with _phase(phase_times, "front_end", dev, "pg."):
        odom = _front_end(scans, cfg, front_end, uniforms)

    kf = np.arange(0, F, keyframe_every)
    K = len(kf)
    kf_odom = odom[kf]

    # odometry chain factors between consecutive keyframes
    chain_T = (_relative_between(odom, kf[:-1], kf[1:])
               if K > 1 else np.zeros((0, 4, 4), np.float32))
    fi = np.arange(K - 1, dtype=np.int32)
    fj = np.arange(1, K, dtype=np.int32)
    f_T = chain_T.astype(np.float32)
    f_w = np.full(K - 1, odom_weight, np.float32)

    # ---- loop-closure candidates: near in space, far in time ----
    d = np.linalg.norm(kf_odom[:, None, :3, 3] - kf_odom[None, :, :3, 3], axis=-1)
    gap = np.abs(kf[:, None] - kf[None, :])
    cand = np.triu((d < loop_radius) & (gap >= min_loop_gap), 1)
    pairs = np.argwhere(cand)
    if len(pairs) > max_loop_candidates:
        order = np.argsort(d[pairs[:, 0], pairs[:, 1]])
        pairs = pairs[order[:max_loop_candidates]]

    n_loops = 0
    if len(pairs):
        # verify every candidate in one batched ICP between the keyframe
        # scans, from the odometry's relative transform; gated
        # correspondences (partial overlap between revisits) and more
        # iterations than the front end
        src_idx = kf[pairs[:, 1]]
        tgt_idx = kf[pairs[:, 0]]
        loop_cfg = dataclasses.replace(
            cfg.icp, max_iterations=max(cfg.icp.max_iterations, 30),
            max_correspondence_dist=min(cfg.icp.max_correspondence_dist, 2.0),
            transformation_epsilon=1e-5)
        with _phase(phase_times, "loop_icp", dev, "pg."):
            init_T = torch.from_numpy(_relative_between(odom, tgt_idx, src_idx)).to(dev)
            src = scans[torch.from_numpy(src_idx).to(dev)]
            tgt = scans[torch.from_numpy(tgt_idx).to(dev)]
            res = icp_point_to_point(src.xyz, tgt.xyz, src.mask, tgt.mask,
                                     init_transform=init_T, cfg=loop_cfg)
            T_loop = res.transform.cpu().numpy()
            fit = res.gated_fitness.cpu().numpy()
            frac = res.inlier_fraction.cpu().numpy()
        acc = (fit < loop_gated_fitness_max) & (frac > loop_min_inlier_fraction)
        n_loops = int(acc.sum())
        fi = np.concatenate([fi, pairs[acc, 0].astype(np.int32)])
        fj = np.concatenate([fj, pairs[acc, 1].astype(np.int32)])
        f_T = np.concatenate([f_T, T_loop[acc].astype(np.float32)])
        f_w = np.concatenate([f_w, np.full(n_loops, loop_weight, np.float32)])

    for (ki, kj, Tm, wt) in inject_loop_factors or ():
        fi = np.concatenate([fi, [np.int32(ki)]])
        fj = np.concatenate([fj, [np.int32(kj)]])
        f_T = np.concatenate([f_T, np.asarray(Tm, np.float32)[None]])
        f_w = np.concatenate([f_w, [np.float32(wt)]])
        n_loops += 1

    n_chain = K - 1

    def rel_factors(w):
        return RelPoseFactors.build(np.asarray(fi, np.int64), np.asarray(fj, np.int64),
                                    np.asarray(f_T, np.float32), np.asarray(w, np.float32),
                                    device=dev)

    def solve(graph):
        if mesh is None:
            return optimize_pose_graph_block(graph, cfg.pose_graph)
        # O(K) distributed back end: factor-sharded block assembly summed
        # over the ranks, loop closures replicated as low-rank columns
        from icp4dradar_tpu_torch.parallel import distributed_optimize_pose_graph_block
        return distributed_optimize_pose_graph_block(graph, mesh, cfg.pose_graph)

    def loop_residuals(kf_poses: np.ndarray):
        """(t_err (L,), r_err_deg (L,)) of the loop factors (entries past
        the chain) at the given keyframe poses."""
        rel_ij = _relative_between(kf_poses, fi[n_chain:], fj[n_chain:])
        Tm = f_T[n_chain:]
        # E = Tm^-1 rel_ij, closed form
        Rmt = np.swapaxes(Tm[:, :3, :3], -1, -2)
        Re = np.einsum("kij,kjl->kil", Rmt, rel_ij[:, :3, :3])
        te = np.einsum("kij,kj->ki", Rmt, rel_ij[:, :3, 3] - Tm[:, :3, 3])
        cos = np.clip((np.trace(Re, axis1=-2, axis2=-1) - 1.0) * 0.5, -1.0, 1.0)
        return np.linalg.norm(te, axis=-1), np.degrees(np.arccos(cos))

    # frame -> owning-keyframe segment (kf[0] == 0)
    seg = np.searchsorted(kf, np.arange(F), side="right") - 1

    def reanchor(kf_refined: np.ndarray) -> np.ndarray:
        """Every frame re-anchored to its segment's refined keyframe: one
        rigid correction kf_refined[i] @ inv(odom[kf[i]]) per segment."""
        anchors = odom[kf]
        Rat = np.swapaxes(anchors[:, :3, :3], -1, -2)
        corr = np.tile(np.eye(4, dtype=odom.dtype), (K, 1, 1))
        corr[:, :3, :3] = np.einsum("kij,kjl->kil", kf_refined[:, :3, :3], Rat)
        corr[:, :3, 3] = kf_refined[:, :3, 3] - np.einsum(
            "kij,kj->ki", corr[:, :3, :3], anchors[:, :3, 3])
        return np.einsum("fij,fjl->fil", corr[seg], odom)

    def run_rounds(rel, kf_start):
        kf_cur = kf_start
        frames_cur = reanchor(kf_cur)
        cost_out = 0.0
        for _ in range(cfg.structure.rounds if structure_factors else 1):
            struct = {}
            if structure_factors:
                with _phase(phase_times, "structure", dev, "pg."):
                    struct = _mine_structure_factors(scans, cfg, kf, frames_cur, kf_cur)
            with _phase(phase_times, "optimize", dev, "pg."):
                graph, cost = solve(PoseGraph(poses=torch.from_numpy(kf_cur).to(dev),
                                              rel=rel, **struct))
                kf_cur = graph.poses.cpu().numpy()
                cost_out = float(cost)
            frames_cur = reanchor(kf_cur)
        return kf_cur, cost_out

    result_cost = 0.0
    kf_refined = kf_odom
    if len(fi):
        if n_loops and (np.isfinite(loop_residual_gate_t)
                        or np.isfinite(loop_residual_gate_r_deg)):
            # the gating pass: every loop factor's weight capped uniformly
            # LOW (the chain keeps its weight), so no single closure can
            # dominate and a bogus one shows its full residual
            with _phase(phase_times, "gate", dev, "pg."):
                w_gate = np.asarray(f_w, np.float32).copy()
                w_gate[n_chain:] = np.minimum(w_gate[n_chain:], odom_weight * 0.01)
                graph_g, _ = solve(PoseGraph(poses=torch.from_numpy(kf_odom).to(dev),
                                             rel=rel_factors(w_gate)))
                t_err, r_err = loop_residuals(graph_g.poses.cpu().numpy())
            # span-scaled gates: the drift around a loop grows with its span
            gap_l = np.abs(kf[fj[n_chain:]] - kf[fi[n_chain:]]).astype(np.float64)
            gate_t = loop_residual_gate_t + loop_residual_gate_t_per_frame * gap_l
            gate_r = loop_residual_gate_r_deg + loop_residual_gate_r_deg_per_frame * gap_l
            bad = (t_err > gate_t) | (r_err > gate_r)
            if bad.any():
                keep = np.concatenate([np.ones(n_chain, bool), ~bad])
                n_loops = int((~bad).sum())
                fi, fj = fi[keep], fj[keep]
                f_T, f_w = f_T[keep], f_w[keep]

        kf_refined, result_cost = run_rounds(rel_factors(f_w), kf_odom)

    return PoseGraphOdometryResult(
        poses=reanchor(kf_refined),
        odom_poses=odom,
        keyframe_indices=kf,
        keyframe_poses=kf_refined,
        num_loop_closures=n_loops,
        cost=result_cost,
    )
