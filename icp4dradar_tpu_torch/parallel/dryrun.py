"""The port's counterpart of the repository's `__graft_entry__.py`: a
single-device forward step with its example arguments (`entry`), and one
multi-device step over a real process group (`dryrun_multichip`).

`dryrun_multichip(n)` spawns n ranks (NCCL on the card, gloo with
`device="cpu"`), each initialised through a `FileStore` in a fresh temp
directory (no network), and runs the JAX dry run's stages 1, 2, 4 and 4b
on tiny shapes, at the JAX entry's: dp REVE (1), dp pairwise ICP (2), the
sharded map's insert and sector query at capacity 2^12 (3), the ring
VGICP normal equations on 256 n tiled targets (3b), the 16-frame blocked
distributed scan-to-map run with forget on, at capacity 512 n and submap
64 n (3c, the JAX entry's "main act"), the distributed dense normal
equations with one replicated solve (4), and the distributed block GN
(4b).

`run_on_ranks(fn, n, *args)` is the launcher: it runs fn(*args) on n
spawned ranks and returns each rank's result. fn must be importable by
name from a module the ranks can import."""

from __future__ import annotations

import os
import queue
import shutil
import tempfile
import time
from typing import Any, Callable, List

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def entry(device="cuda"):
    """(fn, example_args): the forward step of the flagship pipeline
    (scan-to-map odometry: REVE -> voxel-map sector submap -> VGICP -> pose
    update) on one device, with the JAX entry's config, scan and draws."""
    from icp4dradar_tpu_torch.config import PipelineConfig
    from icp4dradar_tpu_torch.io import SyntheticSequence
    from icp4dradar_tpu_torch.models import scan_to_map_init, scan_to_map_step
    from icp4dradar_tpu_torch.preprocess.reve import reve_hypotheses
    from icp4dradar_tpu_torch.utils import threefry

    cfg = PipelineConfig().override(**{
        "max_points": 1024,
        "voxel_map.capacity": 1 << 14,
        "voxel_map.submap_max_points": 1 << 12,
    })
    seq = SyntheticSequence(num_frames=2, max_points=1024, num_landmarks=4000)
    scan = seq.scan(0, device=device)
    state = scan_to_map_init(cfg, device=device)
    # the draws of JAX's scan_to_map_step under key(0)
    uniforms = torch.from_numpy(threefry.uniform(threefry.key(0),
                                                 3 * reve_hypotheses(cfg.reve))).to(device)

    def fn(state, scan, uniforms):
        new_state, out = scan_to_map_step(state, scan, uniforms, cfg, use_doppler_prior=True)
        return new_state.world_T, out.fitness, new_state.vmap.occupied

    return fn, (state, scan, uniforms)


def _rank_main(rank: int, n: int, backend: str, store: str, fn, args, results_q) -> None:
    torch.set_num_threads(1)
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"file://{store}", rank=rank, world_size=n)
    try:
        results_q.put((rank, fn(*args)))
    finally:
        dist.destroy_process_group()


def run_on_ranks(fn: Callable, n: int, *args, backend: str = "gloo",
                 timeout: float = 1200.0) -> List[Any]:
    """fn(*args) on n spawned ranks of one process group (`backend` "nccl"
    or "gloo"); returns the n results in rank order. A rank that fails, or
    a run longer than `timeout` seconds, fails the call."""
    ctx = mp.get_context("spawn")
    results_q = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="icp4d_pg_")
    store = os.path.join(tmp, "store")
    procs = [ctx.Process(target=_rank_main, args=(r, n, backend, store, fn, args, results_q))
             for r in range(n)]
    try:
        for p in procs:
            p.start()
        results, t0 = {}, time.monotonic()
        # read before joining: a rank blocks in `put` until its result is read
        while len(results) < n:
            try:
                rank, res = results_q.get(timeout=1.0)
                results[rank] = res
            except queue.Empty:
                codes = [p.exitcode for p in procs]
                if any(c not in (None, 0) for c in codes):
                    raise RuntimeError(f"run_on_ranks: rank exit codes {codes}")
                if time.monotonic() - t0 > timeout:
                    raise RuntimeError(f"run_on_ranks: no result within {timeout} s")
        for p in procs:
            p.join()
        return [results[r] for r in range(n)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        shutil.rmtree(tmp, ignore_errors=True)


def _dryrun_rank(device: str) -> dict:
    """The dry run's stages on one rank; its results as numpy arrays."""
    from icp4dradar_tpu_torch.config import PipelineConfig, PoseGraphConfig
    from icp4dradar_tpu_torch.graph import PoseGraph, RelPoseFactors, solve_pose_graph_step
    from icp4dradar_tpu_torch.io import SyntheticSequence
    from icp4dradar_tpu_torch.io.scan import stack_scans
    from icp4dradar_tpu_torch.ops.vgicp_fused import radar_point_covariances_packed
    from icp4dradar_tpu_torch.parallel import (
        batched_icp_pairs,
        batched_preprocess,
        distributed_normal_equations,
        distributed_optimize_pose_graph_block,
        make_mesh,
        ring_vgicp_normal_equations,
        run_scan_to_map_distributed,
        shard_scan_batch,
        sharded_map_create,
        sharded_map_insert,
        sharded_sector_search_with_stats,
    )
    from icp4dradar_tpu_torch.utils import threefry

    n = dist.get_world_size()
    mesh = make_mesh(n, device_type=device)
    cfg = PipelineConfig().override(**{
        "max_points": 256, "icp.max_iterations": 3, "reve.use_ransac": True})
    F = 2 * n
    seq = SyntheticSequence(num_frames=F + 1, max_points=256, num_landmarks=1500,
                            world_extent=60.0, max_range=50.0)
    scans = [seq.scan(k) for k in range(F + 1)]

    # 1) dp scan preprocessing (embarrassingly parallel)
    batch = shard_scan_batch(stack_scans(scans[:F]), mesh)
    est = batched_preprocess(batch, threefry.key(0), mesh, cfg)

    # 2) dp pairwise ICP -> between-factor measurements
    src = shard_scan_batch(stack_scans(scans[1:F + 1]), mesh)
    tgt = shard_scan_batch(stack_scans(scans[:F]), mesh)
    T_rel = batched_icp_pairs(src, tgt, mesh, cfg)
    dev = T_rel.device

    # 3) the sharded voxel map: per-rank slot ranges, the verdicts of each
    #    probe round all-reduced, the sector query compacted per shard
    sm = sharded_map_create(mesh, capacity=1 << 12, voxel_size=0.5)
    s0, s1 = scans[0].to(dev), scans[1].to(dev)
    sm = sharded_map_insert(sm, mesh, s0.xyz, s0.mask)
    _, _, sub_n, _, _ = sharded_sector_search_with_stats(
        sm, mesh, torch.zeros(3, device=dev), 80.0, torch.tensor(0.0, device=dev), 180.0, 1024)
    assert int(sub_n) > 0, "sharded map sector query found nothing"

    # 3b) the ring VGICP: target shards rotate over the ranks, running-best
    #     merge, one frozen-payload pass, one all-reduce
    M = 256 * n
    tmean = s0.xyz[:256].repeat(n, 1)
    tcov = torch.tensor([0.05, 0.05, 0.05, 0.0, 0.0, 0.0], device=dev).expand(M, 6)
    Hr, gr, costr, wr, d2r = ring_vgicp_normal_equations(
        torch.eye(4, device=dev), s1.xyz, s1.mask, radar_point_covariances_packed(s1.xyz),
        tmean, tcov, torch.ones(M, device=dev), mesh)
    assert bool(torch.isfinite(Hr).all()) and float(wr) > 0

    # 3c) the end-to-end distributed scan-to-map pipeline: sharded insert,
    #     shard-local sector query, ring VGICP GN, the gated pose chain, a
    #     16-frame sequence in blocked mode (const-velocity rotation prior)
    #     with forget and the distributed rehash on
    dcfg = cfg.override(**{
        "voxel_map.capacity": 512 * n, "voxel_map.submap_max_points": 64 * n,
        "voxel_map.forget_radius": 100.0, "gicp.max_iterations": 4})
    DF = 16
    dseq = SyntheticSequence(num_frames=DF, max_points=256, num_landmarks=1500,
                             world_extent=60.0, max_range=50.0, seed=7)
    vmd, douts = run_scan_to_map_distributed(stack_scans([dseq.scan(k) for k in range(DF)]),
                                             mesh, dcfg, block=4, use_const_velocity_rot=True)
    assert bool(torch.isfinite(douts["world_T"]).all()), \
        "distributed pipeline produced non-finite poses"
    n_vox = int(vmd.num_voxels)
    assert n_vox > 0, "distributed pipeline built no map"

    # 4) distributed pose-graph GN: factor-sharded assembly, all-reduced
    #    normal equations, a replicated solve (T_meas maps frame k+1 points
    #    into frame k: between(i=k, j=k+1))
    K = F + 1
    rel = RelPoseFactors.build(np.arange(F), np.arange(1, F + 1), T_rel)
    graph = PoseGraph(poses=torch.eye(4, device=dev).repeat(K, 1, 1), rel=rel)
    pg_cfg = PoseGraphConfig(max_iterations=3)
    H, g, cost = distributed_normal_equations(graph, mesh, pg_cfg)
    poses, delta = solve_pose_graph_step(graph, H, g, pg_cfg)
    assert bool(torch.isfinite(poses).all()), "non-finite poses"
    assert bool(torch.isfinite(cost)), "non-finite cost"

    # 4b) the O(K) block-sparse distributed solver, the back end of
    #     run_pose_graph_odometry(mesh=...)
    graph_b, cost_b = distributed_optimize_pose_graph_block(graph, mesh, pg_cfg)
    assert bool(torch.isfinite(graph_b.poses).all()), "non-finite block-solver poses"
    assert graph_b.rel is not None, "block solver must preserve rel factors"
    if dist.get_rank() == 0:
        print(f"dryrun_multichip OK: mesh={tuple(zip(mesh.mesh_dim_names, mesh.shape))} "
              f"frames={F} keyframes={K} cost={float(cost):.4f} |dx|={float(delta):.4f}",
              flush=True)
    out = dict(velocity=est.velocity, valid=est.valid, inlier_mask=est.inlier_mask,
               T_rel=T_rel, map_tables=sm.gather().tables(), sub_n=sub_n,
               ring=(Hr, gr, costr, wr, d2r), pipeline=douts, pipeline_voxels=n_vox,
               H=H, g=g, cost=cost, poses=poses, delta=delta,
               block_poses=graph_b.poses, block_cost=cost_b)
    return _numpy(out)


def _numpy(x):
    """Tensors of a nest of dicts, tuples and lists as numpy arrays."""
    if isinstance(x, dict):
        return {k: _numpy(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_numpy(v) for v in x)
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else x


def dryrun_multichip(n_devices: int, device: str = "cuda") -> dict:
    """Run ONE multi-device step on n spawned ranks (NCCL on the card,
    gloo with device="cpu") and return rank 0's results."""
    if device == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"dryrun_multichip: need {n_devices} CUDA devices, have "
                           f"{torch.cuda.device_count()}")
    backend = "nccl" if device == "cuda" else "gloo"
    return run_on_ranks(_dryrun_rank, n_devices, device, backend=backend)[0]


if __name__ == "__main__":
    import sys

    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 1,
                     sys.argv[2] if len(sys.argv) > 2 else "cuda")
