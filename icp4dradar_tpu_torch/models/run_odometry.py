"""CLI entry point: run odometry over a .bin sequence directory (or a
built-in synthetic sequence) and write reference-compatible outputs
(PyTorch port of `icp4dradar_tpu/models/run_odometry.py`: the scan-to-scan,
scan-to-map and pose-graph modes).

    python -m icp4dradar_tpu_torch.models.run_odometry --mode scan_to_scan \
        --synthetic 200 --doppler-prior --device cuda --out /tmp/radar
    python -m icp4dradar_tpu_torch.models.run_odometry --mode scan_to_map \
        --synthetic 256 --map-interval 8 --cv-rot --device cuda --out /tmp/radar
    python -m icp4dradar_tpu_torch.models.run_odometry --mode pose_graph \
        --front-end scan_to_map --structure-factors --synthetic 128 --out /tmp/radar

Outputs, as the JAX CLI writes them: scan_to_scan writes velocity.txt,
icp.txt and output_result.csv; scan_to_map writes velocity.txt and
radar_odometry.txt; pose_graph writes radar_odometry.txt (the refined
poses), odometry_raw.txt (the front end's) and a `pose_graph` metrics
record (loop_closures, keyframes, cost); every mode writes odom_tum.txt (TUM rows of the world poses),
pcl_info.txt (the raw point count of each frame) and metrics.jsonl (opened
before the run, ending in a `run_complete` record), and with `--local-map`
icp_map.txt (the window ICP corrections of `models/local_map.py`, one row
per pair of consecutive 15-frame windows). The last stdout line
is one JSON record with the mode, the device, frames, elapsed seconds,
scans/s and, for synthetic sequences, the ATE.

`--device cuda` (the default) needs a CUDA device and never falls back to
the CPU; `--device cpu` runs the plain PyTorch versions of the kernels.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

def build_scans(args, device):
    from icp4dradar_tpu_torch.io import BinSequenceDataset, SyntheticSequence
    from icp4dradar_tpu_torch.io.scan import stack_scans

    if args.dataset:
        ds = BinSequenceDataset(args.dataset, max_points=args.max_points)
        if len(ds) == 0:
            raise SystemExit(f"no frames under {args.dataset}/data/")
        return stack_scans([ds[k] for k in range(len(ds))]).to(device), None
    seq = SyntheticSequence(
        num_frames=args.synthetic, max_points=args.max_points,
        num_landmarks=args.landmarks, seed=args.seed,
    )
    scans = stack_scans([seq.scan(k) for k in range(len(seq))]).to(device)
    return scans, seq.poses


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--mode", choices=["scan_to_scan", "scan_to_map", "pose_graph"],
                   default="scan_to_scan")
    p.add_argument("--dataset", help=".bin sequence directory (data/radar_pointcloud_k.bin)")
    p.add_argument("--synthetic", type=int, default=0,
                   help="generate a synthetic sequence with F frames instead")
    p.add_argument("--landmarks", type=int, default=20000)
    p.add_argument("--max-points", type=int, default=2048)
    p.add_argument("--out", default="radar", help="output directory")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--config", help="JSON config file (PipelineConfig)")
    p.add_argument("--set", action="append", default=[],
                   help="dotted config override key=value")
    p.add_argument("--doppler-prior", action="store_true")
    p.add_argument("--static-only", action="store_true",
                   help="register on static points only (ref USE_STATIC_POINTS)")
    p.add_argument("--structure-factors", action="store_true",
                   help="mine keyframe-to-map line/plane factors into the "
                        "pose-graph back end (--mode pose_graph)")
    p.add_argument("--front-end", default="scan_to_scan",
                   choices=["scan_to_scan", "scan_to_map"],
                   help="odometry front end for --mode pose_graph")
    p.add_argument("--cv-rot", action="store_true",
                   help="scan_to_map: constant-velocity rotation prior (the "
                        "previous frame's refined body rotation seeds the "
                        "next prediction)")
    p.add_argument("--map-interval", type=int, default=1,
                   help="scan_to_map: amortize sector query + insert over "
                        "this many frames (run_scan_to_map_blocked)")
    p.add_argument("--sequential-blocks", action="store_true",
                   help="blocked scan_to_map: register the frames of a block "
                        "one after another instead of the joint GN")
    p.add_argument("--local-map", action="store_true",
                   help="window ICP refinement pass -> icp_map.txt "
                        "(ref USE_LOCAL_MAP)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)

    if not args.dataset and not args.synthetic:
        p.error("provide --dataset or --synthetic F")
    if args.device == "cuda" and not torch.cuda.is_available():
        p.error("--device cuda: torch.cuda.is_available() is False "
                "(pass --device cpu to run on the CPU)")
    device = torch.device(args.device)

    from icp4dradar_tpu_torch.config import PipelineConfig
    from icp4dradar_tpu_torch.utils import (
        MetricsLogger, ate_rmse, write_pcl_info, write_rt_txt, write_tum,
    )

    cfg = PipelineConfig()
    if args.config:
        with open(args.config) as f:
            cfg = PipelineConfig.from_json(f.read())
    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        overrides[k] = json.loads(v)
    if overrides:
        cfg = cfg.override(**overrides)
    cfg = cfg.override(**{"max_points": args.max_points, "seed": args.seed})

    scans, gt_poses = build_scans(args, device)
    F = scans.xyz.shape[0]
    os.makedirs(args.out, exist_ok=True)
    with MetricsLogger(os.path.join(args.out, "metrics.jsonl")) as log:
        poses, elapsed = run_mode(args, cfg, scans, log)
        if args.local_map:
            from icp4dradar_tpu_torch.models.local_map import local_map_refinement

            T_map = local_map_refinement(scans.xyz.cpu().numpy(), scans.mask.cpu().numpy(),
                                         poses, cfg=cfg.icp, device=device)
            write_rt_txt(os.path.join(args.out, "icp_map.txt"), T_map)
        write_tum(os.path.join(args.out, "odom_tum.txt"), poses)
        write_pcl_info(os.path.join(args.out, "pcl_info.txt"),
                       scans.mask.sum(dim=-1).cpu().numpy())
        rec = {"frames": F, "elapsed_s": round(elapsed, 3),
               "scans_per_sec": round(F / elapsed, 2)}
        if gt_poses is not None:
            rec["ate_rmse_m"] = round(ate_rmse(poses[:, :3, 3], gt_poses[:, :3, 3]), 4)
        log.log("run_complete", mode=args.mode, **rec)
    print(json.dumps({"mode": args.mode, "device": str(device), **rec}))
    return 0


def run_mode(args, cfg, scans, log):
    """Runs `args.mode` over the scans and writes the mode's own output
    files (and, for pose_graph, its metrics record) -> (world poses
    (F, 4, 4) numpy, seconds of the run)."""
    from icp4dradar_tpu_torch.models.scan_to_map import (
        run_scan_to_map, run_scan_to_map_blocked,
    )
    from icp4dradar_tpu_torch.models.scan_to_scan import run_scan_to_scan
    from icp4dradar_tpu_torch.utils import write_result_csv, write_rt_txt, write_velocity_txt

    t0 = time.perf_counter()
    if args.mode == "pose_graph":
        from icp4dradar_tpu_torch.models.pose_graph_odometry import run_pose_graph_odometry

        res = run_pose_graph_odometry(scans, cfg, front_end=args.front_end,
                                      structure_factors=args.structure_factors)
        elapsed = time.perf_counter() - t0
        write_rt_txt(os.path.join(args.out, "radar_odometry.txt"), res.poses)
        write_rt_txt(os.path.join(args.out, "odometry_raw.txt"), res.odom_poses)
        log.log("pose_graph", loop_closures=res.num_loop_closures,
                keyframes=int(len(res.keyframe_indices)), cost=res.cost)
        return res.poses, elapsed
    if args.mode == "scan_to_scan":
        outs = run_scan_to_scan(scans, cfg, use_doppler_prior=args.doppler_prior,
                                use_static_points_only=args.static_only)
        poses = outs.world_T.cpu().numpy()
        elapsed = time.perf_counter() - t0
        write_rt_txt(os.path.join(args.out, "icp.txt"),
                     outs.icp_transform.cpu().numpy())
        write_result_csv(
            os.path.join(args.out, "output_result.csv"),
            outs.icp_transform.cpu().numpy(), outs.fitness.cpu().numpy(),
            outs.sine_A.cpu().numpy(), outs.sine_b.cpu().numpy(),
        )
    else:
        # as the JAX CLI: the Doppler prior is on unless --static-only
        use_prior = not args.static_only or args.doppler_prior
        if args.map_interval > 1:
            _, outs = run_scan_to_map_blocked(
                scans, cfg, block=args.map_interval, use_doppler_prior=use_prior,
                use_const_velocity_rot=args.cv_rot,
                parallel_frames=not args.sequential_blocks)
        else:
            _, outs = run_scan_to_map(scans, cfg, use_doppler_prior=use_prior,
                                      use_const_velocity_rot=args.cv_rot)
        poses = outs.world_T.cpu().numpy()
        elapsed = time.perf_counter() - t0
        write_rt_txt(os.path.join(args.out, "radar_odometry.txt"), poses)
    write_velocity_txt(os.path.join(args.out, "velocity.txt"),
                       outs.velocity.cpu().numpy())
    return poses, elapsed


if __name__ == "__main__":
    raise SystemExit(main())
