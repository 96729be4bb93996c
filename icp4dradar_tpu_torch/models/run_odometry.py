"""CLI entry point: run scan-to-scan odometry over a .bin sequence directory
(or a built-in synthetic sequence) and write reference-compatible outputs
(PyTorch port of `icp4dradar_tpu/models/run_odometry.py`, scan-to-scan mode).

    python -m icp4dradar_tpu_torch.models.run_odometry --mode scan_to_scan \
        --synthetic 200 --doppler-prior --device cuda --out /tmp/radar

Outputs (reference formats): velocity.txt, icp.txt, output_result.csv. The
last stdout line is one JSON record with frames, elapsed seconds, scans/s
and, for synthetic sequences, the ATE.

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

PORTED_MODES = ("scan_to_scan",)


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
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)

    if args.mode not in PORTED_MODES:
        p.error(f"--mode {args.mode} is not ported to icp4dradar_tpu_torch yet; "
                f"use icp4dradar_tpu.models.run_odometry")
    if not args.dataset and not args.synthetic:
        p.error("provide --dataset or --synthetic F")
    if args.device == "cuda" and not torch.cuda.is_available():
        p.error("--device cuda: torch.cuda.is_available() is False "
                "(pass --device cpu to run on the CPU)")
    device = torch.device(args.device)

    from icp4dradar_tpu_torch.config import PipelineConfig
    from icp4dradar_tpu_torch.models.scan_to_scan import run_scan_to_scan
    from icp4dradar_tpu_torch.utils import (
        ate_rmse, write_result_csv, write_rt_txt, write_velocity_txt,
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

    t0 = time.perf_counter()
    outs = run_scan_to_scan(scans, cfg, use_doppler_prior=args.doppler_prior,
                            use_static_points_only=args.static_only)
    poses = outs.world_T.cpu().numpy()
    elapsed = time.perf_counter() - t0

    write_velocity_txt(os.path.join(args.out, "velocity.txt"),
                       outs.velocity.cpu().numpy())
    write_rt_txt(os.path.join(args.out, "icp.txt"),
                 outs.icp_transform.cpu().numpy())
    write_result_csv(
        os.path.join(args.out, "output_result.csv"),
        outs.icp_transform.cpu().numpy(), outs.fitness.cpu().numpy(),
        outs.sine_A.cpu().numpy(), outs.sine_b.cpu().numpy(),
    )
    rec = {"mode": args.mode, "device": str(device), "frames": F,
           "elapsed_s": elapsed, "scans_per_sec": F / elapsed}
    if gt_poses is not None:
        rec["ate_rmse_m"] = ate_rmse(poses[:, :3, 3], gt_poses[:, :3, 3])
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
