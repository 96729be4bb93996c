#!/usr/bin/env python3
"""The JAX package's CPU runs of the sparse-vendor tracking paths that
`chip_smoke.py`'s `[accumulate]` phase drives on the PyTorch port, at the
s2m cell's full width (2048 points, map capacity 2^18, submap 2^14), with
key(cfg.seed):

- `window`: the bench sequence's first 64 frames (`bench.py:69-73`)
  through `run_scan_to_map` with `accumulate_scans=4` (VGICP);
- `knn`: its first 16 frames with `gicp.use_vgicp=False` and
  `accumulate_scans=2`;
- `union`: its first 256 frames (the s2m cell) through
  `run_scan_to_map_blocked(block=8, use_const_velocity_rot=True,
  rigid_union=True)`;
- `ti_window`, `ti_union`: the eval suite's ti_mmwave sequence
  (`scripts/eval_suite.py:154-160`: 64 frames, matched covariances)
  through the `window` and `union` runs.

Prints one JSON line a run: the ATE (align=False; for the union also over
its first 64 frames, the part chip_smoke holds), the GN iterations a
frame and in all, the lost frames (fitness >= 1e6), the map's voxels and
the seconds; the ATEs are chip_smoke's ACC_ATE_JAX.

    JAX_PLATFORMS=cpu python scripts/port_accumulate_reference.py [--runs window,knn,...]
        [--poses poses.npz]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

RUNS = ("window", "knn", "union", "ti_window", "ti_union")
# the eval suite's matched covariances for the ti_mmwave profile
TI_COV = {"gicp.sigma_azimuth": 0.0175, "gicp.sigma_elevation": 0.0175,
          "gicp.sigma_range": 0.12}


def bench_sequence(frames_module):
    """The bench sequence (1024 frames of 2048 points; a sequence's last
    frame takes the velocity of the pair before it, so the first F frames
    come from the 1024-frame sequence)."""
    return frames_module(num_frames=1024, max_points=2048, num_landmarks=5000,
                         world_extent=120.0, max_range=80.0, dynamic_fraction=0.1,
                         speed=1.0, turn_rate=0.02, seed=0)


def ti_sequence(frames_module, frames=64):
    return frames_module(num_frames=frames, max_points=2048, num_landmarks=8000,
                         world_extent=150.0, max_range=80.0, seed=0, speed=1.0,
                         turn_rate=0.03, dynamic_fraction=0.1, pos_noise=0.02,
                         vendor_profile="ti_mmwave")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", default=",".join(RUNS))
    ap.add_argument("--poses", help="also write each run's (F, 4, 4) poses to this npz")
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    from icp4dradar_tpu.config import PipelineConfig
    from icp4dradar_tpu.io import SyntheticSequence
    from icp4dradar_tpu.io.scan import stack_scans
    from icp4dradar_tpu.models import run_scan_to_map, run_scan_to_map_blocked
    from icp4dradar_tpu.utils import ate_rmse

    base = PipelineConfig()
    bench = ti = None
    poses = {}
    for name in args.runs.split(","):
        if name.startswith("ti_"):
            ti = ti or ti_sequence(SyntheticSequence)
            seq, F, cfg = ti, 64, base.override(**TI_COV)
        else:
            bench = bench or bench_sequence(SyntheticSequence)
            seq, F, cfg = bench, {"window": 64, "knn": 16, "union": 256}[name], base
        scans = stack_scans([seq.scan(k) for k in range(F)])
        t0 = time.perf_counter()
        if name.endswith("union"):
            state, out = run_scan_to_map_blocked(scans, cfg, block=8,
                                                 use_const_velocity_rot=True, rigid_union=True)
        elif name == "knn":
            state, out = run_scan_to_map(scans, cfg.override(**{
                "gicp.use_vgicp": False, "accumulate_scans": 2}))
        else:
            state, out = run_scan_to_map(scans, cfg.override(accumulate_scans=4))
        P = np.asarray(out.world_T)
        poses[name] = P
        its = np.asarray(out.iterations)
        gt = np.asarray(seq.poses[:F, :3, 3])
        held = {}
        if name == "union":
            # the union is chaotic after its first blocks: chip_smoke holds
            # the ATE of its first 64 frames
            held["ate_first_64_m"] = float(ate_rmse(P[:64, :3, 3], gt[:64], align=False))
        print(json.dumps({
            "run": name, "frames": F,
            "ate_m": float(ate_rmse(P[:, :3, 3], gt, align=False)), **held,
            "iterations_per_frame": float(its.mean()), "iterations": int(its.sum()),
            "lost": int((np.asarray(out.fitness) >= 1e6).sum()),
            "finite": bool(np.isfinite(P).all()), "voxels": int(state.vmap.num_voxels),
            "points_per_scan": float(np.asarray(scans.mask).sum(axis=1).mean()),
            "seconds": time.perf_counter() - t0}), flush=True)
    if args.poses:
        np.savez_compressed(args.poses, **poses)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
