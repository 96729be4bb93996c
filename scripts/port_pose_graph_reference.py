#!/usr/bin/env python3
"""The JAX package's CPU run of the pose-graph cell that `chip_smoke.py`
drives on the PyTorch port (phase 4c): the figure-eight of
`scripts/eval_suite.py` (F frames x 2048 points, 6000 landmarks, world
extent 140, max range 80, seed 0, speed 2.0, dynamic fraction 0.1, pos
noise 0.03; a turn of +2 pi/64 a frame for the first half, -2 pi/64 for
the second) through `run_pose_graph_odometry(keyframe_every=4,
loop_radius=8.0, min_loop_gap=20, max_loop_candidates=24)` with the
default config:

- the scan-to-scan front end (s2s);
- the same with a fabricated closure between keyframes 2 and K-4, 10 m
  off, weight 10 (`eval_suite.py`'s wrong-closure row);
- the scan-to-map front end with structure factors (the CLI's full stack).

Prints one JSON line: per run the odometry and refined ATE (align=False),
the accepted closures, the keyframes and the seconds.

    JAX_PLATFORMS=cpu python scripts/port_pose_graph_reference.py [--frames 128]

The front ends draw their RANSAC uniforms from `key(cfg.seed)`; the port's
`run_pose_graph_odometry` takes the same draws from `utils.threefry`
(`doppler_uniforms`, `reve_uniforms`), so both runs see the same draws.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def figure_eight(frames: int):
    """The figure-eight's constructor arguments (either package's
    SyntheticSequence takes them)."""
    w8 = 2 * 3.14159265 / 64.0
    half = frames // 2
    schedule = np.concatenate([np.full(half, w8), np.full(frames - half, -w8)])
    return dict(num_frames=frames, max_points=2048, num_landmarks=6000,
                world_extent=140.0, max_range=80.0, seed=0, speed=2.0,
                dynamic_fraction=0.1, pos_noise=0.03, turn_schedule=schedule)


PG_ARGS = dict(keyframe_every=4, loop_radius=8.0, min_loop_gap=20, max_loop_candidates=24)
WRONG_OFFSET_M, WRONG_WEIGHT = 10.0, 10.0


def wrong_closure(kf_odom: np.ndarray):
    """The fabricated closure of `eval_suite.py`: keyframe 2 to K-4, the
    odometry's relative transform moved 10 m along x."""
    K = len(kf_odom)
    T = np.linalg.inv(kf_odom[2]) @ kf_odom[K - 4]
    T[:3, 3] += np.asarray([WRONG_OFFSET_M, 0.0, 0.0])
    return [(2, K - 4, T, WRONG_WEIGHT)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=128)
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    from icp4dradar_tpu.config import PipelineConfig
    from icp4dradar_tpu.io import SyntheticSequence
    from icp4dradar_tpu.io.scan import stack_scans
    from icp4dradar_tpu.models import run_pose_graph_odometry
    from icp4dradar_tpu.utils import ate_rmse

    F = args.frames
    seq = SyntheticSequence(**figure_eight(F))
    scans = stack_scans([seq.scan(k) for k in range(F)])
    gt = seq.poses[:F, :3, 3]
    cfg = PipelineConfig()

    def row(res, t0):
        return {"odom_ate_m": float(ate_rmse(res.odom_poses[:, :3, 3], gt, align=False)),
                "refined_ate_m": float(ate_rmse(res.poses[:, :3, 3], gt, align=False)),
                "loop_closures": int(res.num_loop_closures),
                "keyframes": int(len(res.keyframe_indices)),
                "seconds": time.perf_counter() - t0}

    out = {"frames": F}
    t0 = time.perf_counter()
    clean = run_pose_graph_odometry(scans, cfg, **PG_ARGS)
    out["s2s"] = row(clean, t0)
    t0 = time.perf_counter()
    inj = run_pose_graph_odometry(
        scans, cfg, **PG_ARGS,
        inject_loop_factors=wrong_closure(clean.odom_poses[clean.keyframe_indices]))
    out["s2s_wrong_closure"] = row(inj, t0)
    t0 = time.perf_counter()
    full = run_pose_graph_odometry(scans, cfg, **PG_ARGS, front_end="scan_to_map",
                                   structure_factors=True)
    out["s2m_structure"] = row(full, t0)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
