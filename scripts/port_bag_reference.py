#!/usr/bin/env python3
"""The JAX package's CPU run of the bag path that `chip_smoke.py` drives on
the PyTorch port (its host phase): the first F frames of the bench
sequence (`bench.py:69-73`: 2048 points, 5000 landmarks, seed 0) written
as a ROS1 bag by `write_synthetic_bag` (ColoRadar fields, GT and IMU
topics, no compression), read back by `RadarBagDataset`, the IMU batches
turned into rotation priors by `imu_prior_deltas`, and tracked by
`run_scan_to_map_blocked(block=8, use_const_velocity_rot=True,
prior_deltas=...)` with the default config and key(cfg.seed). Prints the
ATE (align=False, against the sequence's poses), the GN sweeps and the
lost frames, one JSON line; the ATE is chip_smoke's BAG_ATE_JAX.

    JAX_PLATFORMS=cpu python scripts/port_bag_reference.py [--frames 256]
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=256)
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    from icp4dradar_tpu.config import PipelineConfig
    from icp4dradar_tpu.io import RadarBagDataset, SyntheticSequence, write_synthetic_bag
    from icp4dradar_tpu.models.scan_to_map import run_scan_to_map_blocked
    from icp4dradar_tpu.preprocess import imu_prior_deltas
    from icp4dradar_tpu.utils import ate_rmse

    F = args.frames
    cfg = PipelineConfig()
    seq = SyntheticSequence(num_frames=F, max_points=2048, num_landmarks=5000,
                            world_extent=120.0, max_range=80.0, dynamic_fraction=0.1,
                            speed=1.0, turn_rate=0.02, seed=0)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "bench.bag")
        write_synthetic_bag(path, seq)
        ds = RadarBagDataset(path, "/radar", "/gt", "/imu", max_points=2048)
    priors = imu_prior_deltas(ds.frames)
    t0 = time.perf_counter()
    _, out = run_scan_to_map_blocked(ds.stacked_scans(), cfg, block=8,
                                     use_const_velocity_rot=True, prior_deltas=priors)
    poses = np.asarray(out.world_T)
    res = {"frames": F,
           "ate_m": float(ate_rmse(poses[:, :3, 3], seq.poses[:, :3, 3], align=False)),
           "sweeps": int(np.asarray(out.iterations).sum()),
           "lost": int((np.asarray(out.fitness) >= 1e6).sum()),
           "seconds": time.perf_counter() - t0}
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
