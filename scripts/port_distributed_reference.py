#!/usr/bin/env python3
"""The JAX package's CPU run of the distributed scan-to-map path that
`chip_smoke.py` drives on the PyTorch port (its phase 16): the first F
frames of the bench sequence (`bench.py:69-73`: 1024 frames of 2048
points, 5000 landmarks, seed 0) through `run_scan_to_map_distributed(block=8,
use_const_velocity_rot=True)` with the default config (capacity 2^18,
submap 2^14) and key(cfg.seed), on a mesh of one CPU device (or of
`--devices` virtual ones). Prints the ATE (align=False, against the
sequence's poses), the GN iterations a frame, the submap counts and the
lost frames, one JSON line; the ATE is chip_smoke's DIST_ATE_JAX.

    JAX_PLATFORMS=cpu python scripts/port_distributed_reference.py [--frames 256] [--devices 2]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=256)
    ap.add_argument("--devices", type=int, default=1)
    args = ap.parse_args(argv)
    if args.devices > 1:
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                                   f" --xla_force_host_platform_device_count={args.devices}")

    import jax

    jax.config.update("jax_platforms", "cpu")
    from icp4dradar_tpu.config import PipelineConfig
    from icp4dradar_tpu.io import SyntheticSequence
    from icp4dradar_tpu.io.scan import stack_scans
    from icp4dradar_tpu.parallel import make_mesh, run_scan_to_map_distributed
    from icp4dradar_tpu.utils import ate_rmse

    F = args.frames
    cfg = PipelineConfig()
    # the bench sequence's first F frames (a sequence's last frame takes the
    # velocity of the pair before it: F frames of their own would differ there)
    seq = SyntheticSequence(num_frames=max(F, 1024), max_points=2048, num_landmarks=5000,
                            world_extent=120.0, max_range=80.0, dynamic_fraction=0.1,
                            speed=1.0, turn_rate=0.02, seed=0)
    scans = stack_scans([seq.scan(k) for k in range(F)])
    t0 = time.perf_counter()
    vm, out = run_scan_to_map_distributed(scans, make_mesh(args.devices), cfg, block=8,
                                          use_const_velocity_rot=True)
    poses = np.asarray(out["world_T"])
    sub = np.asarray(out["submap_points"])
    res = {"frames": F, "devices": args.devices,
           "ate_m": float(ate_rmse(poses[:, :3, 3], seq.poses[:F, :3, 3], align=False)),
           "iterations_per_frame": float(np.asarray(out["iterations"]).mean()),
           "iterations": int(np.asarray(out["iterations"]).sum()),
           "submap_min": int(sub[1:].min()), "submap_max": int(sub.max()),
           "submap_mean": float(sub.mean()), "voxels": int(vm.num_voxels),
           "lost": int((np.asarray(out["fitness"]) >= 1e6).sum()),
           "seconds": time.perf_counter() - t0}
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
