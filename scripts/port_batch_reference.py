#!/usr/bin/env python3
"""The JAX package's CPU run of the B-stream serving cell that
`chip_smoke.py` drives on the PyTorch port: B streams of F frames, stream b
being frames [F*b, F*b + F) of the bench sequence (`bench.py:69-73`: 2048
points, 5000 landmarks, seed 0), tracked by `run_scan_to_map_batch(block=8,
use_const_velocity_rot=True)` with the default config (map capacity 2^18).
Prints each stream's ATE (align=False) against its ground truth re-anchored
at the stream's first frame, the GN sweeps and the lost frames, one JSON
line.

    JAX_PLATFORMS=cpu python scripts/port_batch_reference.py [--streams 4] [--frames 256]

Each stream runs alone through `run_scan_to_map_blocked` with its key of
`jax.random.split(key(seed), B)` and `sequential_fallback=False`: the
function that `run_scan_to_map_batch` maps over the streams, one stream at
a time, which bounds the memory of the CPU run (4 x 256 frames took 2,525
s on an 8-core CPU).
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
    ap.add_argument("--streams", type=int, default=4)
    ap.add_argument("--frames", type=int, default=256)
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    from icp4dradar_tpu.config import PipelineConfig
    from icp4dradar_tpu.io import SyntheticSequence
    from icp4dradar_tpu.io.scan import stack_scans
    from icp4dradar_tpu.models.scan_to_map import run_scan_to_map_blocked
    from icp4dradar_tpu.utils import ate_rmse

    B, F = args.streams, args.frames
    cfg = PipelineConfig()
    seq = SyntheticSequence(num_frames=B * F, max_points=2048, num_landmarks=5000,
                            world_extent=120.0, max_range=80.0, dynamic_fraction=0.1,
                            speed=1.0, turn_rate=0.02, seed=0)
    streams = [stack_scans([seq.scan(k) for k in range(b * F, b * F + F)]) for b in range(B)]
    keys = jax.random.split(jax.random.key(cfg.seed), B)
    t0 = time.perf_counter()
    outs = [run_scan_to_map_blocked(streams[b], cfg, key=keys[b], block=8,
                                    use_const_velocity_rot=True, sequential_fallback=False)[1]
            for b in range(B)]
    res = {"streams": B, "frames": F, "ate_m": [], "sweeps": [], "lost": []}
    for b, o in enumerate(outs):
        poses = np.asarray(o.world_T)
        gt = np.linalg.inv(seq.poses[b * F]) @ seq.poses[b * F:b * F + F]
        res["ate_m"].append(float(ate_rmse(poses[:, :3, 3], gt[:, :3, 3], align=False)))
        res["sweeps"].append(int(np.asarray(o.iterations).sum()))
        res["lost"].append(int((np.asarray(o.fitness) >= 1e6).sum()))
    res["seconds"] = time.perf_counter() - t0
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
