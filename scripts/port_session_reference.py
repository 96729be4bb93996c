#!/usr/bin/env python3
"""The JAX package's CPU run of the streaming-session cell that
`chip_smoke.py` drives on the PyTorch port: the first F frames of the bench
sequence (`bench.py:69-73`: 2048 points, 5000 landmarks, seed 0) through
`OdometrySession` with the default config (map capacity 2^18, submap
2^14): frames [0, warm) one `process` call each, then the rest in
`process_batch(block=8)` calls of 8 frames. Prints the ATE (align=False),
the GN sweeps, the lost frames and the seconds, one JSON line.

    JAX_PLATFORMS=cpu python scripts/port_session_reference.py [--frames 256] [--warm 8] \
        [--fallbacks]

The session draws its REVE uniforms from its own key (`key(cfg.seed)`,
split once a call), which the port's session reproduces with
`utils.threefry`; so the two runs see the same draws. The default run
(256 frames) took 942 s on an 8-core CPU and read ATE 0.03346 m.

`--fallbacks` also lists the batches whose blocked run falls back to the
sequential re-track (`fallback_batches`, by first frame): each batch runs
once more without the fallback on the same state and key, and a batch
whose poses differ fell back. The default run with it took 1690 s on the
same CPU and lists [48, 104, 120, 136, 184, 216].
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
    ap.add_argument("--warm", type=int, default=8)
    ap.add_argument("--block", type=int, default=8)
    ap.add_argument("--fallbacks", action="store_true")
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    from icp4dradar_tpu.config import PipelineConfig
    from icp4dradar_tpu.io import SyntheticSequence
    from icp4dradar_tpu.io.scan import stack_scans
    from icp4dradar_tpu.models.scan_to_map import run_scan_to_map_blocked
    from icp4dradar_tpu.models.streaming import OdometrySession
    from icp4dradar_tpu.utils import ate_rmse

    F, W, blk = args.frames, args.warm, args.block
    if (F - W) % blk:
        raise SystemExit(f"frames - warm must be a multiple of {blk}")
    cfg = PipelineConfig()
    seq = SyntheticSequence(num_frames=F, max_points=2048, num_landmarks=5000,
                            world_extent=120.0, max_range=80.0, dynamic_fraction=0.1,
                            speed=1.0, turn_rate=0.02, seed=0)
    scans = stack_scans([seq.scan(k) for k in range(F)])
    sess = OdometrySession(cfg)
    t0 = time.perf_counter()
    poses, sweeps, fitness = [], [], []
    for k in range(W):
        out = sess.process(jax.tree.map(lambda x: x[k], scans))
        poses.append(np.asarray(out.world_T)[None])
        sweeps.append(np.asarray(out.iterations)[None])
        fitness.append(np.asarray(out.fitness)[None])
    no_fallback = jax.jit(lambda st, sc, k: run_scan_to_map_blocked(
        sc, cfg, key=k, block=blk, init_state=st, sequential_fallback=False))
    fallback_batches = []
    for s in range(W, F, blk):
        batch = jax.tree.map(lambda x: x[s:s + blk], scans)
        if args.fallbacks:
            # the session's next subkey: key, sub = split(key)
            _, twin = no_fallback(sess.state, batch, jax.random.split(sess._key)[1])
        out = sess.process_batch(batch, block=blk)
        if args.fallbacks and not np.array_equal(np.asarray(out.world_T),
                                                 np.asarray(twin.world_T)):
            fallback_batches.append(s)
        poses.append(np.asarray(out.world_T))
        sweeps.append(np.asarray(out.iterations))
        fitness.append(np.asarray(out.fitness))
    poses, sweeps, fitness = (np.concatenate(x) for x in (poses, sweeps, fitness))
    res = {"frames": F, "warm": W, "block": blk,
           "ate_m": float(ate_rmse(poses[:, :3, 3], seq.poses[:F, :3, 3], align=False)),
           "sweeps": int(sweeps.sum()), "lost": int((fitness >= 1e6).sum()),
           "skipped": sess.skipped_frames, "seconds": time.perf_counter() - t0}
    if args.fallbacks:
        res["fallback_batches"] = fallback_batches
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
