#!/usr/bin/env python3
"""Does the port round alike on two hosts? Runs the port's side of six
CPU parity cases (the closed-form 3x3 eigenvalues and condition numbers of
`tests/test_torch_geom.py`, the blocked tracker, mapping on ground truth
alone and in a batch, and the blocked batch on two scenes, as
`tests/test_torch_scan_to_map.py` and `tests/test_torch_batch.py` build
them, on the JAX package's REVE draws made in numpy) on the CPU with one
torch thread, and saves every output as npz; with `--against` it compares
this host's outputs with a file saved on another host.

    python scripts/port_host_rounding.py --save host_a.npz
    python scripts/port_host_rounding.py --against host_a.npz [--save host_b.npz]

Prints one line per output (equal, or the elements that differ and the
largest difference) and, last, one JSON line: the outputs compared and the
ones that differ. Imports no jax.
"""

import argparse
import json
import os
import platform
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

F, N, B = 24, 512, 2
SMALL = {"voxel_map.capacity": 1 << 14, "voxel_map.submap_max_points": 1 << 12,
         "icp.max_iterations": 15, "gicp.max_iterations": 15}
SEQ_KW = dict(max_points=N, num_landmarks=4000, world_extent=80.0, max_range=60.0,
              dynamic_fraction=0.05, pos_noise=0.01, speed=1.0, turn_rate=0.03)


def _outputs(prefix, state, out, res, stream=None):
    for f in ("world_T", "iterations", "fitness", "insert_mask"):
        res[f"{prefix}/{f}"] = getattr(out, f).numpy()
    vmap = state.vmap
    for k, t in zip(("keys", "points", "intensity", "occupied", "stat_n", "stat_sum",
                     "stat_sq"), vmap.tables()):
        res[f"{prefix}/map_{k}"] = t.numpy()


def run_cases() -> dict:
    import torch

    from icp4dradar_tpu_torch import geom as pg
    from icp4dradar_tpu_torch.config import PipelineConfig
    from icp4dradar_tpu_torch.io import SyntheticSequence
    from icp4dradar_tpu_torch.io.scan import stack_scans
    from icp4dradar_tpu_torch.models import scan_to_map as pm
    from icp4dradar_tpu_torch.preprocess.reve import reve_hypotheses
    from icp4dradar_tpu_torch.utils import reve_batch_uniforms, reve_uniforms

    torch.set_num_threads(1)
    res = {}
    # the 3x3 eigenvalues of tests/test_torch_geom.py
    rng = np.random.default_rng(6)
    J = rng.normal(size=(32, 12, 6)).astype(np.float32)
    A = (J[:, :3, :3].transpose(0, 2, 1) @ J[:, :3, :3]).astype(np.float32)
    A[0] = np.diag([2.0, 2.0, 2.0])
    At = torch.tensor(A)
    res["geom/eigvals"] = pg.sym3x3_eigvals(At).numpy()
    res["geom/condition"] = pg.condition_number(At).numpy()
    q = (At[..., 0, 0] + At[..., 1, 1] + At[..., 2, 2]) / 3.0
    Bm = At - q[..., None, None] * torch.eye(3)
    res["geom/p2"] = (torch.sum(Bm * Bm, dim=(-2, -1)) / 6.0).numpy()

    cfg = PipelineConfig().override(**SMALL)
    H = reve_hypotheses(cfg.reve)
    seq = SyntheticSequence(num_frames=F, seed=0, **SEQ_KW)
    scans = stack_scans([seq.scan(k) for k in range(F)])
    st, out = pm.run_scan_to_map_blocked(scans, cfg, uniforms=torch.from_numpy(
        reve_uniforms(cfg.seed, F, 8, H)), block=8, use_const_velocity_rot=True)
    _outputs("blocked", st, out, res)

    n = 10
    G = torch.tensor(seq.poses[:n].astype(np.float32))
    st, out = pm.run_scan_to_map(scans[:n], cfg, uniforms=torch.from_numpy(
        reve_uniforms(cfg.seed, n, 0, H)), gt_poses=G, insert_before_registration=True,
        use_const_velocity_rot=True)
    _outputs("ground_truth", st, out, res)

    # the batch on ground truth: B windows of 6 frames, one shared track
    n = 6
    bsc = scans[:B * n].__class__(**{k: getattr(scans[:B * n], k).reshape(
        (B, n) + getattr(scans, k).shape[1:]) for k in ("xyz", "doppler", "intensity",
                                                       "mask", "time")})
    st, out = pm.run_scan_to_map_batch(
        bsc, cfg, uniforms=torch.from_numpy(reve_batch_uniforms(cfg.seed, B, n, 0, H)),
        gt_poses=torch.tensor(seq.poses[:n].astype(np.float32)),
        insert_before_registration=True)
    _outputs("batch_ground_truth", st, out, res)

    # the blocked batch: windows of one sequence, and sequences of their own
    wseq = SyntheticSequence(num_frames=B * F, seed=0, **SEQ_KW)
    for scene, parts in (("windows", [(wseq, b * F) for b in range(B)]),
                         ("sequences", [(SyntheticSequence(num_frames=F, seed=b, **SEQ_KW), 0)
                                        for b in range(B)])):
        per = [stack_scans([s.scan(k) for k in range(k0, k0 + F)]) for s, k0 in parts]
        bsc = per[0].__class__(**{k: torch.stack([getattr(p, k) for p in per])
                                  for k in ("xyz", "doppler", "intensity", "mask", "time")})
        st, out = pm.run_scan_to_map_batch(
            bsc, cfg, uniforms=torch.from_numpy(reve_batch_uniforms(cfg.seed, B, F, 8, H)),
            block=8, use_const_velocity_rot=True)
        _outputs(f"batch_{scene}", st, out, res)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--save", help="write this host's outputs here (npz)")
    ap.add_argument("--against", help="compare this host's outputs with this npz")
    args = ap.parse_args(argv)
    import torch

    print(f"host {platform.machine()} {platform.processor() or ''} torch {torch.__version__} "
          f"threads 1", flush=True)
    res = run_cases()
    if args.save:
        np.savez_compressed(args.save, **res)
    differ = []
    if args.against:
        ref = np.load(args.against)
        for k in sorted(res):
            a, b = res[k], ref[k]
            d = a != b
            if d.any():
                differ.append(k)
                print(f"{k}: {int(d.sum())} of {d.size} differ, largest "
                      f"{float(np.abs(a.astype(np.float64) - b).max()):.6e}")
            else:
                print(f"{k}: equal")
    print(json.dumps({"outputs": len(res), "differ": differ}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
