"""CLI entry point: run odometry over a .bin or PCD sequence directory, a
ROS1 bag, or a built-in synthetic sequence, and write reference-compatible
outputs (PyTorch port of `icp4dradar_tpu/models/run_odometry.py`).

    python -m icp4dradar_tpu_torch.models.run_odometry --mode scan_to_scan \
        --synthetic 200 --doppler-prior --device cuda --out /tmp/radar
    python -m icp4dradar_tpu_torch.models.run_odometry --mode scan_to_map \
        --synthetic 256 --map-interval 8 --cv-rot --device cuda --out /tmp/radar
    python -m icp4dradar_tpu_torch.models.run_odometry --mode scan_to_map \
        --bag run.bag --topic-radar /radar --topic-gt /gt --topic-imu /imu \
        --imu-prior --map-interval 8 --cv-rot --viz --steady-state --out /tmp/radar
    python -m icp4dradar_tpu_torch.models.run_odometry --mode scan_to_scan \
        --dataset seq --replay /tmp/radar/output_result.csv --out /tmp/replay
    python -m icp4dradar_tpu_torch.models.run_odometry --mode pose_graph \
        --front-end scan_to_map --structure-factors --synthetic 128 --out /tmp/radar
    python -m icp4dradar_tpu_torch.models.run_odometry --mode scan_to_map \
        --synthetic 256 --map-interval 8 --cv-rot --distributed 2 --out /tmp/radar

Inputs: `--dataset DIR` reads `DIR/data/radar_pointcloud_<k>.bin` (through
the native prefetching loader) or `DIR/pcd/%05d.pcd` (`--dataset-format`,
by default sniffed: PCD where `DIR/pcd/` exists); `--bag` reads a ROS1 bag's
radar, ground-truth and IMU topics (`io/bag_dataset.py`), and with
`--imu-prior` its gyro integrates into per-frame rotation priors
(`prior_deltas`) for the scan_to_map trackers.

Outputs, as the JAX CLI writes them: scan_to_scan writes velocity.txt,
icp.txt and output_result.csv (so does `--replay CSV`, which re-drives the
frame loop from a recorded output_result.csv without ICP); scan_to_map
writes velocity.txt and radar_odometry.txt; pose_graph writes
radar_odometry.txt (the refined poses), odometry_raw.txt (the front end's)
and a `pose_graph` metrics record (loop_closures, keyframes, cost); every
mode writes odom_tum.txt (TUM rows of the world poses), pcl_info.txt (the
raw point count of each frame) and metrics.jsonl (opened before the run,
ending in a `run_complete` record), with `--local-map` icp_map.txt (the
window ICP corrections of `models/local_map.py`, one row per pair of
consecutive 15-frame windows), and with `--viz` viewer.html (the track,
the ground truth and, in scan_to_map, the map) and, in scan_to_map,
map.ply (the map's occupied voxels). `--steady-state` runs the pipeline a
second time and adds steady_s, steady_scans_per_sec and compile_overhead_s
(on the card: the first run's kernel load and CUDA warm-up) to the record.
The last stdout line is one JSON record with the mode, the device, frames,
elapsed seconds, scans/s and, where ground truth exists, the ATE.

`--distributed N` (scan_to_map only) runs the distributed pipeline
(`parallel/distributed_pipeline.py`: the map sharded over N ranks, ring
VGICP) on N spawned ranks, NCCL under `--device cuda` (one card a rank;
fewer than N cards is a usage error) and gloo under `--device cpu`; it
honours --imu-prior, --map-interval and --cv-rot, and writes
velocity.txt, radar_odometry.txt and, with --viz, map.ply of the gathered
map, from rank 0's results.

`--device cuda` (the default) needs a CUDA device and never falls back to
the CPU; `--device cpu` runs the plain PyTorch versions of the kernels.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch


def build_scans(args, device):
    """(scans on `device`, GT poses (F, 4, 4) numpy or None, IMU prior
    deltas (F, 4, 4) numpy or None)."""
    from icp4dradar_tpu_torch.io import (
        BinSequenceDataset, PcdSequenceDataset, RadarBagDataset, SyntheticSequence,
    )
    from icp4dradar_tpu_torch.io.scan import stack_scans

    if args.bag:
        ds = RadarBagDataset(args.bag, args.topic_radar, args.topic_gt, args.topic_imu,
                             max_points=args.max_points)
        if len(ds) == 0:
            raise SystemExit(f"no {args.topic_radar} messages in {args.bag}")
        prior_deltas = None
        if args.imu_prior:
            from icp4dradar_tpu_torch.preprocess import imu_prior_deltas

            prior_deltas = imu_prior_deltas(ds.frames)
        return ds.stacked_scans(device), ds.gt_poses(), prior_deltas
    if args.dataset:
        fmt = args.dataset_format
        if fmt == "auto":
            # reference layout sniff: USE_PCD_FILES reads <folder>/pcd/%05d.pcd
            # (src/iterative_closest_point.cpp:269-299), USE_BIN_FILES reads
            # <folder>/data/*.bin
            fmt = "pcd" if os.path.isdir(os.path.join(args.dataset, "pcd")) else "bin"
        if fmt == "pcd":
            ds = PcdSequenceDataset(args.dataset, max_points=args.max_points)
        else:
            ds = BinSequenceDataset(args.dataset, max_points=args.max_points)
        if len(ds) == 0:
            raise SystemExit(f"no {fmt} frames under {args.dataset}")
        return stack_scans([ds[k] for k in range(len(ds))]).to(device), None, None
    seq = SyntheticSequence(
        num_frames=args.synthetic, max_points=args.max_points,
        num_landmarks=args.landmarks, seed=args.seed,
    )
    scans = stack_scans([seq.scan(k) for k in range(len(seq))]).to(device)
    return scans, seq.poses, None


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--mode", choices=["scan_to_scan", "scan_to_map", "pose_graph"],
                   default="scan_to_scan")
    p.add_argument("--dataset", help=".bin sequence directory (data/radar_pointcloud_k.bin)")
    p.add_argument("--dataset-format", default="auto", choices=["auto", "bin", "pcd"],
                   help="--dataset layout: 'bin' (data/*.bin, ref USE_BIN_FILES), "
                        "'pcd' (pcd/%%05d.pcd, ref USE_PCD_FILES), 'auto' sniffs "
                        "<folder>/pcd/")
    p.add_argument("--replay", metavar="CSV",
                   help="re-drive the frame loop from a recorded output_result.csv "
                        "(transforms composed, ICP skipped — ref USE_ICP_RESULT); "
                        "scan_to_scan mode")
    p.add_argument("--bag", help="ROS1 rosbag path (reference radar_odometry input)")
    p.add_argument("--topic-radar", default="/radar_scan")
    p.add_argument("--topic-gt", default=None)
    p.add_argument("--topic-imu", default=None)
    p.add_argument("--imu-prior", action="store_true",
                   help="integrate the bag's IMU gyro into per-frame rotation priors "
                        "(scan_to_map)")
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
    p.add_argument("--viz", action="store_true",
                   help="export viewer.html and, in scan_to_map, map.ply (rviz "
                        "replacement)")
    p.add_argument("--steady-state", action="store_true",
                   help="run the pipeline a second time and report its scans/s "
                        "apart from the first run's (kernel load, CUDA warm-up)")
    p.add_argument("--distributed", type=int, default=0, metavar="N",
                   help="scan_to_map: run the end-to-end pipeline with the map "
                        "sharded over N ranks (parallel/distributed_pipeline.py); "
                        "honours --imu-prior, --map-interval and --cv-rot")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)

    if args.distributed and args.mode != "scan_to_map":
        p.error("--distributed requires --mode scan_to_map")
    if not args.dataset and not args.synthetic and not args.bag:
        p.error("provide --dataset, --bag, or --synthetic F")
    if args.replay and args.mode != "scan_to_scan":
        p.error("--replay runs in --mode scan_to_scan")
    for opt, path in (("--bag", args.bag), ("--replay", args.replay)):
        if path and not os.path.isfile(path):
            p.error(f"{opt}: no such file: {path}")
    if args.device == "cuda" and not torch.cuda.is_available():
        p.error("--device cuda: torch.cuda.is_available() is False "
                "(pass --device cpu to run on the CPU)")
    if args.distributed and args.device == "cuda" and \
            torch.cuda.device_count() < args.distributed:
        p.error(f"--distributed {args.distributed} --device cuda needs {args.distributed} "
                f"CUDA devices (one a rank), this machine has {torch.cuda.device_count()}")
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

    # under --distributed the ranks place the scans on their own devices:
    # this process stays off the cards (no CUDA context beside rank 0's)
    host = torch.device("cpu") if args.distributed else device
    scans, gt_poses, prior_deltas = build_scans(args, host)
    F = scans.xyz.shape[0]
    if prior_deltas is not None:
        prior_deltas = torch.from_numpy(prior_deltas).to(host)
    replay = None
    if args.replay:
        from icp4dradar_tpu_torch.utils import read_result_csv

        _, T_rec, scores, _, _ = read_result_csv(args.replay)
        if len(T_rec) != F:
            p.error(f"--replay has {len(T_rec)} rows but the sequence has {F} frames")
        replay = (T_rec, scores)
    os.makedirs(args.out, exist_ok=True)
    with MetricsLogger(os.path.join(args.out, "metrics.jsonl")) as log:
        poses, elapsed, state, steady_run = run_mode(args, cfg, scans, log, prior_deltas,
                                                     replay)
        if args.local_map:
            from icp4dradar_tpu_torch.models.local_map import local_map_refinement

            T_map = local_map_refinement(scans.xyz.cpu().numpy(), scans.mask.cpu().numpy(),
                                         poses, cfg=cfg.icp, device=device)
            write_rt_txt(os.path.join(args.out, "icp_map.txt"), T_map)
        write_tum(os.path.join(args.out, "odom_tum.txt"), poses)
        write_pcl_info(os.path.join(args.out, "pcl_info.txt"),
                       scans.mask.sum(dim=-1).cpu().numpy())
        if args.viz:
            write_viz(args, poses, gt_poses, state)
        rec = {"frames": F, "elapsed_s": round(elapsed, 3),
               "scans_per_sec": round(F / elapsed, 2)}
        if args.steady_state:
            # the first run paid the kernel build/load and CUDA warm-up; a
            # second pass is the rate a long-running process sustains
            steady = steady_run()
            rec["steady_s"] = round(steady, 3)
            rec["steady_scans_per_sec"] = round(F / steady, 2)
            rec["compile_overhead_s"] = round(elapsed - steady, 3)
        if gt_poses is not None:
            rec["ate_rmse_m"] = round(ate_rmse(poses[:, :3, 3], gt_poses[:, :3, 3]), 4)
        log.log("run_complete", mode=args.mode, **rec)
    print(json.dumps({"mode": args.mode, "device": str(device), **rec}))
    return 0


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(run, device):
    """(run(), its seconds), the device synchronized before and after."""
    _sync(device)
    t0 = time.perf_counter()
    res = run()
    _sync(device)
    return res, time.perf_counter() - t0


def _distributed_rank(inp: dict) -> dict:
    """One rank of `--distributed`: the distributed pipeline over the CLI's
    scans (numpy in, numpy out), timed on the rank's device, `runs` times;
    rank 0's gathered map comes back for --viz."""
    import torch.distributed as dist

    from icp4dradar_tpu_torch.config import PipelineConfig
    from icp4dradar_tpu_torch.interop import scans_from_numpy
    from icp4dradar_tpu_torch.parallel import make_mesh, run_scan_to_map_distributed
    from icp4dradar_tpu_torch.parallel.mesh import mesh_device

    mesh = make_mesh(device_type=inp["device"])
    dev = mesh_device(mesh)
    scans = scans_from_numpy(inp["scans"], device=dev)
    cfg = PipelineConfig.from_dict(inp["cfg"])
    priors = None if inp["priors"] is None else torch.from_numpy(inp["priors"]).to(dev)
    secs = []
    for _ in range(inp["runs"]):
        (vm, outs), s = _timed(lambda: run_scan_to_map_distributed(
            scans, mesh, cfg, block=inp["block"], use_doppler_prior=inp["doppler"],
            use_const_velocity_rot=inp["cv_rot"], priors=priors), dev)
        secs.append(s)
    table = vm.gather() if inp["viz"] else None
    if dist.get_rank() != 0:
        return {}
    return {"outs": {k: v.cpu().numpy() for k, v in outs.items()}, "secs": secs,
            "map": None if table is None else {k: getattr(table, k).cpu().numpy()
                                               for k in ("points", "intensity", "occupied")}}


def _run_distributed(args, cfg, scans, prior_deltas):
    """`--distributed N`: the pipeline on N spawned ranks (NCCL on the
    cards, gloo on the CPU); rank 0's outputs are written here."""
    from types import SimpleNamespace

    from icp4dradar_tpu_torch.interop import SCAN_FIELDS
    from icp4dradar_tpu_torch.parallel.dryrun import run_on_ranks
    from icp4dradar_tpu_torch.utils import export_map_ply, write_rt_txt, write_velocity_txt

    runs = 2 if args.steady_state else 1
    inp = {"scans": {k: getattr(scans, k).cpu().numpy() for k in SCAN_FIELDS},
           "cfg": cfg.to_dict(), "device": args.device, "block": args.map_interval,
           "doppler": not args.static_only or args.doppler_prior, "cv_rot": args.cv_rot,
           "priors": None if prior_deltas is None else prior_deltas.cpu().numpy(),
           "runs": runs, "viz": args.viz}
    res = run_on_ranks(_distributed_rank, args.distributed, inp,
                       backend="nccl" if args.device == "cuda" else "gloo")[0]
    outs = res["outs"]
    poses = outs["world_T"]
    write_velocity_txt(os.path.join(args.out, "velocity.txt"), outs["velocity"])
    write_rt_txt(os.path.join(args.out, "radar_odometry.txt"), poses)
    if args.viz:
        m = {k: torch.from_numpy(v) for k, v in res["map"].items()}
        n_vox = export_map_ply(os.path.join(args.out, "map.ply"), SimpleNamespace(**m))
        print(f"map.ply: {n_vox} voxels", flush=True)
    return poses, res["secs"][0], None, lambda: res["secs"][-1]


def write_viz(args, poses, gt_poses, state):
    """viewer.html (track, ground truth, the map's points) and, with a
    scan_to_map state, map.ply."""
    from icp4dradar_tpu_torch.utils import export_map_ply, write_html_viewer

    map_pts = None
    if state is not None:
        n_vox = export_map_ply(os.path.join(args.out, "map.ply"), state.vmap)
        map_pts = state.vmap.points.cpu().numpy()[state.vmap.occupied.cpu().numpy() > 0.5]
        print(f"map.ply: {n_vox} voxels", flush=True)
    write_html_viewer(
        os.path.join(args.out, "viewer.html"), poses[:, :3, 3],
        gt_positions=gt_poses[:, :3, 3] if gt_poses is not None else None,
        map_points=map_pts, title=f"{args.mode} odometry",
    )


def run_mode(args, cfg, scans, log, prior_deltas=None, replay=None):
    """Runs `args.mode` over the scans and writes the mode's own output
    files (and, for pose_graph, its metrics record) -> (world poses
    (F, 4, 4) numpy, seconds of the run, the scan_to_map state or None, a
    function that returns the seconds of a second run). `replay`:
    (transforms, scores) of a recorded output_result.csv."""
    from icp4dradar_tpu_torch.models.scan_to_map import (
        run_scan_to_map, run_scan_to_map_blocked,
    )
    from icp4dradar_tpu_torch.models.scan_to_scan import (
        run_scan_to_scan, run_scan_to_scan_replay,
    )
    from icp4dradar_tpu_torch.utils import write_result_csv, write_rt_txt, write_velocity_txt

    if args.distributed:
        return _run_distributed(args, cfg, scans, prior_deltas)
    if args.mode == "pose_graph":
        from icp4dradar_tpu_torch.models.pose_graph_odometry import run_pose_graph_odometry

        def run():
            return run_pose_graph_odometry(scans, cfg, front_end=args.front_end,
                                           structure_factors=args.structure_factors)
    elif replay is not None:
        def run():
            return run_scan_to_scan_replay(scans, replay[0], cfg, recorded_fitness=replay[1])
    elif args.mode == "scan_to_scan":
        def run():
            return run_scan_to_scan(scans, cfg, use_doppler_prior=args.doppler_prior,
                                    use_static_points_only=args.static_only)
    else:
        # as the JAX CLI: the Doppler prior is on unless --static-only
        use_prior = not args.static_only or args.doppler_prior
        if args.map_interval > 1:
            def run():
                return run_scan_to_map_blocked(
                    scans, cfg, block=args.map_interval, use_doppler_prior=use_prior,
                    prior_deltas=prior_deltas, use_const_velocity_rot=args.cv_rot,
                    parallel_frames=not args.sequential_blocks)
        else:
            def run():
                return run_scan_to_map(scans, cfg, use_doppler_prior=use_prior,
                                       prior_deltas=prior_deltas,
                                       use_const_velocity_rot=args.cv_rot)

    res, elapsed = _timed(run, scans.device)

    def steady_run():
        return _timed(run, scans.device)[1]

    state = None
    if args.mode == "pose_graph":
        write_rt_txt(os.path.join(args.out, "radar_odometry.txt"), res.poses)
        write_rt_txt(os.path.join(args.out, "odometry_raw.txt"), res.odom_poses)
        log.log("pose_graph", loop_closures=res.num_loop_closures,
                keyframes=int(len(res.keyframe_indices)), cost=res.cost)
        return res.poses, elapsed, state, steady_run
    if args.mode == "scan_to_scan":
        outs = res
        write_rt_txt(os.path.join(args.out, "icp.txt"), outs.icp_transform.cpu().numpy())
        write_result_csv(
            os.path.join(args.out, "output_result.csv"),
            outs.icp_transform.cpu().numpy(), outs.fitness.cpu().numpy(),
            outs.sine_A.cpu().numpy(), outs.sine_b.cpu().numpy(),
        )
    else:
        state, outs = res
        write_rt_txt(os.path.join(args.out, "radar_odometry.txt"), outs.world_T.cpu().numpy())
    write_velocity_txt(os.path.join(args.out, "velocity.txt"), outs.velocity.cpu().numpy())
    return outs.world_T.cpu().numpy(), elapsed, state, steady_run


if __name__ == "__main__":
    raise SystemExit(main())
