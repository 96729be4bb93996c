"""The port's CLI output files against the JAX CLI's: the TUM and point-count
writers byte for byte on the same poses and counts, the JSONL metrics
logger's records, and one scan_to_scan and one pose_graph run of each CLI
on the CPU compared file for file (and the port's pose_graph mode with the
scan-to-map front end and structure factors).

The two CLIs' poses agree only to the port's parity tolerance (the JAX CPU
path searches with expanded distances), so their pose files are held to
the same names and row counts; `pcl_info.txt` depends on the scans alone
and is identical, and `metrics.jsonl` has the same events with the same
keys (timings differ)."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest

from icp4dradar_tpu.geom import se3_exp
from icp4dradar_tpu.models import run_odometry as jax_cli
from icp4dradar_tpu.utils import MetricsLogger as JaxLogger
from icp4dradar_tpu.utils.trajectory import write_pcl_info as jax_pcl_info
from icp4dradar_tpu.utils.trajectory import write_tum as jax_tum
from icp4dradar_tpu_torch.models import run_odometry as port_cli
from icp4dradar_tpu_torch.utils import MetricsLogger, write_pcl_info, write_tum
from tests._torch_threads import one_torch_thread  # noqa: F401

CLI_ARGS = ["--mode", "scan_to_scan", "--synthetic", "8", "--max-points", "256",
            "--landmarks", "2000", "--doppler-prior"]


def _poses(seed, n):
    rng = np.random.default_rng(seed)
    xi = rng.normal(0, [20, 20, 2, 1, 1, 2], (n, 6)).astype(np.float32)
    return np.asarray(se3_exp(jnp.asarray(xi))).astype(np.float64)


def test_write_tum_and_pcl_info_byte_identical(tmp_path):
    poses = _poses(0, 300)
    counts = np.asarray([256, 0, 17, 2048, 1e6], np.float32)
    times = np.arange(300) * 0.1
    for name, port, jax_ in (
            ("tum", lambda p: write_tum(p, poses), lambda p: jax_tum(p, poses)),
            ("tum_times", lambda p: write_tum(p, poses, times),
             lambda p: jax_tum(p, poses, times)),
            ("pcl", lambda p: write_pcl_info(p, counts), lambda p: jax_pcl_info(p, counts))):
        a, b = tmp_path / "port" / name, tmp_path / "jax" / name
        port(os.fspath(a))
        jax_(os.fspath(b))
        assert a.read_bytes() == b.read_bytes(), name
    assert (tmp_path / "port" / "pcl").read_text().splitlines()[-1] == "1e+06"


def test_metrics_logger_matches_jax(tmp_path, capsys):
    recs = []
    for cls, name in ((MetricsLogger, "port.jsonl"), (JaxLogger, "jax.jsonl")):
        path = tmp_path / "sub" / name
        with cls(os.fspath(path), echo=True) as log:
            log.log("first", a=1)
            log.log("run_complete", mode="scan_to_scan", frames=3)
        with cls(os.fspath(path)) as log:     # appends
            log.log("again")
        recs.append([json.loads(line) for line in path.read_text().splitlines()])
    port, jax_ = recs
    assert [list(r) for r in port] == [list(r) for r in jax_]
    for p, j in zip(port, jax_):
        assert {k: v for k, v in p.items() if k != "ts"} == {k: v for k, v in j.items()
                                                             if k != "ts"}
    assert [r["step"] for r in port] == [0, 1, 0]
    echoed = capsys.readouterr().out.strip().splitlines()
    assert len(echoed) == 4 and json.loads(echoed[0])["event"] == "first"


def _rows(path):
    return len(path.read_text().splitlines())


def test_cli_output_directory_matches_jax_cli(tmp_path, capsys):
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    assert port_cli.main(CLI_ARGS + ["--device", "cpu", "--out", os.fspath(port_dir)]) == 0
    port_line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert jax_cli.main(CLI_ARGS + ["--cpu", "--out", os.fspath(jax_dir)]) == 0
    jax_line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    files = sorted(os.listdir(jax_dir))
    assert files == ["icp.txt", "metrics.jsonl", "odom_tum.txt", "output_result.csv",
                     "pcl_info.txt", "velocity.txt"]
    assert sorted(os.listdir(port_dir)) == files
    for f in files:
        assert _rows(port_dir / f) == _rows(jax_dir / f), f
    assert (port_dir / "pcl_info.txt").read_bytes() == (jax_dir / "pcl_info.txt").read_bytes()
    port_recs, jax_recs = ([json.loads(line) for line in (d / "metrics.jsonl").read_text()
                            .splitlines()] for d in (port_dir, jax_dir))
    assert [r["event"] for r in port_recs] == [r["event"] for r in jax_recs] == ["run_complete"]
    assert [sorted(r) for r in port_recs] == [sorted(r) for r in jax_recs]
    assert port_recs[0]["frames"] == jax_recs[0]["frames"] == 8
    tum = np.loadtxt(port_dir / "odom_tum.txt")
    assert tum.shape == (8, 8) and np.isfinite(tum).all()
    np.testing.assert_allclose(tum[:, 1:4], np.loadtxt(jax_dir / "odom_tum.txt")[:, 1:4],
                               atol=5e-2)
    # the stdout line: the JAX CLI's keys, and the device
    assert sorted(port_line) == sorted(list(jax_line) + ["device"])
    assert port_line["device"] == "cpu" and port_line["mode"] == jax_line["mode"]
    assert port_line["ate_rmse_m"] == port_recs[0]["ate_rmse_m"]
    assert abs(port_line["ate_rmse_m"] - jax_line["ate_rmse_m"]) <= 5e-3


PG_ARGS = ["--mode", "pose_graph", "--synthetic", "16", "--max-points", "256",
           "--landmarks", "2000"]


def test_cli_pose_graph_matches_jax_cli(tmp_path, capsys):
    """One small `--mode pose_graph` run of each CLI (the scan-to-scan front
    end): the same files with the same row counts, and metrics records of
    the same events and keys."""
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    assert port_cli.main(PG_ARGS + ["--device", "cpu", "--out", os.fspath(port_dir)]) == 0
    port_line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert jax_cli.main(PG_ARGS + ["--cpu", "--out", os.fspath(jax_dir)]) == 0
    jax_line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    files = sorted(os.listdir(jax_dir))
    assert files == ["metrics.jsonl", "odom_tum.txt", "odometry_raw.txt", "pcl_info.txt",
                     "radar_odometry.txt"]
    assert sorted(os.listdir(port_dir)) == files
    for f in files:
        assert _rows(port_dir / f) == _rows(jax_dir / f), f
    port_recs, jax_recs = ([json.loads(line) for line in (d / "metrics.jsonl").read_text()
                            .splitlines()] for d in (port_dir, jax_dir))
    assert [r["event"] for r in port_recs] == [r["event"] for r in jax_recs] == [
        "pose_graph", "run_complete"]
    assert [sorted(r) for r in port_recs] == [sorted(r) for r in jax_recs]
    assert port_recs[0]["keyframes"] == jax_recs[0]["keyframes"] == 4
    assert port_recs[0]["loop_closures"] == jax_recs[0]["loop_closures"]
    raw = np.loadtxt(port_dir / "odometry_raw.txt")
    assert raw.shape == (16, 12) and np.isfinite(raw).all()
    np.testing.assert_allclose(np.loadtxt(port_dir / "radar_odometry.txt"),
                               np.loadtxt(jax_dir / "radar_odometry.txt"), atol=5e-2)
    assert port_line["mode"] == jax_line["mode"] == "pose_graph"


def test_cli_pose_graph_scan_to_map_structure_factors(tmp_path, capsys):
    out = tmp_path / "o"
    assert port_cli.main(PG_ARGS + ["--front-end", "scan_to_map", "--structure-factors",
                                    "--set", "voxel_map.capacity=16384", "--device", "cpu",
                                    "--out", os.fspath(out)]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["mode"] == "pose_graph" and line["frames"] == 16
    assert sorted(os.listdir(out)) == ["metrics.jsonl", "odom_tum.txt", "odometry_raw.txt",
                                       "pcl_info.txt", "radar_odometry.txt"]
    recs = [json.loads(x) for x in (out / "metrics.jsonl").read_text().splitlines()]
    assert recs[0]["event"] == "pose_graph" and np.isfinite(recs[0]["cost"])
    assert np.isfinite(np.loadtxt(out / "radar_odometry.txt")).all()


def _records(d):
    return [json.loads(line) for line in (d / "metrics.jsonl").read_text().splitlines()]


def _compare_dirs(port_dir, jax_dir, files):
    assert sorted(os.listdir(jax_dir)) == files
    assert sorted(os.listdir(port_dir)) == files
    for f in files:
        assert _rows(port_dir / f) == _rows(jax_dir / f), f
    assert (port_dir / "pcl_info.txt").read_bytes() == (jax_dir / "pcl_info.txt").read_bytes()
    port_recs, jax_recs = _records(port_dir), _records(jax_dir)
    assert [r["event"] for r in port_recs] == [r["event"] for r in jax_recs]
    assert [sorted(r) for r in port_recs] == [sorted(r) for r in jax_recs]
    return port_recs[-1], jax_recs[-1]


BAG_ARGS = ["--topic-radar", "/radar", "--topic-gt", "/gt", "--topic-imu", "/imu",
            "--imu-prior", "--mode", "scan_to_map", "--map-interval", "8", "--cv-rot",
            "--max-points", "256", "--viz", "--set", "voxel_map.capacity=16384"]


def test_cli_bag_imu_prior_matches_jax_cli(tmp_path, capsys):
    """`--bag --imu-prior --mode scan_to_map --map-interval 8 --viz` on a
    16-frame bag (the blocked tracker needs (F - 8) % 8 == 0) in both CLIs:
    the same files (map.ply and viewer.html included), the same map size,
    the JAX CLI's record keys, and poses within the parity tolerance."""
    from icp4dradar_tpu_torch.io import SyntheticSequence, write_synthetic_bag

    bag = os.fspath(tmp_path / "run.bag")
    write_synthetic_bag(bag, SyntheticSequence(num_frames=16, max_points=256,
                                               num_landmarks=2000, seed=0))
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    args = ["--bag", bag] + BAG_ARGS
    assert port_cli.main(args + ["--device", "cpu", "--out", os.fspath(port_dir)]) == 0
    port_out = capsys.readouterr().out.strip().splitlines()
    assert jax_cli.main(args + ["--cpu", "--out", os.fspath(jax_dir)]) == 0
    jax_out = capsys.readouterr().out.strip().splitlines()
    port_rec, jax_rec = _compare_dirs(port_dir, jax_dir, [
        "map.ply", "metrics.jsonl", "odom_tum.txt", "pcl_info.txt", "radar_odometry.txt",
        "velocity.txt", "viewer.html"])
    assert port_out[0] == jax_out[0] and port_out[0].startswith("map.ply: ")
    assert (port_dir / "map.ply").read_text().split("end_header")[0] == \
        (jax_dir / "map.ply").read_text().split("end_header")[0]
    assert port_rec["frames"] == 16 and abs(port_rec["ate_rmse_m"] - jax_rec["ate_rmse_m"]) <= 5e-3
    np.testing.assert_allclose(np.loadtxt(port_dir / "radar_odometry.txt"),
                               np.loadtxt(jax_dir / "radar_odometry.txt"), atol=5e-3)
    assert "const gt=[[" in (port_dir / "viewer.html").read_text()


def test_cli_accumulate_scans_matches_jax_cli(tmp_path, capsys):
    """`--mode scan_to_map --set accumulate_scans=2` (the per-frame tracker
    with a window of one refined scan that registers with each frame and
    enters the map a frame late) in both CLIs: the same files, the JAX
    CLI's record keys, and poses within the bag case's tolerance; the
    window changes the port's track."""
    port_dir, jax_dir, one_dir = tmp_path / "port", tmp_path / "jax", tmp_path / "one"
    args = ["--mode", "scan_to_map", "--synthetic", "8", "--max-points", "256",
            "--landmarks", "2000", "--cv-rot", "--set", "voxel_map.capacity=16384"]
    acc = ["--set", "accumulate_scans=2"]
    assert port_cli.main(args + acc + ["--device", "cpu", "--out", os.fspath(port_dir)]) == 0
    assert jax_cli.main(args + acc + ["--cpu", "--out", os.fspath(jax_dir)]) == 0
    assert port_cli.main(args + ["--device", "cpu", "--out", os.fspath(one_dir)]) == 0
    capsys.readouterr()
    port_rec, jax_rec = _compare_dirs(port_dir, jax_dir, [
        "metrics.jsonl", "odom_tum.txt", "pcl_info.txt", "radar_odometry.txt", "velocity.txt"])
    assert port_rec["frames"] == 8 and abs(port_rec["ate_rmse_m"] - jax_rec["ate_rmse_m"]) <= 5e-3
    pose = np.loadtxt(port_dir / "radar_odometry.txt")
    np.testing.assert_allclose(pose, np.loadtxt(jax_dir / "radar_odometry.txt"), atol=5e-3)
    assert not np.array_equal(pose, np.loadtxt(one_dir / "radar_odometry.txt"))


def test_cli_replay_with_steady_state_matches_jax_cli(tmp_path, capsys):
    """`--replay` of the port's own scan_to_scan run, with `--steady-state`,
    in both CLIs: the same files, the run's poses back within the CSV's six
    decimals, and the steady-state keys in the record; a CSV of another
    length is refused."""
    run_dir, port_dir, jax_dir = tmp_path / "run", tmp_path / "port", tmp_path / "jax"
    assert port_cli.main(CLI_ARGS + ["--device", "cpu", "--out", os.fspath(run_dir)]) == 0
    csv = os.fspath(run_dir / "output_result.csv")
    args = CLI_ARGS + ["--replay", csv, "--steady-state"]
    assert port_cli.main(args + ["--device", "cpu", "--out", os.fspath(port_dir)]) == 0
    assert jax_cli.main(args + ["--cpu", "--out", os.fspath(jax_dir)]) == 0
    capsys.readouterr()
    port_rec, _ = _compare_dirs(port_dir, jax_dir, [
        "icp.txt", "metrics.jsonl", "odom_tum.txt", "output_result.csv", "pcl_info.txt",
        "velocity.txt"])
    assert {"steady_s", "steady_scans_per_sec", "compile_overhead_s"} <= set(port_rec)
    np.testing.assert_allclose(np.loadtxt(port_dir / "odom_tum.txt")[:, 1:4],
                               np.loadtxt(run_dir / "odom_tum.txt")[:, 1:4], atol=1e-4)
    assert (port_dir / "velocity.txt").read_bytes() == (run_dir / "velocity.txt").read_bytes()
    np.testing.assert_allclose(np.loadtxt(port_dir / "velocity.txt"),
                               np.loadtxt(jax_dir / "velocity.txt"), atol=1e-3)
    short = tmp_path / "short.csv"
    short.write_text("\n".join((run_dir / "output_result.csv").read_text().splitlines()[:5]))
    with pytest.raises(SystemExit):
        port_cli.main(CLI_ARGS + ["--replay", os.fspath(short), "--device", "cpu",
                                  "--out", os.fspath(tmp_path / "x")])
    assert "--replay has 4 rows but the sequence has 8 frames" in capsys.readouterr().err


def test_cli_dataset_format_sniffs_pcd(tmp_path, capsys):
    """A folder with `pcd/` runs through the PCD reader (`--dataset-format
    auto`), as in the JAX CLI; `--dataset-format bin` on it finds no frames."""
    from icp4dradar_tpu_torch.io import SyntheticSequence, write_pcd

    seq = SyntheticSequence(num_frames=6, max_points=256, num_landmarks=2000, seed=4)
    for k in range(6):
        rec = seq.scan(k).to_numpy_valid()
        write_pcd(os.fspath(tmp_path / "seq" / "pcd" / f"{k:05d}.pcd"), {
            "x": rec[:, 0], "y": rec[:, 1], "z": rec[:, 2], "intensity": rec[:, 3],
            "doppler": rec[:, 4]})
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    args = ["--mode", "scan_to_scan", "--dataset", os.fspath(tmp_path / "seq"),
            "--max-points", "256", "--doppler-prior"]
    assert port_cli.main(args + ["--device", "cpu", "--out", os.fspath(port_dir)]) == 0
    assert jax_cli.main(args + ["--cpu", "--out", os.fspath(jax_dir)]) == 0
    capsys.readouterr()
    port_rec, _ = _compare_dirs(port_dir, jax_dir, [
        "icp.txt", "metrics.jsonl", "odom_tum.txt", "output_result.csv", "pcl_info.txt",
        "velocity.txt"])
    assert port_rec["frames"] == 6 and "ate_rmse_m" not in port_rec
    counts = np.loadtxt(port_dir / "pcl_info.txt")
    assert counts.tolist() == [float(len(seq.scan(k).to_numpy_valid())) for k in range(6)]
    assert np.isfinite(np.loadtxt(port_dir / "odom_tum.txt")).all()
    with pytest.raises(SystemExit, match="no bin frames"):
        port_cli.main(args + ["--dataset-format", "bin", "--device", "cpu",
                              "--out", os.fspath(tmp_path / "b")])


DIST_ARGS = ["--mode", "scan_to_map", "--synthetic", "8", "--max-points", "256",
             "--landmarks", "2000", "--map-interval", "4", "--cv-rot", "--viz",
             "--set", "voxel_map.capacity=16384", "--distributed", "2"]


def test_cli_distributed_matches_jax_cli_and_the_direct_call(tmp_path, capsys):
    """`--distributed 2 --mode scan_to_map --map-interval 4 --cv-rot --viz`:
    the port's CLI on two spawned gloo ranks (`--device cpu`) and the JAX
    CLI on a 2-device mesh of its virtual CPU devices write the same files
    with the same row counts (map.ply of the gathered map, viewer.html),
    records of the same keys, poses within 5e-3 m; the port's poses equal,
    bit for bit, `run_scan_to_map_distributed` called on the same scans and
    config at world size 2."""
    from icp4dradar_tpu_torch.config import PipelineConfig
    from icp4dradar_tpu_torch.interop import SCAN_FIELDS
    from icp4dradar_tpu_torch.io import SyntheticSequence
    from icp4dradar_tpu_torch.io.scan import stack_scans
    from icp4dradar_tpu_torch.parallel.dryrun import run_on_ranks
    from icp4dradar_tpu_torch.utils import write_rt_txt
    from tests._torch_dist_sharded import cli_direct

    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    assert port_cli.main(DIST_ARGS + ["--device", "cpu", "--out", os.fspath(port_dir)]) == 0
    port_out = capsys.readouterr().out.strip().splitlines()
    assert jax_cli.main(DIST_ARGS + ["--cpu", "--out", os.fspath(jax_dir)]) == 0
    jax_out = capsys.readouterr().out.strip().splitlines()
    port_rec, jax_rec = _compare_dirs(port_dir, jax_dir, [
        "map.ply", "metrics.jsonl", "odom_tum.txt", "pcl_info.txt", "radar_odometry.txt",
        "velocity.txt", "viewer.html"])
    assert port_out[0].startswith("map.ply: ") and jax_out[0].startswith("map.ply: ")
    assert port_rec["frames"] == 8 and abs(port_rec["ate_rmse_m"] - jax_rec["ate_rmse_m"]) <= 5e-3
    np.testing.assert_allclose(np.loadtxt(port_dir / "radar_odometry.txt"),
                               np.loadtxt(jax_dir / "radar_odometry.txt"), atol=5e-3)
    seq = SyntheticSequence(num_frames=8, max_points=256, num_landmarks=2000, seed=0)
    scans = stack_scans([seq.scan(k) for k in range(8)])
    cfg = PipelineConfig().override(**{"voxel_map.capacity": 16384, "max_points": 256,
                                       "seed": 0})
    direct = run_on_ranks(cli_direct, 2, {
        "scans": {k: getattr(scans, k).numpy() for k in SCAN_FIELDS}, "cfg": cfg.to_dict(),
        "block": 4})[0]
    write_rt_txt(os.fspath(tmp_path / "direct.txt"), direct["world_T"])
    assert (port_dir / "radar_odometry.txt").read_bytes() == \
        (tmp_path / "direct.txt").read_bytes()


@pytest.mark.parametrize("argv,msg", [
    (["--synthetic", "4", "--mode", "scan_to_scan", "--distributed", "4"],
     "--distributed requires --mode scan_to_map"),
    (["--synthetic", "4", "--mode", "scan_to_map", "--replay", "x.csv"],
     "--replay runs in --mode scan_to_scan"),
    ([], "provide --dataset, --bag, or --synthetic F"),
])
def test_cli_refuses(argv, msg, capsys):
    with pytest.raises(SystemExit) as e:
        port_cli.main(argv + ["--device", "cpu"])
    assert e.value.code == 2 and msg in capsys.readouterr().err
