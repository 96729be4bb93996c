"""The port's distributed scan-to-map pipeline, its checkpoints and the
multi-process runtime (`icp4dradar_tpu_torch.parallel.distributed_pipeline`
and `multihost`) on the CPU: two gloo ranks against the JAX package's
`run_scan_to_map_distributed` on a 2-device mesh (devices 0 and 1 of the 8
virtual CPU devices), against the port's single-device tracker, and two
real processes of `python -m icp4dradar_tpu_torch.parallel.multihost`
joined through ICP4D_* on a loopback port.

One module fixture starts the two launcher processes, spawns the rank work
of `tests/_torch_dist_sharded.py` once at world size 2, and computes the
JAX references meanwhile. The scene is
tests/test_distributed_pipeline.py's (512 points, seed 3), 16 frames.

Tolerances:
- against JAX (per frame with IMU-style priors; blocked with block 4,
  cv-rot, forget and the distributed rehash): tests/test_torch_batch.py's
  `_assert_tracks` (positions 1e-2 m, rotations 1e-3, ATE within 1e-3 m,
  inlier counts and validity equal, velocities 1e-4, submap counts 1%,
  GN iterations within 2); the JAX CPU ring matches with expanded
  distances, the port's plain K4 with exact ones;
- against the port's single-device `run_scan_to_map` on the same draws and
  priors: tests/test_distributed_pipeline.py's 1e-2 (positions and
  rotation entries), the same inlier counts;
- the checkpoint split (8 + 8 frames, saved and loaded at world size 2)
  against the uninterrupted run: 1e-3 m (tests/test_distributed_pipeline.py);
  tables saved by either package and loaded by the other: equal;
- the multihost launcher's poses (F = 13 over 2 processes, slices of 7 and
  6 frames) against `run_scan_to_map_distributed` at 2 ranks on the same
  scans: bit for bit (its file's 15 significant digits)."""

import json
import os
import socket
import subprocess
import sys
import threading
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icp4dradar_tpu import parallel as jpar
from icp4dradar_tpu.config import PipelineConfig as JaxConfig
from icp4dradar_tpu.io import SyntheticSequence as JaxSequence
from icp4dradar_tpu.io.scan import stack_scans as jax_stack
from icp4dradar_tpu.mapping import voxel_map_create as j_map_create
from icp4dradar_tpu_torch.interop import SCAN_FIELDS, config_from_dict, scans_from_numpy
from icp4dradar_tpu_torch.io import SyntheticSequence
from icp4dradar_tpu_torch.io.scan import stack_scans
from icp4dradar_tpu_torch.mapping import voxel_map_create, voxel_map_insert
from icp4dradar_tpu_torch.models import run_scan_to_map
from icp4dradar_tpu_torch.parallel import multihost as pmh
from icp4dradar_tpu_torch.parallel.dryrun import run_on_ranks
from icp4dradar_tpu_torch.preprocess.reve import reve_hypotheses
from icp4dradar_tpu_torch.utils import threefry, write_rt_txt
from tests._torch_dist_sharded import TABLES, pipeline_case
from tests._torch_threads import one_torch_thread  # noqa: F401
from tests.test_torch_batch import _assert_tracks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F, N, SPLIT, MH_FRAMES, MH_POINTS = 16, 512, 8, 13, 256


def _cfg():
    """tests/test_distributed_pipeline.py's config."""
    return JaxConfig().override(**{
        "voxel_map.capacity": 1 << 13, "voxel_map.submap_max_points": 1 << 11,
        "gicp.max_iterations": 15})


def _blocked_cfg():
    """Forget at 20 m: the blocked run's tombstones pass the rehash
    fraction once."""
    return _cfg().override(**{"voxel_map.forget_radius": 20.0})


def _scene():
    seq = JaxSequence(num_frames=F, max_points=N, num_landmarks=2500, world_extent=60.0,
                      max_range=50.0, turn_rate=0.05, speed=1.0, dynamic_fraction=0.05,
                      pos_noise=0.01, seed=3)
    gt = np.asarray(seq.poses[:F], dtype=np.float64)
    # rotation-only body priors from the ground-truth chain, what a perfect
    # gyro integrates between scan stamps (tests/test_distributed_pipeline.py)
    pr = np.tile(np.eye(4, dtype=np.float32), (F, 1, 1))
    for k in range(1, F):
        pr[k, :3, :3] = (np.linalg.inv(gt[k - 1]) @ gt[k])[:3, :3].astype(np.float32)
    return jax_stack([seq.scan(k) for k in range(F)]), pr, gt


def _jax_references() -> dict:
    """JAX's distributed runs on make_mesh(2) (devices 0 and 1 of
    tests/conftest.py's 8 virtual CPU devices)."""
    scans, pr, _ = _scene()
    mesh = jpar.make_mesh(2)
    _, prior = jpar.run_scan_to_map_distributed(scans, mesh, _cfg(), priors=pr)
    _, blocked = jpar.run_scan_to_map_distributed(scans, mesh, _blocked_cfg(), block=4,
                                                  use_const_velocity_rot=True)
    return {"prior": jax.tree.map(np.asarray, prior),
            "blocked": jax.tree.map(np.asarray, blocked)}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch_multihost(out_dir) -> list:
    """Two `python -m icp4dradar_tpu_torch.parallel.multihost` processes,
    ranks 0 and 1 of a gloo group on a loopback port, one torch thread
    each (the ranks of `run_on_ranks` run on one)."""
    port = _free_port()
    procs = []
    for pid in range(2):
        env = dict(os.environ, ICP4D_COORDINATOR=f"127.0.0.1:{port}", ICP4D_NUM_PROCESSES="2",
                   ICP4D_PROCESS_ID=str(pid), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "icp4dradar_tpu_torch.parallel.multihost", "--device", "cpu",
             "--synthetic", str(MH_FRAMES), "--max-points", str(MH_POINTS),
             "--out", os.fspath(out_dir)],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    return procs


def _jax_map_checkpoint(path):
    """A JAX-written `save_distributed_state` file of a small map (the
    port's single-device insert of random points, as JAX arrays)."""
    rng = np.random.default_rng(7)
    vm = voxel_map_insert(voxel_map_create(1 << 12, device="cpu"),
                          torch.from_numpy(rng.uniform(-20, 20, (500, 3)).astype(np.float32)))
    jvm = j_map_create(1 << 12).replace(**{k: jnp.asarray(getattr(vm, k).numpy())
                                           for k in TABLES})
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [1.5, -2.0, 0.25]
    jpar.save_distributed_state(path, jvm, jnp.asarray(pose), frame=5)
    return {k: getattr(vm, k).numpy() for k in TABLES}, pose


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("distributed")
    scans, pr, gt = _scene()
    cfg = _cfg()
    jax_tables, jax_pose = _jax_map_checkpoint(os.fspath(tmp / "jax_ckpt"))
    mseq = SyntheticSequence(num_frames=MH_FRAMES, max_points=MH_POINTS)
    mscans = stack_scans([mseq.scan(k) for k in range(MH_FRAMES)])
    inp = dict(
        cfg=cfg.to_dict(), blocked_cfg=_blocked_cfg().to_dict(),
        scans={k: np.asarray(getattr(scans, k)) for k in SCAN_FIELDS}, priors=pr,
        uniforms=threefry.uniform(threefry.split(threefry.key(cfg.seed), F),
                                  3 * reve_hypotheses(cfg.reve)),
        split=SPLIT, port_ckpt=os.fspath(tmp / "port_ckpt"), jax_ckpt=os.fspath(tmp / "jax_ckpt"),
        multihost=dict(scans={k: getattr(mscans, k).numpy() for k in SCAN_FIELDS},
                       cfg=JaxConfig().override(max_points=MH_POINTS).to_dict()))
    procs, got = _launch_multihost(tmp / "multihost"), {}
    ranks = threading.Thread(target=lambda: got.update(ranks=run_on_ranks(pipeline_case, 2,
                                                                          inp)))
    ranks.start()
    try:
        refs = _jax_references()
        ranks.join()
        launched = [p.communicate(timeout=600) + (p.returncode,) for p in procs]
    finally:
        ranks.join()
        for p in procs:
            if p.poll() is None:
                p.kill()
    if "ranks" not in got:
        raise RuntimeError("the ranks returned no result")
    ranks = got["ranks"]
    return dict(inp=inp, gt=gt, ranks=ranks, jax=refs, tmp=tmp, launched=launched,
                jax_tables=jax_tables, jax_pose=jax_pose)


def _ns(outs: dict) -> SimpleNamespace:
    return SimpleNamespace(**{k: torch.from_numpy(np.asarray(v)) for k, v in outs.items()})


def test_ranks_agree_and_bad_shapes_raise(case):
    """Every output and table is the same on both ranks; a config without
    VGICP, a capacity the mesh does not divide and a block that does not
    tile the frames raise."""
    r0, r1 = case["ranks"]
    for k in ("prior", "resumed", "blocked"):
        for name in r0[k]:
            np.testing.assert_array_equal(r0[k][name], r1[k][name])
    for k in ("prior_map", "blocked_map", "loaded_map"):
        for t in TABLES:
            np.testing.assert_array_equal(r0[k][t], r1[k][t])
    np.testing.assert_array_equal(r0["multihost_ref"], r1["multihost_ref"])
    assert r0["no_vgicp_raises"] and r0["capacity_raises"] and r0["block_raises"]


@pytest.mark.parametrize("name", ["prior", "blocked"])
def test_distributed_pipeline_matches_jax(case, name):
    """Per frame with IMU-style priors, and blocked (block 4, cv-rot,
    forget at 20 m with the distributed rehash), at world size 2 against
    JAX's run on its 2-device mesh: `_assert_tracks`."""
    got, want = _ns(case["ranks"][0][name]), SimpleNamespace(**case["jax"][name])
    ate = _assert_tracks(got, want, case["gt"])
    assert ate < 0.5
    assert got.submap_points[1:].min() > 0       # the first frame builds the map


def test_per_frame_with_priors_matches_single_device(case):
    """The distributed per-frame run with priors against the port's
    single-device `run_scan_to_map` on the same draws and priors: 1e-2
    (tests/test_distributed_pipeline.py), inlier counts equal, the maps'
    sizes within 2 voxels."""
    inp = case["inp"]
    cfg = config_from_dict(inp["cfg"])
    state, ref = run_scan_to_map(scans_from_numpy(inp["scans"], device="cpu"), cfg,
                                 uniforms=torch.from_numpy(inp["uniforms"]),
                                 prior_deltas=torch.from_numpy(inp["priors"]))
    got = case["ranks"][0]["prior"]
    np.testing.assert_allclose(got["world_T"][:, :3, 3], ref.world_T[:, :3, 3].numpy(),
                               atol=1e-2)
    np.testing.assert_allclose(got["world_T"][:, :3, :3], ref.world_T[:, :3, :3].numpy(),
                               atol=1e-2)
    np.testing.assert_array_equal(got["num_inliers"], ref.num_inliers.numpy())
    n_vox = case["ranks"][0]["prior_map"]["occupied"].sum()
    assert abs(n_vox - float(state.vmap.num_voxels)) <= 2


def test_checkpoint_resume_continues_tracking(case):
    """Frames 0-7 tracked, the sharded map and pose saved at world size 2
    and loaded back (tables equal, frame 8), frames 8-15 tracked from them
    with the rest of the draws: the poses of the uninterrupted run within
    1e-3 m."""
    r0 = case["ranks"][0]
    assert r0["resume_frame"] == SPLIT
    for t in TABLES:
        np.testing.assert_array_equal(r0["loaded_map"][t], r0["saved_map"][t])
    np.testing.assert_allclose(r0["resumed"]["world_T"][:, :3, 3],
                               r0["prior"]["world_T"][SPLIT:, :3, 3], atol=1e-3)


def test_checkpoints_load_across_packages(case):
    """A JAX-written checkpoint loads in the port (at world size 2) and the
    port's loads in the JAX package, on meshes of 2 and 4 devices: tables,
    pose and frame equal."""
    tables, pose, frame = case["ranks"][0]["jax_ckpt"]
    assert frame == 5
    np.testing.assert_array_equal(pose, case["jax_pose"])
    for t in TABLES:
        np.testing.assert_array_equal(tables[t], case["jax_tables"][t])
    saved = case["ranks"][0]["saved_map"]
    for n in (2, 4):
        vm, jpose, jframe = jpar.load_distributed_state(case["inp"]["port_ckpt"],
                                                        jpar.make_mesh(n))
        assert jframe == SPLIT and vm.capacity == 1 << 13
        for t in TABLES:
            np.testing.assert_array_equal(np.asarray(getattr(vm, t)), saved[t])
        np.testing.assert_array_equal(np.asarray(jpose),
                                      case["ranks"][0]["prior"]["world_T"][SPLIT - 1])


def test_multihost_launcher_matches_distributed_run(case, tmp_path):
    """Two launcher processes joined through ICP4D_* (gloo, a loopback
    port) over F = 13 frames, 7 and 6 a process, each loading only its
    slice: exit 0, process 0's JSON line and files, and its poses equal
    `run_scan_to_map_distributed` at 2 ranks on the same scans bit for
    bit."""
    (out0, err0, rc0), (out1, err1, rc1) = case["launched"]
    assert rc0 == 0 and rc1 == 0, (err0[-2000:], err1[-2000:])
    assert json.loads(out0.strip().splitlines()[-1]) == {"frames": MH_FRAMES,
                                                         "process_index": 0}
    assert out1.strip() == ""                    # only process 0 writes
    out_dir = case["tmp"] / "multihost"
    assert sorted(os.listdir(out_dir)) == ["odom_tum.txt", "radar_odometry.txt"]
    write_rt_txt(os.fspath(tmp_path / "ref.txt"), case["ranks"][0]["multihost_ref"])
    assert (out_dir / "radar_odometry.txt").read_bytes() == (tmp_path / "ref.txt").read_bytes()


def test_process_frame_slice_matches_jax():
    """JAX's arithmetic on tests/test_multihost.py's (F, n) cases and the
    launcher's: the same [start, stop) for every process, sizes within one,
    tiling [0, F); an index outside the count raises."""
    for F_, n in ((64, 1), (64, 4), (65, 4), (7, 8), (100, 3), (1, 1), (8, 8), (13, 2)):
        spans = [pmh.process_frame_slice(F_, n, p) for p in range(n)]
        assert spans == [jpar.process_frame_slice(F_, n, p) for p in range(n)]
        sizes = [b - a for a, b in spans]
        assert max(sizes) - min(sizes) <= 1 and sum(sizes) == F_
        with pytest.raises(ValueError):
            pmh.process_frame_slice(F_, n, n)


def test_no_coordinator_is_a_noop(monkeypatch):
    """Without ICP4D_COORDINATOR and without a group: (0, 1), nothing
    joined; one process's scans pass through the assembly as they are."""
    monkeypatch.delenv(pmh.COORD_ENV, raising=False)
    assert pmh.maybe_initialize_distributed("cpu") == (0, 1)
    assert not torch.distributed.is_initialized()
    seq = SyntheticSequence(num_frames=2, max_points=64, num_landmarks=500)
    scans = stack_scans([seq.scan(k) for k in range(2)])
    assert pmh.assemble_global_scans(scans, None, process_count=1) is scans
    with pytest.raises(ValueError):
        pmh._backend("tpu")                      # the backend follows the named device
