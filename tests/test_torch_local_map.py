"""Port local-map window ICP and keyframe-local submaps on the CPU, against
the JAX package: `build_windows` (identical windows, subsampled with the
same numpy draws or not), `local_map_refinement` (9 frames, window 3, 256
points: two window pairs in one batched ICP), `SubmapAccumulator` (the
same submaps), and the CLI's `--local-map` (icp_map.txt against the JAX
CLI's).

Tolerance. `local_map_refinement` is held as
tests/test_torch_icp_moments.py::test_batched_icp_matches_jax_per_pair
holds the batched ICP (transforms within 1e-4): JAX's CPU ICP searches
with expanded distances, the port exactly. In the CLI the window ICP runs
on each CLI's own poses (32 frames of scan_to_scan, one window pair;
they part by ~1e-5 m) over 3,840-point windows, where the two searches
part further: the same row count, translations within 5e-3 m and rotation
entries within 1e-3 (5e-4 apart when written)."""

import os

import numpy as np
import pytest
import torch

from icp4dradar_tpu.config import IcpConfig as JaxIcpConfig
from icp4dradar_tpu.io import SyntheticSequence as JaxSequence
from icp4dradar_tpu.models import local_map as jlm
from icp4dradar_tpu.models import run_odometry as jax_cli
from icp4dradar_tpu.models.submap import SubmapAccumulator as JaxSubmaps
from icp4dradar_tpu_torch.config import IcpConfig
from icp4dradar_tpu_torch.models import (
    SubmapAccumulator,
    build_windows,
    local_map_refinement,
    run_odometry,
)
from icp4dradar_tpu_torch.ops import icp_fused
from tests._torch_threads import one_torch_thread  # noqa: F401

F, N, WINDOW = 9, 256, 3


def _scene(seed=0):
    """9 frames of 256 points, the ground-truth poses nudged by a few cm and
    tenths of a degree (something for the window ICP to correct)."""
    seq = JaxSequence(num_frames=F, max_points=N, num_landmarks=400, world_extent=50.0,
                      max_range=50.0, dynamic_fraction=0.05, speed=1.0, turn_rate=0.02,
                      seed=seed)
    scans = [seq.scan(k) for k in range(F)]
    xyz = np.stack([np.asarray(s.xyz) for s in scans])
    mask = np.stack([np.asarray(s.mask) for s in scans])
    rng = np.random.default_rng(seed)
    poses = seq.poses.astype(np.float32).copy()
    for k in range(F):
        a = rng.normal(0, 0.005)
        c, s = np.cos(a), np.sin(a)
        poses[k, :3, :3] = poses[k, :3, :3] @ np.float32([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        poses[k, :3, 3] += rng.normal(0, 0.05, 3).astype(np.float32)
    return xyz, mask, poses


@pytest.mark.parametrize("budget", [4096, 500])
def test_build_windows_identical(budget):
    xyz, mask, poses = _scene()
    want = jlm.build_windows(xyz, mask, poses, WINDOW, budget, seed=3)
    got = build_windows(xyz, mask, poses, WINDOW, budget, seed=3)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[0].shape == (F // WINDOW, budget, 3)
    live = got[1].sum(axis=1)
    assert (live == budget).all() if budget == 500 else (live < budget).all()


def test_local_map_refinement_matches_jax():
    xyz, mask, poses = _scene()
    cfg = IcpConfig()
    want = jlm.local_map_refinement(xyz, mask, poses, WINDOW, 1024, cfg=JaxIcpConfig())
    before = icp_fused.ICP_MOMENTS_LAUNCHES
    got = local_map_refinement(xyz, mask, poses, WINDOW, 1024, cfg=cfg, device="cpu")
    assert icp_fused.ICP_MOMENTS_LAUNCHES == before          # the plain version
    assert got.shape == want.shape == (F // WINDOW - 1, 4, 4) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert np.abs(got[:, :3, 3]).max() > 1e-2               # it corrected something
    # the pairs register as one batch: each equals its own unbatched call
    wins, masks = build_windows(xyz, mask, poses, WINDOW, 1024)
    from icp4dradar_tpu_torch.registration.icp import icp_point_to_point
    for b in range(len(wins) - 1):
        one = icp_point_to_point(*(torch.from_numpy(x) for x in (wins[b + 1], wins[b],
                                                                 masks[b + 1], masks[b])),
                                 cfg=cfg)
        np.testing.assert_allclose(got[b], one.transform.numpy(), atol=1e-6)
    # fewer frames than two windows: no pairs
    n = 2 * WINDOW - 1
    assert local_map_refinement(xyz[:n], mask[:n], poses[:n], WINDOW,
                                device="cpu").shape == (0, 4, 4)


def test_submap_accumulator_matches_jax():
    xyz, mask, poses = _scene()
    got, want = SubmapAccumulator(scans_per_submap=4), JaxSubmaps(scans_per_submap=4)
    for k in range(F):
        a = got.add_frame(poses[k], xyz[k], mask[k] if k % 2 else None)
        b = want.add_frame(poses[k], xyz[k], mask[k] if k % 2 else None)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    assert len(got.submaps) == len(want.submaps) == F // 4


CLI_ARGS = ["--synthetic", "32", "--max-points", "256", "--landmarks", "2000",
            "--doppler-prior", "--local-map"]


def test_cli_local_map_matches_jax_cli(tmp_path, capsys):
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    args = ["--mode", "scan_to_scan"] + CLI_ARGS
    assert run_odometry.main(args + ["--device", "cpu", "--out", os.fspath(port_dir)]) == 0
    assert jax_cli.main(args + ["--cpu", "--out", os.fspath(jax_dir)]) == 0
    got, want = (np.loadtxt(d / "icp_map.txt", ndmin=2) for d in (port_dir, jax_dir))
    assert got.shape == want.shape == (1, 12)
    got, want = got.reshape(-1, 3, 4), want.reshape(-1, 3, 4)
    np.testing.assert_allclose(got[..., 3], want[..., 3], atol=5e-3)
    np.testing.assert_allclose(got[..., :3], want[..., :3], atol=1e-3)
    # the scan_to_map mode writes it too
    s2m = tmp_path / "s2m"
    assert run_odometry.main(["--mode", "scan_to_map"] + CLI_ARGS + [
        "--device", "cpu", "--out", os.fspath(s2m),
        "--set", "voxel_map.capacity=4096", "--set", "voxel_map.submap_max_points=1024"]) == 0
    rows = np.loadtxt(s2m / "icp_map.txt", ndmin=2)
    assert rows.shape == (1, 12) and np.isfinite(rows).all()
    capsys.readouterr()
