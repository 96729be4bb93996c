"""The ported scan-to-scan slice against the JAX package on the CPU:
`run_scan_to_scan` on a 16-frame x 256-point SyntheticSequence (seed 0) with
JAX's own RANSAC draws injected, one `scan_to_scan_step`, the pose-chain
scans, and the port's CLI.

Tolerances: transforms 1e-3 m on translations and 1e-4 on rotation entries;
velocity, sine A and b 1e-4. Horn's power iteration, the f32 sums and the
prefix-product order differ from XLA's in round-off, and JAX's CPU path
forms distances as |p|^2 - 2 p.q + |q|^2 where the port forms them
exactly; nothing else differs."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import icp4dradar_tpu as jax_pkg
from icp4dradar_tpu.io import SyntheticSequence as JaxSequence
from icp4dradar_tpu.io.scan import stack_scans as jax_stack
from icp4dradar_tpu.models import scan_to_scan as js2s
from icp4dradar_tpu_torch.interop import SCAN_FIELDS, config_from_dict, scans_from_numpy
from icp4dradar_tpu_torch.models import run_odometry
from icp4dradar_tpu_torch.models import scan_to_scan as ps2s
from icp4dradar_tpu_torch.utils import read_result_csv

F, N = 16, 256
T_ATOL, R_ATOL, ATOL = 1e-3, 1e-4, 1e-4


def _uniforms_of(key, H):
    """(2, H): the draws JAX's fit_sine_ransac makes from `key`."""
    k1, k2 = jax.random.split(key)
    return np.stack([np.asarray(jax.random.uniform(k1, (H,))),
                     np.asarray(jax.random.uniform(k2, (H,)))])


@pytest.fixture(scope="module")
def sequence():
    seq = JaxSequence(num_frames=F, max_points=N, seed=0)
    js = jax_stack([seq.scan(k) for k in range(F)])
    ps = scans_from_numpy({k: np.asarray(getattr(js, k)) for k in SCAN_FIELDS})
    cfg = jax_pkg.PipelineConfig()
    keys = jax.random.split(jax.random.key(cfg.seed), F)
    U = np.stack([_uniforms_of(keys[f], cfg.doppler.num_hypotheses) for f in range(F)])
    return seq, js, ps, cfg, torch.tensor(U)


def _assert_transforms(port, jax_out):
    port, jax_out = port.numpy(), np.asarray(jax_out)
    np.testing.assert_allclose(port[..., :3, 3], jax_out[..., :3, 3], atol=T_ATOL)
    np.testing.assert_allclose(port[..., :3, :3], jax_out[..., :3, :3], atol=R_ATOL)
    np.testing.assert_array_equal(port[..., 3, :], jax_out[..., 3, :])


@pytest.mark.parametrize("prior,static_only", [(True, False), (False, True)])
def test_run_scan_to_scan_matches_jax(sequence, prior, static_only):
    _, js, ps, cfg, U = sequence
    jo = jax.jit(lambda s: js2s.run_scan_to_scan(
        s, cfg, use_doppler_prior=prior, use_static_points_only=static_only))(js)
    po = ps2s.run_scan_to_scan(ps, config_from_dict(cfg.to_dict()), uniforms=U,
                               use_doppler_prior=prior,
                               use_static_points_only=static_only)
    _assert_transforms(po.icp_transform, jo.icp_transform)
    _assert_transforms(po.world_T, jo.world_T)
    np.testing.assert_array_equal(po.icp_transform[0].numpy(), np.eye(4))
    for f in ("velocity", "sine_A", "sine_b"):
        np.testing.assert_allclose(getattr(po, f).numpy(),
                                   np.asarray(getattr(jo, f)), atol=ATOL)
    for f in ("accepted", "converged", "num_static"):
        np.testing.assert_array_equal(getattr(po, f).numpy(),
                                      np.asarray(getattr(jo, f)))
    np.testing.assert_allclose(po.fitness.numpy(), np.asarray(jo.fitness),
                               rtol=1e-3, atol=1e-3)
    assert po.iterations.shape == (F,) and int(po.iterations.min()) >= 1


def test_scan_to_scan_step_matches_jax(sequence):
    _, js, ps, cfg, _ = sequence
    key = jax.random.key(3)
    k1, k2 = jax.random.split(key)
    H = cfg.doppler.num_hypotheses
    U = torch.tensor(np.stack([_uniforms_of(k1, H), _uniforms_of(k2, H)]))
    pose = np.asarray(jax_pkg.geom.se3_exp(jnp.asarray([1.0, 2.0, 0.1, 0.0, 0.01, 0.3])))
    last = np.asarray(jax_pkg.geom.se3_exp(jnp.asarray([2.0, 0.0, 0.0, 0.0, 0.0, 0.02])))
    jstate = js2s.ScanToScanState(world_T=jnp.asarray(pose), frame=jnp.int32(4),
                                  last_delta=jnp.asarray(last))
    pstate = ps2s.ScanToScanState(world_T=torch.tensor(pose), frame=4,
                                  last_delta=torch.tensor(last))
    cur, prev = 5, 4
    jnew, jo = js2s.scan_to_scan_step(
        jstate, jax.tree.map(lambda x: x[cur], js), jax.tree.map(lambda x: x[prev], js),
        key, cfg, use_doppler_prior=True)
    pnew, po = ps2s.scan_to_scan_step(pstate, ps[cur], ps[prev],
                                      config_from_dict(cfg.to_dict()),
                                      use_doppler_prior=True, uniforms=U)
    _assert_transforms(po.icp_transform, jo.icp_transform)
    _assert_transforms(pnew.world_T, jnew.world_T)
    _assert_transforms(pnew.last_delta, jnew.last_delta)
    assert pnew.frame == int(jnew.frame)
    np.testing.assert_allclose(po.velocity.numpy(), np.asarray(jo.velocity), atol=ATOL)
    assert bool(po.accepted) == bool(jo.accepted)
    assert bool(po.converged) == bool(jo.converged)


def test_pose_chain_scans():
    rng = np.random.default_rng(0)
    from icp4dradar_tpu_torch.geom import se3_exp

    xi = (rng.normal(size=(13, 6)) * [1, 1, 0.1, 0.02, 0.02, 0.1]).astype(np.float32)
    T = se3_exp(torch.from_numpy(xi))
    chain = ps2s._prefix_products(T).numpy()
    ref = np.eye(4)
    for k in range(13):
        ref = ref @ T[k].double().numpy()
        np.testing.assert_allclose(chain[k], ref, atol=1e-5)
    ok = torch.tensor([True, False, False, True, False, True, True, False, False,
                       False, True, False, False])
    held = ps2s._hold_last_ok(T, ok)
    last = 0
    for k in range(13):
        last = k if ok[k] else last
        torch.testing.assert_close(held[k], T[last], rtol=0, atol=0)


def _read_rows(path):
    with open(path) as f:
        return [list(map(float, line.split())) for line in f if line.strip()]


def test_cli_writes_reference_outputs(tmp_path, capsys):
    out = tmp_path / "run"
    rc = run_odometry.main(["--mode", "scan_to_scan", "--synthetic", "8",
                            "--max-points", "256", "--doppler-prior",
                            "--device", "cpu", "--out", str(out)])
    assert rc == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["frames"] == 8 and np.isfinite(rec["ate_rmse_m"])
    vel = np.asarray(_read_rows(out / "velocity.txt"))
    icp = np.asarray(_read_rows(out / "icp.txt"))
    assert vel.shape == (8, 3) and icp.shape == (8, 12)
    assert np.isfinite(vel).all() and np.isfinite(icp).all()
    _, T, scores, A, b = read_result_csv(os.fspath(out / "output_result.csv"))
    assert T.shape == (8, 4, 4) and scores.shape == A.shape == b.shape == (8,)
    np.testing.assert_allclose(T[:, :3, :3].reshape(8, 9),
                               icp[:, [0, 1, 2, 4, 5, 6, 8, 9, 10]], atol=1e-6)


def test_cli_never_falls_back_to_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        run_odometry.main(["--synthetic", "4", "--max-points", "64",
                           "--device", "cuda", "--out", str(tmp_path / "o")])
    assert exc.value.code != 0
    assert not (tmp_path / "o").exists()


def test_cli_unported_mode_exits(tmp_path):
    with pytest.raises(SystemExit) as exc:
        run_odometry.main(["--mode", "scan_to_map", "--synthetic", "4",
                           "--device", "cpu", "--out", str(tmp_path / "o")])
    assert exc.value.code != 0


def test_bin_dataset_matches_jax_and_feeds_cli(tmp_path, capsys):
    from icp4dradar_tpu.io import BinSequenceDataset as JaxBinDataset
    from icp4dradar_tpu_torch.io import BinSequenceDataset as PortBinDataset

    folder = str(tmp_path / "seq")
    JaxSequence(num_frames=4, max_points=128, num_landmarks=3000,
                seed=2).write_bin_sequence(folder)
    jds = JaxBinDataset(folder, max_points=128, use_native=False)
    pds = PortBinDataset(folder, max_points=128)
    assert len(pds) == len(jds) == 4
    for k in range(4):
        for f in SCAN_FIELDS:
            np.testing.assert_array_equal(getattr(pds[k], f).numpy(),
                                          np.asarray(getattr(jds[k], f)))
    rc = run_odometry.main(["--dataset", folder, "--max-points", "128",
                            "--doppler-prior", "--device", "cpu",
                            "--out", str(tmp_path / "o")])
    assert rc == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["frames"] == 4 and "ate_rmse_m" not in rec
    assert len(_read_rows(tmp_path / "o" / "icp.txt")) == 4
