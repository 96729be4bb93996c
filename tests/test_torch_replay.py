"""The port's record/replay harness (`run_scan_to_scan_replay`) against the
JAX package's, on a 10-frame x 256-point synthetic sequence: on JAX's own
RANSAC draws (`utils.threefry.doppler_uniforms`, the draws of JAX's
key(cfg.seed)) the replay's outputs match JAX's; and the port's replay of
its own scan-to-scan run, through output_result.csv, reproduces the run:
velocity bit for bit (the same draws and the same preprocessing), poses
within 1e-4 (the CSV holds six decimals), and no ICP iteration.

Tolerances against JAX: velocity, sine A and b 1e-4 (as the scan-to-scan
parity test); poses 1e-5 (the prefix product's tree differs from XLA's
associative scan in round-off); recorded fitness and the flags exact."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import icp4dradar_tpu as jax_pkg
from icp4dradar_tpu.io import SyntheticSequence as JaxSequence
from icp4dradar_tpu.io.scan import stack_scans as jax_stack
from icp4dradar_tpu.models import run_scan_to_scan_replay as jax_replay
from icp4dradar_tpu_torch import PipelineConfig
from icp4dradar_tpu_torch.geom import se3_exp
from icp4dradar_tpu_torch.interop import SCAN_FIELDS, scans_from_numpy
from icp4dradar_tpu_torch.models import run_scan_to_scan, run_scan_to_scan_replay
from icp4dradar_tpu_torch.ops import icp_fused
from icp4dradar_tpu_torch.utils import doppler_uniforms, read_result_csv, write_result_csv
from tests._torch_threads import one_torch_thread  # noqa: F401

F, N = 10, 256


@pytest.fixture(scope="module")
def scans():
    seq = JaxSequence(num_frames=F, max_points=N, num_landmarks=3000, seed=2)
    js = jax_stack([seq.scan(k) for k in range(F)])
    return js, scans_from_numpy({k: np.asarray(getattr(js, k)) for k in SCAN_FIELDS},
                                device="cpu")


def _transforms(seed):
    rng = np.random.default_rng(seed)
    xi = rng.normal(0, [0.02, 0.02, 0.005, 1.0, 0.1, 0.02], (F, 6)).astype(np.float32)
    T = se3_exp(torch.from_numpy(xi)).numpy()
    T[0] = np.eye(4)
    return T


def test_replay_matches_jax_on_jax_draws(scans):
    js, ps = scans
    cfg = PipelineConfig()
    T = _transforms(0)
    fit = np.random.default_rng(1).uniform(0, 2, F).astype(np.float32)
    j = jax_replay(js, jnp.asarray(T), jax_pkg.PipelineConfig(),
                   recorded_fitness=jnp.asarray(fit))
    u = torch.from_numpy(doppler_uniforms(cfg.seed, F, cfg.doppler.num_hypotheses))
    p = run_scan_to_scan_replay(ps, T, cfg, uniforms=u, recorded_fitness=fit)
    np.testing.assert_array_equal(p.icp_transform.numpy(), T)
    np.testing.assert_allclose(p.world_T.numpy(), np.asarray(j.world_T), atol=1e-5)
    for f in ("velocity", "sine_A", "sine_b"):
        np.testing.assert_allclose(getattr(p, f).numpy(), np.asarray(getattr(j, f)),
                                   atol=1e-4, err_msg=f)
    np.testing.assert_array_equal(p.num_static.numpy(), np.asarray(j.num_static))
    np.testing.assert_array_equal(p.fitness.numpy(), fit)
    assert bool(p.converged.all()) and bool(p.accepted.all())
    assert p.iterations.dtype == torch.int32 and int(p.iterations.abs().sum()) == 0
    # without recorded scores: zeros, as JAX
    assert not bool(run_scan_to_scan_replay(ps, T, cfg, uniforms=u).fitness.any())


def test_replay_of_own_run_through_the_csv(scans, tmp_path):
    _, ps = scans
    cfg = PipelineConfig()
    out = run_scan_to_scan(ps, cfg, use_doppler_prior=True)
    path = os.fspath(tmp_path / "output_result.csv")
    write_result_csv(path, out.icp_transform.numpy(), out.fitness.numpy(),
                     out.sine_A.numpy(), out.sine_b.numpy())
    _, T_rec, scores, _, _ = read_result_csv(path)
    icp_fused.ICP_MOMENTS_LAUNCHES = 0
    rep = run_scan_to_scan_replay(ps, T_rec, cfg, recorded_fitness=scores)
    assert icp_fused.ICP_MOMENTS_LAUNCHES == 0
    # the same default draws (a generator seeded with cfg.seed) and the
    # same preprocessing: bit for bit
    for f in ("velocity", "sine_A", "sine_b", "num_static"):
        assert torch.equal(getattr(rep, f), getattr(out, f)), f
    np.testing.assert_allclose(rep.world_T.numpy(), out.world_T.numpy(), atol=1e-4)
    np.testing.assert_allclose(rep.fitness.numpy(), out.fitness.numpy(), atol=1e-6)
    # the in-memory transforms compose exactly as the run composed them
    exact = run_scan_to_scan_replay(ps, out.icp_transform, cfg)
    assert torch.equal(exact.world_T, out.world_T)
