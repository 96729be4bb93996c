"""Port REVE ego-velocity parity on the CPU: `estimate_ego_velocity` against
the JAX package with JAX's own RANSAC draws injected, over moving scans
with dynamic outliers, a SyntheticSequence scan, a zero-velocity scan and
scans that fail the gates.

Tolerance: inlier masks, `valid` and `zero_velocity` must be equal (the
hypotheses, their integer vote counts and the first-argmax pick are the
same); velocity and sigma agree within rtol 1e-4 (plus atol 1e-6 for
components near zero): the LSQ normal equations sum in another order."""

import jax
import numpy as np
import pytest
import torch

from icp4dradar_tpu.config import ReveConfig as JaxReveConfig
from icp4dradar_tpu.io import SyntheticSequence as JaxSequence
from icp4dradar_tpu.io.scan import RadarScan as JaxScan
from icp4dradar_tpu.io.scan import stack_scans as jax_stack
from icp4dradar_tpu.preprocess import reve as jr
from icp4dradar_tpu_torch.config import ReveConfig
from icp4dradar_tpu_torch.interop import SCAN_FIELDS, scans_from_numpy
from icp4dradar_tpu_torch.preprocess import reve as pr

RTOL, ATOL = 1e-4, 1e-6
N = 512


def _scan(rng, v_ego, n=400, n_dyn=0, noise=0.02, n_valid=None):
    """A forward-looking scan: static points with v_r = d . v_ego (+noise)
    and n_dyn dynamic points with 4 m/s extra Doppler."""
    xyz = rng.normal(size=(n, 3)).astype(np.float32) * np.array([30, 30, 5], np.float32)
    xyz[:, 0] += 40.0
    d = xyz / np.linalg.norm(xyz, axis=-1, keepdims=True)
    doppler = d @ np.asarray(v_ego, np.float32) + rng.normal(0, noise, n).astype(np.float32)
    doppler[rng.choice(n, n_dyn, replace=False)] += 4.0
    intensity = rng.uniform(5, 20, n).astype(np.float32)
    scan = JaxScan.from_arrays(xyz, doppler, intensity, max_points=N)
    if n_valid is not None:
        mask = np.asarray(scan.mask).copy()
        mask[n_valid:] = 0.0
        scan = scan.replace(mask=jax.numpy.asarray(mask))
    return scan


def _frames():
    rng = np.random.default_rng(0)
    seq = JaxSequence(num_frames=3, max_points=N, num_landmarks=6000,
                      dynamic_fraction=0.15, seed=3)
    return jax_stack([
        _scan(rng, (2.0, 0.5, 0.1), n_dyn=60),            # moving, dynamics
        _scan(rng, (-1.0, 1.5, 0.0), n_dyn=150, noise=0.05),
        seq.scan(2),                                       # synthetic scene
        _scan(rng, (0.0, 0.0, 0.0), noise=0.01),           # zero velocity
        _scan(rng, (2.0, 0.0, 0.0), n_valid=2),            # too few points
        _scan(rng, (1.0, 0.0, 0.0), noise=3.0),            # Doppler noise only
    ])


def _jax_draws(F, H, seed=0):
    keys = jax.random.split(jax.random.key(seed), F)
    return keys, np.stack([np.asarray(jax.random.uniform(k, (3 * H,))) for k in keys])


@pytest.mark.parametrize("cfg_kw", [{}, {"inlier_thresh": 0.3, "outlier_prob": 0.3}])
def test_estimate_matches_jax(cfg_kw):
    js = _frames()
    F = js.xyz.shape[0]
    jcfg, pcfg = JaxReveConfig(**cfg_kw), ReveConfig(**cfg_kw)
    H = pr.reve_hypotheses(pcfg)
    keys, U = _jax_draws(F, H)
    want = [jr.estimate_ego_velocity(jax.tree.map(lambda x: x[f], js), keys[f], jcfg)
            for f in range(F)]
    ps = scans_from_numpy({k: np.asarray(getattr(js, k)) for k in SCAN_FIELDS},
                          device="cpu")
    got = pr.estimate_ego_velocity(ps, torch.tensor(U), pcfg)
    for f, w in enumerate(want):
        np.testing.assert_array_equal(got.inlier_mask[f].numpy(), np.asarray(w.inlier_mask))
        assert bool(got.valid[f]) == bool(w.valid), f
        assert bool(got.zero_velocity[f]) == bool(w.zero_velocity), f
        np.testing.assert_allclose(got.velocity[f].numpy(), np.asarray(w.velocity),
                                   rtol=RTOL, atol=ATOL, err_msg=f"frame {f}")
        np.testing.assert_allclose(got.sigma[f].numpy(), np.asarray(w.sigma),
                                   rtol=RTOL, atol=ATOL, err_msg=f"frame {f}")
    # the cases the frames were built for
    assert bool(got.valid[0]) and bool(got.valid[2])
    assert bool(got.zero_velocity[3]) and not bool(got.zero_velocity[0])
    assert not bool(got.valid[4])


def test_one_frame_equals_its_batch_row():
    js = _frames()
    cfg = ReveConfig()
    _, U = _jax_draws(js.xyz.shape[0], pr.reve_hypotheses(cfg), seed=1)
    ps = scans_from_numpy({k: np.asarray(getattr(js, k)) for k in SCAN_FIELDS},
                          device="cpu")
    batch = pr.estimate_ego_velocity(ps, torch.tensor(U), cfg)
    one = pr.estimate_ego_velocity(ps[1], torch.tensor(U[1]), cfg)
    for name in ("velocity", "sigma", "inlier_mask", "valid", "zero_velocity"):
        torch.testing.assert_close(getattr(one, name), getattr(batch, name)[1])


def test_draws_come_from_a_seeded_generator():
    cfg = ReveConfig()
    a = pr.draw_reve_uniforms((4,), cfg, torch.Generator().manual_seed(7))
    b = pr.draw_reve_uniforms((4,), cfg, torch.Generator().manual_seed(7))
    assert a.shape == (4, 3 * pr.reve_hypotheses(cfg)) and torch.equal(a, b)
    assert 0.0 <= float(a.min()) and float(a.max()) < 1.0
    with pytest.raises(ValueError):
        pr.draw_reve_uniforms((4,), cfg, None)
    ps = scans_from_numpy({k: np.asarray(getattr(_frames(), k)) for k in SCAN_FIELDS},
                          device="cpu")
    with pytest.raises(ValueError):
        pr.estimate_ego_velocity(ps, a[:, :10], cfg)


@pytest.mark.parametrize("seed", [0, 42, 123456789])
def test_threefry_draws_are_jax_random_bit_for_bit(seed):
    """`utils.threefry` reproduces `jax.random.key`, `split` and `uniform`
    (float32) in numpy, so a run on a card without jax can take the JAX
    package's REVE draws."""
    from icp4dradar_tpu_torch.utils import threefry as tf

    k = jax.random.key(seed)
    np.testing.assert_array_equal(tf.key(seed), np.asarray(jax.random.key_data(k)))
    ks = jax.random.split(k, 7)
    np.testing.assert_array_equal(tf.split(tf.key(seed), 7), np.asarray(jax.random.key_data(ks)))
    for i in (0, 6):
        for n in (1, 456, 1001):
            np.testing.assert_array_equal(tf.uniform(tf.split(tf.key(seed), 7)[i], n),
                                          np.asarray(jax.random.uniform(ks[i], (n,))))


@pytest.mark.parametrize("block,frames", [(8, 24), (0, 6)])
def test_batch_uniforms_are_the_jax_batch_draws(block, frames):
    """`reve_batch_uniforms` gives each stream the draws of JAX's
    run_scan_to_map_batch: stream b's key split(key(seed), B)[b], split
    into warm-up and block keys by the blocked runner, or one key a frame
    by the per-frame one."""
    from icp4dradar_tpu_torch.utils import reve_batch_uniforms

    cfg, B = JaxReveConfig(), 3
    H = pr.reve_hypotheses(cfg)
    want = []
    for key in jax.random.split(jax.random.key(7), B):
        if block:
            kwarm, kblocks = jax.random.split(key)
            keys = list(jax.random.split(kwarm, block)) + list(
                jax.random.split(kblocks, frames - block))
        else:
            keys = list(jax.random.split(key, frames))
        want.append([np.asarray(jax.random.uniform(k, (3 * H,))) for k in keys])
    np.testing.assert_array_equal(reve_batch_uniforms(7, B, frames, block, H), np.asarray(want))


@pytest.mark.parametrize("block,frames", [(8, 24), (0, 6)])
def test_stream_uniforms_are_the_jax_runner_draws(block, frames):
    """`reve_uniforms` gives the draws of JAX's single-stream runners on
    key(seed): the blocked runner's warm-up and block keys, or the
    per-frame runner's one key a frame."""
    from icp4dradar_tpu_torch.utils import reve_uniforms

    H = pr.reve_hypotheses(JaxReveConfig())
    key = jax.random.key(11)
    if block:
        kwarm, kblocks = jax.random.split(key)
        keys = list(jax.random.split(kwarm, block)) + list(
            jax.random.split(kblocks, frames - block))
    else:
        keys = list(jax.random.split(key, frames))
    want = [np.asarray(jax.random.uniform(k, (3 * H,))) for k in keys]
    np.testing.assert_array_equal(reve_uniforms(11, frames, block, H), np.asarray(want))
