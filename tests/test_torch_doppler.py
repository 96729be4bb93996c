"""Port Doppler preprocessing parity: RANSAC sine fit (with JAX's own
uniform draws injected), static/dynamic split and LSQ ego velocity against
the JAX package on SyntheticSequence scans with N = 256.

Tolerance 1e-4 on A, b and the velocity: the hypotheses, their integer
scores and the first-argmax pick are the same on both sides; the IRLS
polish and the LSQ normal equations sum in a different order (f32
round-off)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icp4dradar_tpu.config import DopplerRansacConfig
from icp4dradar_tpu.io import SyntheticSequence as JaxSequence
from icp4dradar_tpu.io.scan import stack_scans as jax_stack
from icp4dradar_tpu.preprocess import doppler as jd
from icp4dradar_tpu_torch.interop import SCAN_FIELDS, scans_from_numpy
from icp4dradar_tpu_torch.io import SyntheticSequence as PortSequence
from icp4dradar_tpu_torch.preprocess import doppler as pd

ATOL = 1e-4
F, N = 6, 256


def _jax_uniforms(keys, H):
    """(F, 2, H): the draws JAX's fit_sine_ransac makes from each key."""
    def one(k):
        k1, k2 = jax.random.split(k)
        return jnp.stack([jax.random.uniform(k1, (H,)), jax.random.uniform(k2, (H,))])
    return np.asarray(jax.vmap(one)(keys))


def _inputs(seed=0, **seq_kw):
    seq = JaxSequence(num_frames=F, max_points=N, seed=seed, **seq_kw)
    js = jax_stack([seq.scan(k) for k in range(F)])
    ps = scans_from_numpy({k: np.asarray(getattr(js, k)) for k in SCAN_FIELDS},
                          device="cpu")
    keys = jax.random.split(jax.random.key(seed), F)
    return js, ps, keys


@pytest.mark.parametrize("vendor", [None, "ti_mmwave"])
def test_synthetic_sequence_bit_identical(vendor):
    kw = dict(num_frames=3, max_points=300, num_landmarks=3000, seed=5,
              vendor_profile=vendor)
    jseq, pseq = JaxSequence(**kw), PortSequence(**kw)
    np.testing.assert_array_equal(pseq.poses, jseq.poses)
    for k in range(3):
        js, ps = jseq.scan(k), pseq.scan(k)
        for f in SCAN_FIELDS:
            np.testing.assert_array_equal(getattr(ps, f).numpy(),
                                          np.asarray(getattr(js, f)))


def test_sample_valid_indices_exact():
    rng = np.random.default_rng(0)
    mask = (rng.uniform(size=(4, 200)) > 0.4).astype(np.float32)
    keys = [jax.random.key(f) for f in range(4)]
    u = np.stack([np.asarray(jax.random.uniform(k, (64,))) for k in keys])
    got = pd._sample_valid_indices(torch.from_numpy(mask), torch.from_numpy(u))
    for f in range(4):
        want = jd._sample_valid_indices(keys[f], jnp.asarray(mask[f]), 64)
        np.testing.assert_array_equal(got[f].numpy(), np.asarray(want))
    # the largest f32 below 1 picks the last valid slot, never past it
    top = pd._sample_valid_indices(torch.from_numpy(mask[:1]),
                                   torch.tensor([[np.float32(0.99999994)]]))
    assert int(top) == int(np.flatnonzero(mask[0] > 0.5)[-1])


def test_fit_split_velocity_match_jax():
    cfg = DopplerRansacConfig()
    js, ps, keys = _inputs()
    U = _jax_uniforms(keys, cfg.num_hypotheses)

    def jax_pp(scan, k):
        fit = jd.fit_sine_ransac(scan, k, cfg)
        static, dynamic = jd.static_dynamic_split(scan, fit, cfg)
        v, _ = jd.lsq_ego_velocity(scan, static)
        return fit, static, dynamic, v

    jfit, jstatic, jdyn, jv = jax.jit(jax.vmap(jax_pp))(js, keys)
    pfit, pstatic, pdyn, pv = pd.preprocess_scan(ps, cfg, torch.tensor(U))
    np.testing.assert_allclose(pfit.A.numpy(), np.asarray(jfit.A), atol=ATOL)
    np.testing.assert_allclose(pfit.b.numpy(), np.asarray(jfit.b), atol=ATOL)
    np.testing.assert_array_equal(pfit.valid.numpy(), np.asarray(jfit.valid))
    np.testing.assert_array_equal(pstatic.numpy(), np.asarray(jstatic))
    np.testing.assert_array_equal(pdyn.numpy(), np.asarray(jdyn))
    np.testing.assert_allclose(pv.numpy(), np.asarray(jv), atol=ATOL)
    np.testing.assert_allclose(pfit.inliers.numpy(), np.asarray(jfit.inliers),
                               atol=1.0)


def test_preprocess_frames_chunks_equal_whole():
    cfg = DopplerRansacConfig()
    _, ps, keys = _inputs(seed=2)
    U = torch.tensor(_jax_uniforms(keys, cfg.num_hypotheses))
    fit_a, static_a, v_a = pd.preprocess_frames(ps, U, cfg, chunk=4)
    fit_b, static_b, _, v_b = pd.preprocess_scan(ps, cfg, U)
    torch.testing.assert_close(fit_a.A, fit_b.A, rtol=0, atol=1e-6)
    torch.testing.assert_close(static_a, static_b, rtol=0, atol=0)
    torch.testing.assert_close(v_a, v_b, rtol=0, atol=1e-6)


def test_unbatched_and_two_sided_split():
    cfg = DopplerRansacConfig(two_sided_split=True, refine_iters=0)
    js, ps, keys = _inputs(seed=1, dynamic_fraction=0.3)
    U = _jax_uniforms(keys, cfg.num_hypotheses)
    scan0 = jax.tree.map(lambda x: x[0], js)
    jfit = jd.fit_sine_ransac(scan0, keys[0], cfg)
    jstatic, _ = jd.static_dynamic_split(scan0, jfit, cfg)
    pfit = pd.fit_sine_ransac(ps[0], cfg, torch.tensor(U[0]))
    pstatic, _ = pd.static_dynamic_split(ps[0], pfit, cfg)
    assert pfit.A.shape == ()
    np.testing.assert_allclose(pfit.A.numpy(), np.asarray(jfit.A), atol=ATOL)
    np.testing.assert_allclose(pfit.b.numpy(), np.asarray(jfit.b), atol=ATOL)
    np.testing.assert_array_equal(pstatic.numpy(), np.asarray(jstatic))


def test_generator_draws_are_seeded():
    cfg = DopplerRansacConfig()
    _, ps, _ = _inputs()
    fits = [pd.fit_sine_ransac(ps, cfg, generator=torch.Generator().manual_seed(7))
            for _ in range(2)]
    torch.testing.assert_close(fits[0].A, fits[1].A, rtol=0, atol=0)
    with pytest.raises(ValueError):       # never torch's global generator
        pd.fit_sine_ransac(ps, cfg)
