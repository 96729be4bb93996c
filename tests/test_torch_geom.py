"""Port geometry parity: so3/se3 exp/log, the closed-form 3x3 solve and
Horn's rotation against the JAX package on the same numpy inputs.

Tolerance atol 1e-5: both sides run the same f32 formulas; only f32
round-off (transcendental implementations, 4x4 product order) differs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icp4dradar_tpu import geom as jg
from icp4dradar_tpu.geom.kabsch import _rotation_from_cross_covariance as j_horn
from icp4dradar_tpu.geom.linalg import solve3x3 as j_solve3x3
from icp4dradar_tpu_torch import geom as pg
from icp4dradar_tpu_torch.geom.kabsch import _rotation_from_cross_covariance as p_horn

ATOL = 1e-5


def _axis_angles(kind, rng):
    axes = rng.normal(size=(32, 3))
    axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
    if kind == "random":
        ang = rng.uniform(0.0, 2.5, size=(32, 1))
    elif kind == "near_zero":
        # inside exp's Taylor window (theta^2 < 1e-8); just above it the f32
        # closed form loses ~1e-4 of absolute accuracy on both sides
        ang = 10.0 ** rng.uniform(-8, -4.2, size=(32, 1))
    else:  # near pi, on both sides of the near-pi branch switch
        ang = np.pi - 10.0 ** rng.uniform(-4, -1.5, size=(32, 1))
    return (axes * ang).astype(np.float32)


def _close(port_out, jax_out, atol=ATOL):
    np.testing.assert_allclose(port_out.numpy(), np.asarray(jax_out), atol=atol)


@pytest.mark.parametrize("kind", ["random", "near_zero", "near_pi"])
def test_so3_exp_log(kind):
    w = _axis_angles(kind, np.random.default_rng(0))
    _close(pg.so3_exp(torch.from_numpy(w)), jg.so3_exp(jnp.asarray(w)))
    R = np.asarray(jg.so3_exp(jnp.asarray(w)))
    _close(pg.so3_log(torch.tensor(R)), jg.so3_log(jnp.asarray(R)))


@pytest.mark.parametrize("kind", ["random", "near_zero"])
def test_se3_exp_log(kind):
    rng = np.random.default_rng(1)
    xi = np.concatenate([rng.normal(0, 3, (32, 3)).astype(np.float32),
                         _axis_angles(kind, rng)], axis=-1)
    _close(pg.se3_exp(torch.from_numpy(xi)), jg.se3_exp(jnp.asarray(xi)))
    T = np.asarray(jg.se3_exp(jnp.asarray(xi)))
    _close(pg.se3_log(torch.tensor(T)), jg.se3_log(jnp.asarray(T)))
    _close(pg.se3_inverse(torch.tensor(T)), jg.se3_inverse(jnp.asarray(T)))


def test_solve3x3():
    rng = np.random.default_rng(2)
    A = rng.normal(size=(64, 3, 3)).astype(np.float32) + 3 * np.eye(3, dtype=np.float32)
    b = rng.normal(size=(64, 3)).astype(np.float32)
    _close(pg.solve3x3(torch.from_numpy(A), torch.from_numpy(b)),
           j_solve3x3(jnp.asarray(A), jnp.asarray(b)), 1e-4)
    # singular -> zeros on both sides
    z = np.zeros((1, 3, 3), np.float32)
    _close(pg.solve3x3(torch.from_numpy(z), torch.ones(1, 3)),
           j_solve3x3(jnp.asarray(z), jnp.ones((1, 3))))


def test_horn_rotation_batch():
    rng = np.random.default_rng(3)
    H = rng.normal(0, 100.0, size=(64, 3, 3)).astype(np.float32)
    R = p_horn(torch.from_numpy(H))
    _close(R, j_horn(jnp.asarray(H)))
    eye = np.broadcast_to(np.eye(3, dtype=np.float32), R.shape)
    np.testing.assert_allclose((R.transpose(-1, -2) @ R).numpy(), eye, atol=1e-5)


def test_kabsch_recovers_transform():
    rng = np.random.default_rng(4)
    src = rng.normal(0, 10, (3, 200, 3)).astype(np.float32)
    xi = rng.normal(0, 0.3, (3, 6)).astype(np.float32)
    T = pg.se3_exp(torch.from_numpy(xi))
    tgt = pg.se3_apply(T, torch.from_numpy(src))
    w = torch.from_numpy((rng.uniform(size=(3, 200)) > 0.2).astype(np.float32))
    T_fit = pg.kabsch_umeyama(torch.from_numpy(src), tgt, w)
    np.testing.assert_allclose(T_fit.numpy(), T.numpy(), atol=1e-4)
    T_jax = jg.kabsch_umeyama(jnp.asarray(src), jnp.asarray(tgt.numpy()),
                              jnp.asarray(w.numpy()))
    _close(T_fit, T_jax, 1e-4)
