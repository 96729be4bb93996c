"""Port geometry parity: so3/se3 exp/log, projection onto SO(3), roll/pitch/
yaw, the closed-form 3x3 and 6x6 solves, 3x3 symmetric eigenvalues and
condition numbers, and Horn's rotation against the JAX package on the same
numpy inputs.

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


def test_so3_project_and_rpy():
    from icp4dradar_tpu.geom import so3 as js

    rng = np.random.default_rng(5)
    R = np.asarray(jg.so3_exp(jnp.asarray(_axis_angles("random", rng))))
    # a drifted chain: scaled and sheared by ~1e-3
    Rd = (R * 1.001 + rng.normal(0, 1e-3, R.shape)).astype(np.float32)
    got = pg.so3_project(torch.tensor(Rd))
    _close(got, js.so3_project(jnp.asarray(Rd)))
    eye = np.broadcast_to(np.eye(3, dtype=np.float32), R.shape)
    np.testing.assert_allclose((got.transpose(-1, -2) @ got).numpy(), eye, atol=1e-5)
    # degrees, as the reference's R2rpy; 1e-3 deg is ~2e-5 rad of f32 atan2
    _close(pg.matrix_to_rpy(torch.tensor(R)), js.matrix_to_rpy(jnp.asarray(R)), 1e-3)


def test_solve_spd6_eigvals_and_condition():
    from icp4dradar_tpu.geom import linalg as jl

    rng = np.random.default_rng(6)
    J = rng.normal(size=(32, 12, 6)).astype(np.float32)
    H = (J.transpose(0, 2, 1) @ J + 0.1 * np.eye(6, dtype=np.float32)).astype(np.float32)
    b = rng.normal(size=(32, 6)).astype(np.float32)
    x = pg.solve_spd6(torch.tensor(H), torch.tensor(b))
    _close(x, jl.solve_spd6(jnp.asarray(H), jnp.asarray(b)), 1e-4)
    np.testing.assert_allclose(np.einsum("nij,nj->ni", H, x.numpy()), b, atol=1e-3)
    A = (J[:, :3, :3].transpose(0, 2, 1) @ J[:, :3, :3]).astype(np.float32)
    A[0] = np.diag([2.0, 2.0, 2.0])               # the near-diagonal branch
    ev_p = pg.sym3x3_eigvals(torch.tensor(A)).numpy()
    ev_j = np.asarray(jl.sym3x3_eigvals(jnp.asarray(A)))
    _close(torch.tensor(ev_p), ev_j, 1e-4)
    ev64 = np.linalg.eigvalsh(A.astype(np.float64))
    _assert_eigvals_within(ev_p, ev64)
    _assert_eigvals_within(ev_j, ev64)
    _assert_eigvals_within(ev_p, ev_j, 2)
    # matrix 6 has a condition number of ~1.9e5: each package's is held to
    # the interval its eigenvalue bounds allow around float64's
    _assert_condition_within(pg.condition_number(torch.tensor(A)).numpy(), ev64)
    _assert_condition_within(np.asarray(jl.condition_number(jnp.asarray(A))), ev64)
    np.testing.assert_allclose(pg.condition_number(torch.tensor(H)).numpy(),
                               np.asarray(jl.condition_number(jnp.asarray(H))), rtol=1e-3)


# The closed-form 3x3 eigenvalues e = q + 2p cos(phi + 2k pi/3) of a PSD
# matrix add two terms of at most lam_max (q <= lam_max, 2p <= 2 lam_max / 3),
# each carrying a few float32 roundings (the trace and its third; the 9-term
# sum, the division and the square root of p; the determinant ratio, arccos
# and cos), so an eigenvalue lies within a few eps * lam_max of the exact one
# whatever order a host's reductions and libm take: 4 eps * lam_max is held
# (measured at most 2.15 eps * lam_max, for both packages on two hosts). At a
# condition number of 1.9e5 that is ~10% of lam_min, which no relative
# tolerance on the condition number can state.
EIG_BOUND = 4.0


def _assert_eigvals_within(ev, ref, bounds=1):
    """ev within `bounds` x EIG_BOUND eps lam_max of ref, per matrix."""
    lam_max = np.abs(ref).max(axis=-1, keepdims=True)
    tol = bounds * EIG_BOUND * np.finfo(np.float32).eps * lam_max
    err = np.abs(ev.astype(np.float64) - ref)
    assert (err <= tol).all(), (err / tol).max()


def _assert_condition_within(kappa, ev64):
    """kappa inside [(lam_max - b) / (lam_min + b), (lam_max + b) /
    (lam_min - b)] around float64's eigenvalues, b the eigenvalue bound
    (matrices with lam_min > b)."""
    b = EIG_BOUND * np.finfo(np.float32).eps * np.abs(ev64).max(axis=-1)
    lo, hi = np.abs(ev64[:, 0]), np.abs(ev64[:, -1])
    ok = lo > b
    assert ok.sum() > 20
    kmin, kmax = (hi - b) / (lo + b), (hi + b) / (lo - b)
    k = kappa.astype(np.float64)[ok]
    assert ((k >= kmin[ok] * (1 - 1e-6)) & (k <= kmax[ok] * (1 + 1e-6))).all()


def test_eigenvalue_bound_catches_a_fault():
    """The bound of `test_solve_spd6_eigvals_and_condition` fails an
    eigenvalue off by 10 eps lam_max, and a condition number computed from
    it, on the same matrices."""
    rng = np.random.default_rng(6)
    J = rng.normal(size=(32, 12, 6)).astype(np.float32)
    A = (J[:, :3, :3].transpose(0, 2, 1) @ J[:, :3, :3]).astype(np.float64)
    ev64 = np.linalg.eigvalsh(A)
    _assert_eigvals_within(ev64.astype(np.float32), ev64)
    bad = ev64.copy()
    bad[6, 0] += 10 * np.finfo(np.float32).eps * np.abs(ev64[6]).max()
    with pytest.raises(AssertionError):
        _assert_eigvals_within(bad, ev64)
    with pytest.raises(AssertionError):
        _assert_condition_within(bad[:, -1] / bad[:, 0], ev64)


def _dominant_branch_rotations():
    """One rotation per branch of the Shepperd selection: the trace (a small
    angle), then m00, m11 and m22 (a half turn about x, y and z, tilted)."""
    w = np.asarray([[0.1, -0.2, 0.3], [3.0, 0.2, -0.1], [0.1, 3.0, 0.2],
                    [-0.2, 0.1, 3.0]], np.float32)
    return np.asarray(jg.so3_exp(jnp.asarray(w)))


@pytest.mark.parametrize("kind", ["random", "branches"])
def test_matrix_to_quat_matches_jax(kind):
    """Bit-equal xyzw quaternions: the same float32 formulas, with square
    roots correctly rounded and the norm's squares summed in order by fused
    multiply-adds, as XLA evaluates them on the CPU."""
    if kind == "random":
        rng = np.random.default_rng(12)
        R = np.asarray(jg.so3_exp(jnp.asarray(rng.normal(0, 1.5, (4096, 3)), jnp.float32)))
    else:
        R = _dominant_branch_rotations()
    want = np.asarray(jg.matrix_to_quat(jnp.asarray(R)))
    got = pg.matrix_to_quat(torch.tensor(R)).numpy()
    np.testing.assert_array_equal(got, want)
    if kind == "branches":
        scores = np.stack([np.trace(R, axis1=1, axis2=2), R[:, 0, 0], R[:, 1, 1], R[:, 2, 2]], -1)
        assert scores.argmax(-1).tolist() == [0, 1, 2, 3]
    # and a rotation again, in float64 too
    _close(pg.quat_to_matrix(torch.tensor(got)), R, atol=1e-5)
    R64 = torch.tensor(R, dtype=torch.float64)
    q64 = pg.matrix_to_quat(R64)
    assert q64.dtype == torch.float64
    np.testing.assert_allclose(pg.quat_to_matrix(q64).numpy(), R, atol=1e-6)


@pytest.mark.parametrize("n", [2, 4, 37])
def test_small_products_and_pairwise_sums_round_alike_at_every_batch_size(n):
    """`small_matmul`, `small_matvec` and `pairwise_sum` give a row the same
    bits whatever the batch beside it; on the CPU the small products are the
    batched `@` and einsum themselves, and the pairwise sum of N values lies
    within float32 round-off of torch's sum, exactly the sum for integers."""
    from icp4dradar_tpu_torch.geom.linalg import pairwise_sum, small_matmul, small_matvec

    rng = np.random.default_rng(n)
    A, B = (torch.tensor(rng.normal(size=(n, 4, 4)), dtype=torch.float32) for _ in range(2))
    M, v = (torch.tensor(rng.normal(size=s), dtype=torch.float32) for s in ((n, 3, 3), (n, 3)))
    P = torch.tensor(rng.normal(0, 30, (n, 1000, 3)), dtype=torch.float32)
    assert torch.equal(small_matmul(A, B), A @ B)
    assert torch.equal(small_matvec(M, v), torch.einsum("...ij,...j->...i", M, v))
    for got, one in ((small_matmul(A, B), small_matmul(A[:1], B[:1])),
                     (small_matvec(M, v), small_matvec(M[:1], v[:1])),
                     (small_matmul(P, M), small_matmul(P[:1], M[:1])),
                     (pairwise_sum(P, dim=-2), pairwise_sum(P[:1], dim=-2))):
        assert torch.equal(got[:1], one)
    np.testing.assert_allclose(pairwise_sum(P, dim=-2).numpy(), P.double().sum(-2).numpy(),
                               rtol=1e-5, atol=1e-3)
    counts = torch.tensor(rng.integers(0, 2, (n, 1000)), dtype=torch.float32)
    assert torch.equal(pairwise_sum(counts), counts.sum(-1))


@pytest.mark.parametrize("name", ["quat_conjugate", "quat_multiply", "quat_rotate", "so3_vee",
                                  "se3_rotation", "se3_translation", "se3_compose",
                                  "quat_identity", "masked_lstsq", "batched_solve_psd"])
def test_pose_graph_helpers_match_jax(name):
    """The quaternion / SE(3) helpers and solvers the pose-graph back end
    brought over, on the same inputs (atol 1e-5, and rtol 1e-4 for the
    normal-equation solves, whose systems have entries of order 20)."""
    rng = np.random.default_rng(11)
    q = rng.normal(size=(16, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    T = np.asarray(jg.se3_exp(jnp.asarray(rng.normal(0, 1, (16, 6)).astype(np.float32))))
    A = rng.normal(size=(16, 20, 6)).astype(np.float32)
    b = rng.normal(size=(16, 20)).astype(np.float32)
    m = (rng.uniform(size=(16, 20)) > 0.2).astype(np.float32)
    S = (np.einsum("bni,bnj->bij", A, A) + np.eye(6)).astype(np.float32)
    args = {"quat_conjugate": (q,), "quat_multiply": (q, q[::-1].copy()),
            "quat_rotate": (q, rng.normal(size=(16, 3)).astype(np.float32)),
            "so3_vee": (T[:, :3, :3],), "se3_rotation": (T,), "se3_translation": (T,),
            "se3_compose": (T, T[::-1].copy()), "quat_identity": (),
            "masked_lstsq": (A, b, m), "batched_solve_psd": (S, b[:, :6])}[name]
    want = getattr(jg, name)(*(jnp.asarray(a) for a in args))
    got = getattr(pg, name)(*(torch.from_numpy(a) for a in args))
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=ATOL)


@pytest.mark.parametrize("shapes", [((3, 1), (4,)), ((), (2, 3)), ((0, 1), (1, 5)),
                                    ((2, 1, 3), (4, 1)), ((5,), (5,), (1, 5)), ((1,), (0,)),
                                    ((2,), (3,))])
def test_broadcast_shape_follows_torch_without_importing_sympy(shapes):
    """`broadcast_shape` gives `torch.broadcast_shapes`' shape, or raises
    where it raises, and a fresh process that calls it (and `se3_from_rt`)
    imports no sympy: torch's own helper does on its first call."""
    import os
    import subprocess
    import sys

    from icp4dradar_tpu_torch.geom.linalg import broadcast_shape

    try:
        want = torch.broadcast_shapes(*shapes)
    except RuntimeError:
        with pytest.raises(RuntimeError):
            broadcast_shape(*shapes)
    else:
        assert broadcast_shape(*shapes) == want
    if shapes == ((3, 1), (4,)):
        code = ("import sys, torch\n"
                "from icp4dradar_tpu_torch.geom.linalg import broadcast_shape\n"
                "from icp4dradar_tpu_torch.geom.se3 import se3_from_rt\n"
                "broadcast_shape((3, 1), (4,))\n"
                "se3_from_rt(torch.eye(3), torch.zeros(2, 3))\n"
                "print('sympy' in sys.modules)\n")
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                             text=True, check=True)
        assert out.stdout.strip() == "False"
