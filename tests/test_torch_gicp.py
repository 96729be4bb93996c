"""Port kNN-GICP parity on the CPU: the closed-form eigenvectors and the
Cholesky solve, the plane-regularised covariances and `gicp_align` against
the JAX package on the same numpy inputs.

Tolerances. Eigenvectors of well-separated spectra: 1e-4 (both packages
evaluate the same closed form in float32; XLA contracts some products into
FMAs). Where the smallest eigenvalue repeats, the eigenvector is any unit
vector of its eigenspace, and f32 round-off picks one: the port's is held
to being a unit eigenvector (residual 1e-3 of the spectrum's scale).
Covariances: 2e-4, the eigenvector budget through I - (1 - eps) n n^T,
where the neighbourhood's normal is well defined.
`gicp_align`: the JAX CPU path searches with |p|^2 - 2 p.q + |q|^2 and the
first argmin, the port with exact distances; on a scene at sensor range
(tens of metres) no match flips, and poses agree to 1e-3 m and 1e-4 on
rotation entries, iteration counts within one, fitness to 1e-3 relative."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icp4dradar_tpu.config import GicpConfig
from icp4dradar_tpu.geom import se3_apply as j_se3_apply
from icp4dradar_tpu.geom import se3_exp as j_se3_exp
from icp4dradar_tpu.geom import se3_inverse as j_se3_inverse
from icp4dradar_tpu.geom import linalg as jla
from icp4dradar_tpu.registration import gicp as jg
from icp4dradar_tpu_torch.geom import linalg as pla
from icp4dradar_tpu_torch.registration import gicp as pg
from tests._torch_threads import one_torch_thread  # noqa: F401


def _spd(rng, n, spread=(0.01, 5.0)):
    Q, _ = np.linalg.qr(rng.normal(size=(n, 3, 3)))
    ev = np.sort(rng.uniform(*spread, (n, 3)), axis=-1)
    ev[:, 1] = ev[:, 0] + np.maximum(ev[:, 1] - ev[:, 0], 0.2)
    ev[:, 2] = ev[:, 1] + np.maximum(ev[:, 2] - ev[:, 1], 0.2)
    return np.einsum("nij,nj,nkj->nik", Q, ev, Q).astype(np.float32)


def test_smallest_and_largest_eigvec_match_jax():
    A = _spd(np.random.default_rng(0), 500)
    for jf, pf in ((jla.sym3x3_smallest_eigvec, pla.sym3x3_smallest_eigvec),
                   (jla.sym3x3_largest_eigvec, pla.sym3x3_largest_eigvec)):
        want = np.asarray(jf(jnp.asarray(A)))
        got = pf(torch.tensor(A)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("A,exact", [
    (np.zeros((3, 3)), [0.0, 1.0, 0.0]),                 # M = 0: e_y
    (2.5 * np.eye(3), [0.0, 1.0, 0.0]),                  # isotropic: e_y
    (np.diag([1.0, 1.0, 5.0]), None),                    # repeated smallest
    (np.outer([0.8, 0.6, 0.0], [0.8, 0.6, 0.0]), None),  # rank 1: a plane of minima
])
def test_smallest_eigvec_degenerate(A, exact):
    A = A.astype(np.float32)
    got = pla.sym3x3_smallest_eigvec(torch.tensor(A)[None]).numpy()[0]
    want = np.asarray(jla.sym3x3_smallest_eigvec(jnp.asarray(A)[None]))[0]
    np.testing.assert_allclose(np.linalg.norm(got), 1.0, atol=1e-5)
    lam = np.linalg.eigvalsh(A.astype(np.float64))[0]
    scale = max(1.0, np.abs(A).max())
    np.testing.assert_allclose(A @ got, lam * got, atol=1e-3 * scale)
    if exact is not None:
        np.testing.assert_array_equal(got, exact)
        np.testing.assert_array_equal(got, want)


def test_solve_psd_matches_jax():
    rng = np.random.default_rng(1)
    X = rng.normal(size=(64, 6, 6)).astype(np.float32)
    A = (X @ X.transpose(0, 2, 1) + 0.5 * np.eye(6)).astype(np.float32)
    b = rng.normal(size=(64, 6)).astype(np.float32)
    want = np.asarray(jla.solve_psd(jnp.asarray(A), jnp.asarray(b), damping=1e-3))
    got = pla.solve_psd(torch.tensor(A), torch.tensor(b), damping=1e-3).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    # not positive definite: NaN, as the JAX package's Cholesky gives
    bad = pla.solve_psd(-torch.eye(6), torch.ones(6))
    assert torch.isnan(bad).all()


def test_covariances_from_neighbors_match_jax():
    rng = np.random.default_rng(2)
    q = rng.uniform(-20, 20, (300, 3)).astype(np.float32)
    neigh = (q[:, None, :] + rng.normal(0, 0.5, (300, 5, 3)) * [1.0, 1.0, 0.05]
             ).astype(np.float32)
    valid = rng.uniform(size=(300, 5)) > 0.2
    valid[:5] = False                                   # no neighbour at all
    want = np.asarray(jg.covariances_from_neighbors(jnp.asarray(q), jnp.asarray(neigh),
                                                    jnp.asarray(valid), 1e-3))
    got = pg.covariances_from_neighbors(torch.tensor(q), torch.tensor(neigh),
                                        torch.tensor(valid), 1e-3).numpy()
    # compare where the normal is well defined: the neighbourhood's two
    # smallest eigenvalues 5% of its largest apart (closer ones let f32
    # round-off turn the normal)
    w = valid[..., None].astype(np.float64)
    nk = np.maximum(w.sum(1), 1.0)
    c = (neigh - ((neigh * w).sum(1) / nk)[:, None, :]) * w
    ev = np.linalg.eigvalsh(np.einsum("nki,nkj->nij", c, c) / nk[:, :, None])
    ok = ev[:, 1] - ev[:, 0] > 0.05 * ev[:, 2]
    assert ok.sum() > 200
    np.testing.assert_allclose(got[ok], want[ok], atol=2e-4)
    none = valid.sum(-1) == 0          # no neighbour: isotropic, e_y regularised
    np.testing.assert_array_equal(got[none], want[none])
    # every result has the regularised spectrum (eps, 1, 1)
    np.testing.assert_allclose(np.linalg.eigvalsh(got), [[1e-3, 1.0, 1.0]] * len(got),
                               atol=1e-4)


def _structured(rng, n=900):
    """Ground, a wall and scatter at sensor range: planes for GICP."""
    k = n // 3
    ground = np.stack([rng.uniform(-30, 30, k), rng.uniform(-30, 30, k),
                       rng.normal(0, 0.01, k)], -1)
    wall = np.stack([rng.uniform(-30, 30, k), 12.0 + rng.normal(0, 0.01, k),
                     rng.uniform(0, 6, k)], -1)
    scatter = rng.uniform(-25, 25, (n - 2 * k, 3))
    return np.concatenate([ground, wall, scatter]).astype(np.float32)


def test_point_covariances_match_jax():
    rng = np.random.default_rng(3)
    pts = _structured(rng, 600)
    mask = (rng.uniform(size=600) > 0.1).astype(np.float32)
    want = np.asarray(jg.point_covariances(jnp.asarray(pts), jnp.asarray(mask)))
    got = pg.point_covariances(torch.tensor(pts), torch.tensor(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4)


@pytest.mark.parametrize("xi", [[0.4, -0.3, 0.05, 0.01, -0.02, 0.04],
                                [-0.2, 0.5, 0.0, 0.0, 0.0, -0.06]])
def test_gicp_align_matches_jax(xi):
    rng = np.random.default_rng(4)
    tgt = _structured(rng)
    T_true = j_se3_exp(jnp.asarray(xi, dtype=jnp.float32))
    src = np.array(j_se3_apply(j_se3_inverse(T_true), jnp.asarray(tgt)))
    src = (src + rng.normal(0, 0.01, src.shape)).astype(np.float32)
    sm = (rng.uniform(size=src.shape[0]) > 0.05).astype(np.float32)
    tm = np.ones(tgt.shape[0], np.float32)
    tm[-50:] = 0.0
    cfg = GicpConfig(max_iterations=30)
    jr = jg.gicp_align(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(sm),
                       jnp.asarray(tm), cfg=cfg)
    pr = pg.gicp_align(torch.tensor(src), torch.tensor(tgt), torch.tensor(sm),
                       torch.tensor(tm), cfg=cfg)
    got, want = pr.transform.numpy(), np.asarray(jr.transform)
    np.testing.assert_allclose(got[:3, 3], want[:3, 3], atol=1e-3)
    np.testing.assert_allclose(got[:3, :3], want[:3, :3], atol=1e-4)
    np.testing.assert_allclose(got, np.asarray(T_true), atol=2e-2)
    assert abs(int(pr.iterations) - int(jr.iterations)) <= 1
    assert bool(pr.converged) and bool(jr.converged)
    np.testing.assert_allclose(float(pr.fitness), float(jr.fitness), rtol=1e-3)


def test_gicp_align_with_given_covariances_and_empty_target():
    """Covariances passed in are used as given; an all-masked target
    matches nothing, takes one step of zero and reports fitness 0."""
    rng = np.random.default_rng(5)
    tgt = _structured(rng, 300)
    src = tgt + np.float32(0.05)
    eye = np.broadcast_to(np.eye(3, dtype=np.float32), (300, 3, 3)).copy()
    cfg = GicpConfig(max_iterations=20)
    jr = jg.gicp_align(jnp.asarray(src), jnp.asarray(tgt), cfg=cfg,
                       src_cov=jnp.asarray(eye), tgt_cov=jnp.asarray(eye))
    pr = pg.gicp_align(torch.tensor(src), torch.tensor(tgt), cfg=cfg,
                       src_cov=torch.tensor(eye), tgt_cov=torch.tensor(eye))
    np.testing.assert_allclose(pr.transform.numpy(), np.asarray(jr.transform), atol=1e-4)
    empty = pg.gicp_align(torch.tensor(src), torch.tensor(tgt), tgt_mask=torch.zeros(300),
                          cfg=cfg)
    assert int(empty.iterations) == 1 and float(empty.fitness) == 0.0
    torch.testing.assert_close(empty.transform, torch.eye(4))


# ---- the covariances over the live rows only (`live_point_covariances`,
# what `gicp_align` computes): bit-equal to `point_covariances` on every
# live row, finite on the masked ones.

EYE_EPS = np.diag([1.0, 1.0, 1e-3]).astype(np.float32)


def _masked_cloud(seed, n, live):
    rng = np.random.default_rng(seed)
    pts = _structured(rng, n)
    return pts, (rng.uniform(size=n) < live).astype(np.float32)


@pytest.mark.parametrize("n,live", [(4096, 0.05), (600, 0.9), (300, 1.0)])
def test_live_point_covariances_equal_all_rows(n, live):
    pts, mask = _masked_cloud(n, n, live)
    full = pg.point_covariances(torch.tensor(pts), torch.tensor(mask)).numpy()
    got = pg.live_point_covariances(torch.tensor(pts), torch.tensor(mask)).numpy()
    on = mask > 0.5
    np.testing.assert_array_equal(got[on], full[on])
    np.testing.assert_array_equal(got[~on], np.broadcast_to(EYE_EPS, got[~on].shape))
    assert np.isfinite(got).all()


@pytest.mark.parametrize("live", [0, 1, 4])
def test_live_point_covariances_fall_back_to_the_point(live):
    """Fewer than k = 5 live rows: the missing neighbours are the point
    itself, as in `point_covariances`; no live row: every row masked."""
    rng = np.random.default_rng(7 + live)
    pts = rng.uniform(-20, 20, (64, 3)).astype(np.float32)
    mask = np.zeros(64, np.float32)
    mask[rng.choice(64, live, replace=False)] = 1.0
    full = pg.point_covariances(torch.tensor(pts), torch.tensor(mask)).numpy()
    got = pg.live_point_covariances(torch.tensor(pts), torch.tensor(mask)).numpy()
    on = mask > 0.5
    np.testing.assert_array_equal(got[on], full[on])
    np.testing.assert_array_equal(got[~on], np.broadcast_to(EYE_EPS, got[~on].shape))
    if live == 1:   # a lone point: isotropic, regularised along e_y
        np.testing.assert_allclose(got[on][0], np.diag([1.0, 1e-3, 1.0]), atol=1e-7)


@pytest.mark.parametrize("xi", [[0.4, -0.3, 0.05, 0.01, -0.02, 0.04]])
def test_gicp_align_live_covariances_equal_all_rows(xi):
    """`gicp_align` computing its own covariances (live rows only) equals
    `gicp_align` given `point_covariances`' all-rows output, bit for bit:
    a masked row meets the GN sums with weight 0."""
    rng = np.random.default_rng(8)
    tgt = _structured(rng)
    T_true = j_se3_exp(jnp.asarray(xi, dtype=jnp.float32))
    src = np.array(j_se3_apply(j_se3_inverse(T_true), jnp.asarray(tgt)))
    src = torch.tensor((src + rng.normal(0, 0.01, src.shape)).astype(np.float32))
    sm = torch.tensor((rng.uniform(size=src.shape[0]) > 0.2).astype(np.float32))
    tm = torch.tensor((rng.uniform(size=tgt.shape[0]) > 0.5).astype(np.float32))
    tgt = torch.tensor(tgt)
    cfg = GicpConfig(max_iterations=30)
    own = pg.gicp_align(src, tgt, sm, tm, cfg=cfg)
    given = pg.gicp_align(src, tgt, sm, tm, cfg=cfg, src_cov=pg.point_covariances(src, sm),
                          tgt_cov=pg.point_covariances(tgt, tm))
    assert torch.equal(own.transform, given.transform)
    assert torch.equal(own.fitness, given.fitness)
    assert int(own.iterations) == int(given.iterations) and bool(own.converged)
    np.testing.assert_allclose(own.transform.numpy(), np.asarray(T_true), atol=2e-2)
