"""The port's structure-factor miner (`graph/structure_factors.py`) on the
CPU against the JAX package's: `unpack_cov`, `classify_gaussians` and
`build_structure_factors` on the same map (the JAX package's voxel map,
carried across with `voxel_map_from_numpy`) and the same points; then, port
only, the factors' effect on a pose graph (tests/test_structure_factors.py's
scene). tests/test_torch_pose_graph.py runs the pipeline with them on.

Tolerances: class masks (plane, line, point, and every factor mask) and
keyframe indices exact; eigenvalues, means and body points within 1e-5
relative to their scale (float32 closed-form eigen-solvers, the same
operations in both packages). Factor weights 0.1 / (lam + 0.01) through
their eigenvalue lam, within 5e-5 m^2: a map cell's covariance is E[x^2] -
mu^2 at world scale (|x|^2 ~ 1e3, an ulp ~6e-5), and XLA fuses mu * mu
into the subtraction as an FMA, so a surfel's smallest eigenvalue differs
by up to ~1.2e-5 between the packages. An eigenvector is defined up to its sign,
and the two packages' round-off picks either sign (and, in a cell whose
spectrum is degenerate, any vector of the eigenspace): normals and
directions are held within 1e-4 up to sign where the cell is a surfel or
an edge, a plane factor's (normal, offset) up to one joint sign and a line
factor's ends as an unordered pair (each factor's residual norm is the
same either way).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icp4dradar_tpu.config import StructureFactorConfig as JaxSFConfig
from icp4dradar_tpu.geom import se3_exp as jax_se3_exp
from icp4dradar_tpu.graph import structure_factors as jsf
from icp4dradar_tpu.mapping import voxel_map_create as jax_map_create
from icp4dradar_tpu.mapping import voxel_map_insert as jax_map_insert
from icp4dradar_tpu_torch.config import PipelineConfig, PoseGraphConfig, StructureFactorConfig
from icp4dradar_tpu_torch.graph import PoseGraph, RelPoseFactors, optimize_pose_graph_block
from icp4dradar_tpu_torch.graph import structure_factors as psf
from icp4dradar_tpu_torch.interop import VOXEL_MAP_FIELDS, voxel_map_from_numpy
from tests._torch_threads import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
RTOL = 1e-5


def _close(got, want, name):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1.0) if want.size else 1.0
    np.testing.assert_allclose(got, want, atol=RTOL * scale, err_msg=name)


def _close_up_to_sign(got, want, name, atol=1e-4):
    """Rows of unit vectors equal up to a per-row sign; returns the signs."""
    sign = np.where(np.sum(got * want, axis=-1) < 0, -1.0, 1.0)
    np.testing.assert_allclose(got * sign[:, None], want, atol=atol, err_msg=name)
    return sign


def _cov(pts):
    return np.cov(pts.T, bias=True)


def test_unpack_cov_matches_jax():
    rng = np.random.default_rng(1)
    packed = rng.normal(size=(5, 7, 6)).astype(np.float32)
    want = np.asarray(jsf.unpack_cov(jnp.asarray(packed)))
    np.testing.assert_array_equal(psf.unpack_cov(torch.from_numpy(packed)).numpy(), want)


def test_classify_gaussians_matches_jax():
    rng = np.random.default_rng(0)
    plane = np.stack([rng.uniform(-1, 1, 500), rng.uniform(-1, 1, 500),
                      rng.normal(0, 0.01, 500)], -1)
    line = np.stack([rng.uniform(-1, 1, 500), rng.normal(0, 0.01, 500),
                     rng.normal(0, 0.01, 500)], -1)
    blob = rng.normal(0, 0.5, (500, 3))
    A = rng.normal(size=(60, 3, 3)) * rng.uniform(0.01, 1.0, (60, 1, 3))
    covs = np.concatenate([np.stack([_cov(p) for p in (plane, line, blob)]),
                           A @ A.transpose(0, 2, 1), np.diag([1.0, 1.0, 1e-6])[None]])
    covs = covs.astype(np.float32)
    counts = np.concatenate([[500, 500, 500], rng.integers(0, 12, 60), [2]]).astype(np.float32)
    want = jsf.classify_gaussians(jnp.asarray(covs), jnp.asarray(counts))
    got = psf.classify_gaussians(torch.from_numpy(covs), torch.from_numpy(counts))
    for name, g, w in zip(("is_plane", "is_line"), got[:2], want[:2]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    _close(got[4].numpy(), want[4], "eigvals")
    plane, line = np.asarray(want[0]), np.asarray(want[1])
    _close_up_to_sign(got[2].numpy()[plane], np.asarray(want[2])[plane], "normal")
    _close_up_to_sign(got[3].numpy()[line], np.asarray(want[3])[line], "direction")
    assert bool(got[0][0]) and bool(got[1][1]) and not (bool(got[0][2]) or bool(got[1][2]))
    assert not (bool(got[0][-1]) or bool(got[1][-1]))          # two points: neither


def make_structured_scene(K=24, seed=0, trans_sigma=0.05, rot_sigma=0.003):
    """tests/test_structure_factors.py's scene: poses along x, a ground
    plane, a wall and poles mid-voxel, per-keyframe body-frame scans with
    1 cm noise, initial poses with independent per-frame jitter."""
    rng = np.random.default_rng(seed)
    gt = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    gt[:, 0, 3] = np.arange(K, dtype=np.float32)
    scans = []
    for k in range(K):
        xk = gt[k][0, 3]
        ground = np.stack([rng.uniform(xk - 8, xk + 8, 400), rng.uniform(-6, 6, 400),
                           np.full(400, 0.25)], -1)
        wall = np.stack([rng.uniform(xk - 8, xk + 8, 300), np.full(300, 6.25),
                         rng.uniform(0, 4, 300)], -1)
        poles_x = np.floor(rng.uniform(xk - 8, xk + 8, 100) / 4) * 4 + 0.25
        poles = np.stack([poles_x, np.full(100, -2.75), rng.uniform(0, 4, 100)], -1)
        body = np.concatenate([ground, wall, poles]) - gt[k][:3, 3]
        scans.append((body + rng.normal(0, 0.01, body.shape)).astype(np.float32))
    scans = np.stack(scans)
    init = gt.copy()
    for k in range(1, K):
        xi = np.concatenate([rng.normal(0, trans_sigma, 3), rng.normal(0, rot_sigma, 3)])
        init[k] = init[k] @ np.asarray(jax_se3_exp(jnp.asarray(xi.astype(np.float32))))
    return gt, init, scans


@pytest.fixture(scope="module")
def scene():
    """The scene, its world points at the jittered poses, and the JAX
    package's map of them (capacity 2^14, 0.5 m voxels), as numpy."""
    gt, init, scans = make_structured_scene()
    world = (np.einsum("kij,knj->kni", init[:, :3, :3], scans)
             + init[:, None, :3, 3]).astype(np.float32)
    vm = jax_map_insert(jax_map_create(capacity=1 << 14, voxel_size=0.5),
                        jnp.asarray(world.reshape(-1, 3)))
    arrays = {k: np.asarray(getattr(vm, k)) for k in VOXEL_MAP_FIELDS}
    return gt, init, scans, world, arrays, vm


def test_build_structure_factors_matches_jax(scene):
    gt, init, scans, world, arrays, jvm = scene
    K, N, _ = scans.shape
    rng = np.random.default_rng(3)
    mask = (rng.uniform(size=K * N) > 0.05).astype(np.float32)
    # a few points off the map and beyond the 2 m gate
    p_world = world.reshape(-1, 3).copy()
    p_world[::97] += np.float32([0.0, 0.0, 30.0])
    p_world[5::89] += np.float32([1.5, 0.0, 0.0])
    kf = np.repeat(np.arange(K, dtype=np.int32), N)
    p_body = scans.reshape(-1, 3)
    want = jsf.build_structure_factors(jnp.asarray(kf), jnp.asarray(p_body),
                                       jnp.asarray(p_world), jnp.asarray(mask), jvm)
    vm = voxel_map_from_numpy(arrays, voxel_size=jvm.voxel_size, max_probes=jvm.max_probes,
                              device=CPU)
    got = psf.build_structure_factors(torch.from_numpy(kf), torch.from_numpy(p_body),
                                      torch.from_numpy(p_world), torch.from_numpy(mask), vm)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.mask.numpy(), np.asarray(w.mask))
        np.testing.assert_array_equal(g.k.numpy(), np.asarray(w.k))
        _close(g.p_body.numpy(), w.p_body, "p_body")
        # the eigenvalue behind each weight (weight_scale / w - sigma0^2)
        np.testing.assert_allclose(0.1 / g.weight.numpy(), 0.1 / np.asarray(w.weight), atol=5e-5)
    planes, lines, points = got
    jplanes, jlines, jpoints = want
    _close(points.q_world.numpy(), jpoints.q_world, "q_world")
    on = planes.mask.numpy() > 0.5
    sign = _close_up_to_sign(planes.normal.numpy()[on], np.asarray(jplanes.normal)[on], "normal")
    _close(planes.offset.numpy()[on] * sign, np.asarray(jplanes.offset)[on], "offset")
    on = lines.mask.numpy() > 0.5
    a, b = lines.line_a.numpy()[on], lines.line_b.numpy()[on]
    ja, jb = np.asarray(jlines.line_a)[on], np.asarray(jlines.line_b)[on]
    swap = np.sum((a - ja) ** 2, -1) > np.sum((b - ja) ** 2, -1)
    _close(np.where(swap[:, None], b, a), ja, "line_a")
    _close(np.where(swap[:, None], a, b), jb, "line_b")
    assert float(planes.mask.sum()) > 0.3 * K * N and float(lines.mask.sum()) > 50
    assert float(points.mask.sum()) > 0


def test_structure_factors_reduce_ate(scene):
    """tests/test_structure_factors.py's acceptance on the port: the chain
    measured from the jittered odometry cannot move; one mining round on
    the map from the jittered poses pulls a large share of the jitter
    out."""
    gt, init, scans, world, arrays, jvm = scene
    K, N, _ = scans.shape
    ci = np.arange(K - 1)
    cT = np.stack([np.linalg.inv(init[a]) @ init[a + 1] for a in ci]).astype(np.float32)
    rel = RelPoseFactors.build(ci, ci + 1, cT, np.full(K - 1, 100.0, np.float32), device=CPU)
    vm = voxel_map_from_numpy(arrays, voxel_size=0.5, device=CPU)
    planes, lines, _ = psf.build_structure_factors(
        torch.arange(K).repeat_interleave(N), torch.from_numpy(scans.reshape(-1, 3)),
        torch.from_numpy(world.reshape(-1, 3)), torch.ones(K * N), vm, StructureFactorConfig())

    def ate(poses):
        return float(np.sqrt(np.mean(np.sum((poses[:, :3, 3] - gt[:, :3, 3]) ** 2, -1))))

    cfg = PoseGraphConfig(max_iterations=15)
    poses0 = torch.from_numpy(init)
    out0, _ = optimize_pose_graph_block(PoseGraph(poses=poses0, rel=rel), cfg)
    out1, _ = optimize_pose_graph_block(PoseGraph(poses=poses0, rel=rel, planes=planes,
                                                  lines=lines), cfg)
    ate_init = ate(init)
    assert abs(ate(out0.poses.numpy()) - ate_init) < 0.02
    assert ate(out1.poses.numpy()) < 0.65 * ate_init, (ate(out1.poses.numpy()), ate_init)


def test_config_defaults_match_jax():
    assert StructureFactorConfig() == StructureFactorConfig(**vars(JaxSFConfig()))
    assert PipelineConfig().structure == StructureFactorConfig()
