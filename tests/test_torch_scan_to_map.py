"""Port scan-to-map parity on the CPU: `run_scan_to_map` (10 frames) and
`run_scan_to_map_blocked` (24 frames, block 8, constant-velocity rotation
prior; and 16 frames read from a bag with IMU rotation priors) against the JAX package's CPU run on the same SyntheticSequence,
with JAX's own REVE draws injected; the blocked runner's sequential
fallback on a block of structureless scans; the kNN-GICP tracker
(`gicp.use_vgicp=False`, with and without the exact map k-NN), inner GN
steps, and both knobs in the blocked runner; mapping on ground truth
(`gt_poses`, `insert_before_registration`) in the per-frame runner and the
per-frame batch; the CLI's default scene against the JAX package; the
CLI's scan_to_map mode (B-stream serving and forgetting are in
tests/test_torch_batch.py and tests/test_torch_forget.py, scan
accumulation and the rigid block union in tests/test_torch_accumulate.py).

Tolerance. REVE, the map and the sector query agree exactly on the same
inputs (tests/test_torch_voxel_map.py, tests/test_torch_reve.py), but the
JAX package's CPU registration is not its TPU kernel: it forms d2 as
|p|^2 - 2 p.q + |q|^2, takes the first argmin and inverts with
jnp.linalg.inv, where the port follows the kernel (exact d2, tie average,
closed-form inverse). The GN steps therefore stop at slightly different
points (the convergence test is sum |xi| < 5e-4), and a frame may take one
or two sweeps more or fewer. Positions agree within 1e-2 m, rotation
entries within 1e-3, ATE within 1e-3 m; inlier counts are equal, submap
sizes within 1% plus two voxels. JAX's own run moves as much when the
scans move by one ulp, and which way a host's float32 reductions round
decides the last bit (`scripts/port_host_rounding.py`: the port's CPU
outputs differ between two hosts), so the blocked tracker is held to
either of two JAX runs one ulp apart, and maps on ground truth within
float32's rounding of their points (`_assert_same_map`)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icp4dradar_tpu.config import PipelineConfig as JaxConfig
from icp4dradar_tpu.io import RadarBagDataset as JaxBagDataset
from icp4dradar_tpu.io import SyntheticSequence as JaxSequence
from icp4dradar_tpu.io import write_synthetic_bag as jax_write_bag
from icp4dradar_tpu.io.scan import stack_scans as jax_stack
from icp4dradar_tpu.models import run_scan_to_map as j_run
from icp4dradar_tpu.models import run_scan_to_map_batch as j_batch
from icp4dradar_tpu.models import run_scan_to_map_blocked as j_run_blocked
from icp4dradar_tpu.preprocess import imu_prior_deltas as jax_prior_deltas
from icp4dradar_tpu_torch.io import RadarBagDataset, SyntheticSequence, write_synthetic_bag
from icp4dradar_tpu_torch.interop import (
    SCAN_FIELDS,
    config_from_dict,
    scans_from_numpy,
)
from icp4dradar_tpu_torch.models import run_odometry
from icp4dradar_tpu_torch.models import scan_to_map as pm
from icp4dradar_tpu_torch.preprocess import imu_prior_deltas
from icp4dradar_tpu_torch.preprocess.reve import reve_hypotheses
from icp4dradar_tpu_torch.utils import ate_rmse, reve_batch_uniforms, reve_uniforms
from tests._torch_threads import one_torch_thread  # noqa: F401

T_ATOL, R_ATOL, ATE_ATOL = 1e-2, 1e-3, 1e-3
F, N = 24, 512


def _cfg():
    """The small config of tests/test_models.py."""
    return JaxConfig().override(**{
        "voxel_map.capacity": 1 << 14, "voxel_map.submap_max_points": 1 << 12,
        "icp.max_iterations": 15, "gicp.max_iterations": 15})


def _sequence(junk=False, n=N):
    seq = JaxSequence(num_frames=F, max_points=n, num_landmarks=4000, world_extent=80.0,
                      max_range=60.0, dynamic_fraction=0.05, pos_noise=0.01, speed=1.0,
                      turn_rate=0.03, seed=0)
    js = jax_stack([seq.scan(k) for k in range(F)])
    if junk:
        # half a block of structureless junk (an interference burst): ghost
        # points 40-60 m above the road, where they match no structure
        xyz = np.asarray(js.xyz).copy()
        rng = np.random.default_rng(7)
        xyz[12:16] = rng.uniform(-60, 60, xyz[12:16].shape)
        xyz[12:16, :, 2] = rng.uniform(40, 60, xyz[12:16, :, 2].shape)
        js = js.replace(xyz=jnp.asarray(xyz.astype(np.float32)))
    ps = scans_from_numpy({k: np.asarray(getattr(js, k)) for k in SCAN_FIELDS},
                          device="cpu")
    return seq, js, ps


def _draws(keys, H):
    return np.stack([np.asarray(jax.random.uniform(k, (3 * H,))) for k in keys])


def _blocked_draws(cfg, F, block):
    """The draws of JAX's run_scan_to_map_blocked: warm-up frames from
    split(kwarm, block), the blocks from split(kblocks, F - block)."""
    H = reve_hypotheses(cfg.reve)
    kwarm, kblocks = jax.random.split(jax.random.key(cfg.seed))
    return torch.tensor(np.concatenate([_draws(jax.random.split(kwarm, block), H),
                                        _draws(jax.random.split(kblocks, F - block), H)]))


def _assert_tracks(po, jo, seq):
    pw, jw = po.world_T.numpy(), np.asarray(jo.world_T)
    assert np.isfinite(pw).all()
    np.testing.assert_allclose(pw[:, :3, 3], jw[:, :3, 3], atol=T_ATOL)
    np.testing.assert_allclose(pw[:, :3, :3], jw[:, :3, :3], atol=R_ATOL)
    n = pw.shape[0]
    ate_p = ate_rmse(pw[:, :3, 3], seq.poses[:n, :3, 3], align=False)
    ate_j = ate_rmse(jw[:, :3, 3], seq.poses[:n, :3, 3], align=False)
    assert abs(ate_p - ate_j) < ATE_ATOL, (ate_p, ate_j)
    np.testing.assert_array_equal(po.num_inliers.numpy(), np.asarray(jo.num_inliers))
    # a stored point that lands a few mm elsewhere may cross a voxel or the
    # sector's edge: submap sizes agree to a few voxels
    np.testing.assert_allclose(po.submap_points.numpy(), np.asarray(jo.submap_points),
                               rtol=0.01, atol=2)
    np.testing.assert_array_equal(po.velocity_valid.numpy(), np.asarray(jo.velocity_valid))
    np.testing.assert_allclose(po.velocity.numpy(), np.asarray(jo.velocity), rtol=1e-4,
                               atol=1e-5)
    assert np.abs(po.iterations.numpy() - np.asarray(jo.iterations)).max() <= 2
    return ate_p


def _nudged(js):
    """The JAX scans with every coordinate moved by one ulp (toward +inf).
    A second JAX run on them measures JAX's own spread: on the blocked
    test's sequence a frame's GN sweeps there differ from the first run's by
    up to 3 (frame 12: 7 against 10), and by up to 5 with the coordinates
    moved toward -inf."""
    return js.replace(xyz=jnp.asarray(np.nextafter(np.asarray(js.xyz), np.float32(np.inf))))


def _assert_tracks_one_of(po, refs, seq):
    """`_assert_tracks` against the first of `refs` it holds for -> (ATE,
    that reference)."""
    failures = []
    for ref in refs:
        try:
            return _assert_tracks(po, ref, seq), ref
        except AssertionError as e:
            failures.append(e)
    raise AssertionError(failures)


def test_run_scan_to_map_matches_jax():
    cfg = _cfg()
    seq, js, ps = _sequence()
    n = 10
    js, ps = jax.tree.map(lambda x: x[:n], js), ps[:n]
    U = _draws(jax.random.split(jax.random.key(cfg.seed), n), reve_hypotheses(cfg.reve))
    jst, jo = j_run(js, cfg)
    pst, po = pm.run_scan_to_map(ps, config_from_dict(cfg.to_dict()),
                                 uniforms=torch.tensor(U))
    ate = _assert_tracks(po, jo, seq)
    assert ate < 0.3
    assert abs(float(pst.vmap.num_voxels) - float(jst.vmap.num_voxels)) <= 5
    assert po.world_T.shape == (n, 4, 4) and po.insert_mask.shape == (n, N)


def test_run_scan_to_map_blocked_matches_jax():
    cfg = _cfg()
    seq, js, ps = _sequence()
    jst, jo = j_run_blocked(js, cfg, block=8, use_const_velocity_rot=True)
    before = pm.SEQUENTIAL_FALLBACK_BLOCKS
    pst, po = pm.run_scan_to_map_blocked(ps, config_from_dict(cfg.to_dict()),
                                         uniforms=_blocked_draws(cfg, F, 8), block=8,
                                         use_const_velocity_rot=True)
    assert pm.SEQUENTIAL_FALLBACK_BLOCKS == before       # a healthy sequence
    # the port against either of two JAX runs one ulp apart (`_nudged`)
    _, jn = j_run_blocked(_nudged(js), cfg, block=8, use_const_velocity_rot=True)
    ate, ref = _assert_tracks_one_of(po, [jo, jn], seq)
    assert ate < 0.3
    np.testing.assert_allclose(po.fitness.numpy(), np.asarray(ref.fitness), rtol=5e-3,
                               atol=1e-4)
    assert abs(float(pst.vmap.num_voxels) - float(jst.vmap.num_voxels)) <= 10


def test_blocked_imu_priors_from_a_bag_match_jax(tmp_path):
    """The bag path of the CLI's --imu-prior: each package writes the
    16-frame sequence as a synthetic bag, reads it back with its
    RadarBagDataset, turns the IMU batches into `imu_prior_deltas` and
    tracks with `run_scan_to_map_blocked(block=8, use_const_velocity_rot=True,
    prior_deltas=...)` on JAX's draws. The port is held to JAX at this
    file's tolerances; the port's run without the prior is not (its track
    lies 0.13 m from JAX's prior run), so the priors are what is compared."""
    cfg, pcfg = _cfg(), config_from_dict(_cfg().to_dict())
    kw = dict(num_frames=16, max_points=N, num_landmarks=4000, world_extent=80.0,
              max_range=60.0, dynamic_fraction=0.05, pos_noise=0.01, speed=1.0,
              turn_rate=0.03, seed=0)
    topics = dict(topic_radar="/radar", topic_gt="/gt", topic_imu="/imu", max_points=N)
    jseq, pseq = JaxSequence(**kw), SyntheticSequence(**kw)
    jax_write_bag(os.fspath(tmp_path / "jax.bag"), jseq)
    write_synthetic_bag(os.fspath(tmp_path / "port.bag"), pseq)
    jds = JaxBagDataset(os.fspath(tmp_path / "jax.bag"), **topics)
    pds = RadarBagDataset(os.fspath(tmp_path / "port.bag"), **topics)
    assert len(pds) == 16
    jP, pP = jax_prior_deltas(jds.frames), imu_prior_deltas(pds.frames)
    np.testing.assert_array_equal(pP, jP)
    _, jo = j_run_blocked(jds.stacked_scans(), cfg, block=8, use_const_velocity_rot=True,
                          prior_deltas=jP)
    ps = pds.stacked_scans("cpu")
    U = torch.from_numpy(reve_uniforms(cfg.seed, 16, 8, reve_hypotheses(pcfg.reve)))
    before = pm.SEQUENTIAL_FALLBACK_BLOCKS
    _, po = pm.run_scan_to_map_blocked(ps, pcfg, uniforms=U, block=8,
                                       use_const_velocity_rot=True,
                                       prior_deltas=torch.from_numpy(pP))
    assert pm.SEQUENTIAL_FALLBACK_BLOCKS == before
    _assert_tracks(po, jo, jseq)
    _, pn = pm.run_scan_to_map_blocked(ps, pcfg, uniforms=U, block=8,
                                       use_const_velocity_rot=True)
    moved = np.abs(pn.world_T.numpy()[:, :3, 3] - np.asarray(jo.world_T)[:, :3, 3]).max()
    assert moved > 10 * T_ATOL, moved


def test_blocked_sequential_fallback_contains_adverse_block():
    """A block with four frames of junk looks lost after the joint GN; the
    block re-tracks frame by frame, the pose stays finite and proper, and
    tracking recovers after the outage (tests/test_models.py's case at 1024
    points, with its junk lifted 40-60 m above the road). The junk frames
    match nothing and are not compared. Junk spread through the whole
    scene, as tests/test_models.py draws it, registers chaotically: there
    the JAX package's own single-stream run and its vmapped run of the same
    stream end 2.8 m apart, so no comparison with it is stable."""
    cfg = _cfg()
    seq, js, ps = _sequence(junk=True, n=1024)
    _, jo = j_run_blocked(js, cfg, block=8, use_const_velocity_rot=True)
    before = pm.SEQUENTIAL_FALLBACK_BLOCKS
    _, po = pm.run_scan_to_map_blocked(ps, config_from_dict(cfg.to_dict()),
                                       uniforms=_blocked_draws(cfg, F, 8), block=8,
                                       use_const_velocity_rot=True)
    assert pm.SEQUENTIAL_FALLBACK_BLOCKS > before
    P, jw = po.world_T.numpy(), np.asarray(jo.world_T)
    assert np.isfinite(P).all()
    np.testing.assert_allclose(np.linalg.det(P[:, :3, :3]), 1.0, atol=1e-2)
    for w in (P, jw):
        err = np.linalg.norm(w[:, :3, 3] - seq.poses[:, :3, 3], axis=1)
        assert err[-3:].max() < 0.6, err
    sane = np.r_[0:12, 16:F]
    np.testing.assert_allclose(P[sane, :3, 3], jw[sane, :3, 3], atol=T_ATOL)
    np.testing.assert_array_equal(po.num_inliers.numpy(), np.asarray(jo.num_inliers))


def test_sequential_blocks_and_no_fallback_run():
    cfg = config_from_dict(_cfg().to_dict())
    seq, _, ps = _sequence()
    ps = ps[:16]
    g = torch.Generator().manual_seed(3)
    _, a = pm.run_scan_to_map_blocked(ps, cfg, generator=g, block=8,
                                      use_const_velocity_rot=True, parallel_frames=False)
    _, b = pm.run_scan_to_map_blocked(ps, cfg, block=8, use_const_velocity_rot=True,
                                      sequential_fallback=False)
    for o in (a, b):
        assert torch.isfinite(o.world_T).all() and o.world_T.shape == (16, 4, 4)
        err = np.linalg.norm(o.world_T.numpy()[:, :3, 3] - seq.poses[:16, :3, 3], axis=1)
        assert err.max() < 0.5, err
    with pytest.raises(ValueError):
        pm.run_scan_to_map_blocked(ps[:14], cfg, block=4)


def _world_scale(G, xyz):
    """Per coordinate, the largest sum of magnitudes, |R| |x| + |t|, that a
    float32 world point R x + t is formed from, over the poses (..., 4, 4)
    and the scans (..., N, 3) inserted at them."""
    R, t = np.abs(G[..., :3, :3]).astype(np.float64), np.abs(G[..., :3, 3]).astype(np.float64)
    s = np.einsum("...ij,...nj->...ni", R, np.abs(np.asarray(xyz, np.float64))) + t[..., None, :]
    return s.reshape(-1, 3).max(axis=0)


def _assert_same_map(pmap, jmap, scale):
    """Keys, counts, occupancy and intensities equal; the point and the
    moment sums of each voxel within what float32 allows. A world point R x
    + t is a sum of four terms of at most `scale` (per coordinate), so each
    package's lies within 2 eps scale of the exact value (gamma_4, unit
    roundoff eps / 2) and the two within 4 eps scale: a host's reductions
    (FMA or not, the order of a library product) decide the last bit. A
    voxel's sum of n points then differs by n 4 eps scale from its inputs
    plus (n - 1) n eps scale from the two summations, in any order: n (n +
    3) eps scale; a second-moment entry p_a p_b by 9 eps scale_a scale_b a
    term plus the summations: n (n + 8) eps scale_a scale_b."""
    for k in ("keys", "intensity", "occupied", "stat_n"):
        np.testing.assert_array_equal(getattr(pmap, k).numpy(), np.asarray(getattr(jmap, k)),
                                      err_msg=k)
    eps = float(np.finfo(np.float32).eps)
    n = np.asarray(jmap.stat_n, np.float64)[..., None]
    sq = np.asarray([scale[a] * scale[b] for a, b in ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2),
                                                      (1, 2))])
    for k, tol in (("points", 4 * eps * scale), ("stat_sum", n * (n + 3) * eps * scale),
                   ("stat_sq", n * (n + 8) * eps * sq)):
        err = np.abs(getattr(pmap, k).numpy().astype(np.float64) - np.asarray(getattr(jmap, k)))
        assert (err <= tol).all(), (k, float((err / np.maximum(tol, 1e-300)).max()))


@pytest.mark.parametrize("gt,before", [(True, True), (True, False), (False, True)])
def test_run_scan_to_map_on_ground_truth_matches_jax(gt, before):
    """Mapping on ground truth (`gt_poses`: each frame predicted at its
    pose, no prior, no Doppler step) and inserting before registration,
    against JAX on its own draws. With both, every insert happens at a
    ground-truth pose, so the maps hold the same voxels, counts and
    intensities, their points and moment sums within float32's rounding of
    R x + t (`_assert_same_map`); the corrections registration reports
    agree within the trackers' tolerance."""
    cfg = _cfg()
    seq, js, ps = _sequence()
    n = 10
    js, ps = jax.tree.map(lambda x: x[:n], js), ps[:n]
    G = seq.poses[:n].astype(np.float32) if gt else None
    U = _draws(jax.random.split(jax.random.key(cfg.seed), n), reve_hypotheses(cfg.reve))
    jst, jo = j_run(js, cfg, gt_poses=None if G is None else jnp.asarray(G),
                    insert_before_registration=before, use_const_velocity_rot=True)
    pst, po = pm.run_scan_to_map(ps, config_from_dict(cfg.to_dict()), uniforms=torch.tensor(U),
                                 gt_poses=None if G is None else torch.tensor(G),
                                 insert_before_registration=before,
                                 use_const_velocity_rot=True)
    if before:
        # a scan registers against a map that already holds it: zero
        # residuals at the prediction, where the JAX CPU oracle's expanded
        # distances (|p|^2 - 2 p.q + |q|^2) leave ~1e-5 m^2 of cancellation
        # noise that keeps its GN sweeping (up to the cap) after the port's
        # exact distances have converged
        pw, jw = po.world_T.numpy(), np.asarray(jo.world_T)
        np.testing.assert_allclose(pw[:, :3, 3], jw[:, :3, 3], atol=T_ATOL)
        np.testing.assert_allclose(pw[:, :3, :3], jw[:, :3, :3], atol=R_ATOL)
        np.testing.assert_array_equal(po.num_inliers.numpy(), np.asarray(jo.num_inliers))
        np.testing.assert_array_equal(po.insert_mask.numpy(), np.asarray(jo.insert_mask))
        assert (po.iterations.numpy() <= np.asarray(jo.iterations)).all()
    else:
        _assert_tracks(po, jo, seq)
    np.testing.assert_allclose(po.correction.numpy(), np.asarray(jo.correction), atol=T_ATOL)
    if gt:
        # the prediction is the ground-truth pose: world_T = correction @ gt
        np.testing.assert_allclose(po.world_T.numpy(), po.correction.numpy() @ G, atol=1e-5)
    if gt and before:
        _assert_same_map(pst.vmap, jst.vmap, _world_scale(G, np.asarray(js.xyz)))
    else:
        assert abs(float(pst.vmap.num_voxels) - float(jst.vmap.num_voxels)) <= 5


@pytest.mark.parametrize("fault", ["none", "point", "count", "sum", "position", "ate",
                                   "sweeps"])
def test_repaired_comparisons_catch_faults(fault):
    """The comparisons that hold the port to JAX within float32's rounding
    still fail a fault of the size they guard. `_assert_same_map` on a map
    against itself with one point moved by 1e-3 m, one count off by one, or
    one moment sum off by 1e-3 m; `_assert_tracks_one_of` against two
    references one sweep apart on a frame, with one pose moved by 2e-2 m,
    every pose moved by 1.5e-3 m (the ATE tolerance is 1e-3 m), or a frame's
    sweeps three from both references."""
    from icp4dradar_tpu_torch.io import SyntheticSequence as PortSequence

    seq = PortSequence(num_frames=4, max_points=128, num_landmarks=2000, seed=3)
    if fault in ("none", "point", "count", "sum"):
        cfg = config_from_dict(_cfg().to_dict())
        G = seq.poses[:4].astype(np.float32)
        xyz = np.stack([seq.scan(k).xyz.numpy() for k in range(4)])
        vm = pm.scan_to_map_init(cfg, device="cpu").vmap
        for k in range(4):
            sc = seq.scan(k)
            vm = pm.voxel_map_insert(vm, pm.se3_apply(torch.tensor(G[k]), sc.xyz), sc.mask,
                                     sc.intensity)
        ref = vm.with_tables(t.clone() for t in vm.tables())
        live = int(torch.nonzero(vm.occupied)[0, 0])
        if fault == "point":
            vm.points[live, 1] += 1e-3
        elif fault == "count":
            vm.stat_n[live] += 1.0
        elif fault == "sum":
            vm.stat_sum[live, 2] += 1e-3
        check = lambda: _assert_same_map(vm, ref, _world_scale(G, xyz))  # noqa: E731
    else:
        n = 4
        gt = seq.poses[:n].astype(np.float32)
        it = np.asarray([1, 5, 4, 6], np.int32)

        def outputs(world_T, iterations):
            z = np.zeros(n, np.float32)
            return pm.ScanToMapOutput(
                world_T=torch.tensor(world_T), correction=torch.tensor(world_T),
                velocity=torch.zeros(n, 3), velocity_sigma=torch.zeros(n, 3),
                velocity_valid=torch.ones(n, dtype=torch.bool), fitness=torch.tensor(z),
                num_inliers=torch.tensor(z), submap_points=torch.tensor(z),
                iterations=torch.tensor(iterations), insert_mask=torch.zeros(n, 8))

        refs = [outputs(gt, it), outputs(gt, it + np.asarray([0, 0, 1, 0], np.int32))]
        P, its = gt.copy(), it.copy()
        if fault == "position":
            P[2, 0, 3] += 2e-2
        elif fault == "ate":
            P[:, 0, 3] += 1.5e-3
        elif fault == "sweeps":
            its[3] += 3
        check = lambda: _assert_tracks_one_of(outputs(P, its), refs, seq)  # noqa: E731
    if fault == "none":
        check()
    else:
        with pytest.raises(AssertionError):
            check()


@pytest.mark.parametrize("per_stream", [False, True])
def test_batch_on_ground_truth_matches_jax(per_stream):
    """The per-frame batch with `gt_poses` and insert-before-registration:
    JAX's batch closes over its keyword arguments, so it takes one (F, 4, 4)
    track that every stream follows; the port takes that, and a (B, F, 4, 4)
    track per stream, whose stream equals the single-stream runner bit for
    bit."""
    cfg = _cfg()
    pcfg = config_from_dict(cfg.to_dict())
    seq, js, ps = _sequence()
    B, n = 2, 6
    jb = jax.tree.map(lambda x: x[:B * n].reshape((B, n) + x.shape[1:]), js)
    pb = scans_from_numpy({k: np.asarray(getattr(jb, k)) for k in SCAN_FIELDS}, device="cpu")
    G = seq.poses[:B * n].astype(np.float32).reshape(B, n, 4, 4)
    U = torch.from_numpy(reve_batch_uniforms(cfg.seed, B, n, 0, reve_hypotheses(cfg.reve)))
    if per_stream:
        pst, po = pm.run_scan_to_map_batch(pb, pcfg, uniforms=U, gt_poses=torch.tensor(G),
                                           insert_before_registration=True)
        for b in range(B):
            sst, so = pm.run_scan_to_map(pb[b], pcfg, uniforms=U[b],
                                         gt_poses=torch.tensor(G[b]),
                                         insert_before_registration=True)
            for f in ("world_T", "correction", "fitness", "iterations", "insert_mask"):
                assert torch.equal(getattr(po, f)[b], getattr(so, f)), f
            for a, c in zip(pst.vmap.stream(b).tables(), sst.vmap.tables()):
                assert torch.equal(a, c)
        return
    jst, jo = j_batch(jb, cfg, gt_poses=jnp.asarray(G[0]), insert_before_registration=True)
    pst, po = pm.run_scan_to_map_batch(pb, pcfg, uniforms=U, gt_poses=torch.tensor(G[0]),
                                       insert_before_registration=True)
    for b in range(B):
        np.testing.assert_allclose(po.world_T[b].numpy(), np.asarray(jo.world_T[b]),
                                   atol=T_ATOL)
        np.testing.assert_allclose(po.correction[b].numpy(), np.asarray(jo.correction[b]),
                                   atol=T_ATOL)
        np.testing.assert_array_equal(po.num_inliers[b].numpy(),
                                      np.asarray(jo.num_inliers[b]))
        _assert_same_map(pst.vmap.stream(b), jax.tree.map(lambda x: x[b], jst.vmap),
                         _world_scale(G[0], np.asarray(jb.xyz[b])))


def _per_frame_pair(override, n=10):
    """The JAX CPU run and the port's of the first n frames under `override`,
    on JAX's own REVE draws."""
    cfg = _cfg().override(**override)
    seq, js, ps = _sequence()
    js, ps = jax.tree.map(lambda x: x[:n], js), ps[:n]
    U = _draws(jax.random.split(jax.random.key(cfg.seed), n), reve_hypotheses(cfg.reve))
    _, jo = j_run(js, cfg)
    _, po = pm.run_scan_to_map(ps, config_from_dict(cfg.to_dict()), uniforms=torch.tensor(U))
    return seq, jo, po


def test_run_scan_to_map_knn_gicp_matches_jax():
    """kNN GICP (`gicp.use_vgicp=False`): world-frame points against the
    sector submap's stored points, submap-local k-NN covariances. The JAX
    CPU search forms |p|^2 - 2 p.q + |q|^2 and takes the first argmin, the
    port (like the TPU kernel) forms exact distances, so a frame may take
    one or two iterations more or fewer; tracks agree within the tolerances
    of the VGICP runs, fitness within 2e-3 relative."""
    seq, jo, po = _per_frame_pair({"gicp.use_vgicp": False})
    ate = _assert_tracks(po, jo, seq)
    assert ate < 0.5
    np.testing.assert_allclose(po.fitness.numpy(), np.asarray(jo.fitness), rtol=2e-3,
                               atol=1e-5)
    assert int(po.iterations[0]) == 1                  # empty map: one zero step


def test_run_scan_to_map_knn_gicp_exact_map_knn_tracks_like_jax():
    """`gicp.use_exact_map_knn=True`: the submap's covariances from the
    exact whole-map k-NN. Its neighbourhoods within 2 m often hold two
    points, a line, whose normal is any direction orthogonal to it; both
    packages' closed form then picks it by f32 round-off (a repeated
    smallest eigenvalue is detected only below 1e-24 of the spectrum,
    far under f32 round-off), so the tracks part by a few decimetres. Held:
    the first frames equal, the same ATE within 0.05 m, below 0.5 m, and
    within 0.2 m of the submap-local path (tests/test_models.py's bound)."""
    seq, jo, po = _per_frame_pair({"gicp.use_vgicp": False,
                                   "gicp.use_exact_map_knn": True})
    pw, jw = po.world_T.numpy(), np.asarray(jo.world_T)
    assert np.isfinite(pw).all()
    np.testing.assert_allclose(pw[:2, :3, 3], jw[:2, :3, 3], atol=T_ATOL)
    gt = seq.poses[:10, :3, 3]
    ate_p = ate_rmse(pw[:, :3, 3], gt, align=False)
    ate_j = ate_rmse(jw[:, :3, 3], gt, align=False)
    assert abs(ate_p - ate_j) < 0.05 and ate_p < 0.5, (ate_p, ate_j)
    _, _, base = _per_frame_pair({"gicp.use_vgicp": False})
    assert ate_p < ate_rmse(base.world_T.numpy()[:, :3, 3], gt, align=False) + 0.2


def test_run_scan_to_map_inner_gn_steps():
    """`gicp.inner_gn_steps=1` on the CPU: each GN body is one sweep and one
    frozen step, so every frame counts an even number of iterations; the
    track stays within 5 cm of the `inner_gn_steps=0` run (z, which a radar
    scan constrains least, moves most) and its ATE within 1.5 times that
    run's plus 5 mm, the bound `chip_smoke.py` holds the card to. The JAX
    CPU path ignores the knob (its TPU path runs it), so the reference is
    the port's own run without inner steps."""
    cfg = config_from_dict(_cfg().to_dict())
    seq, _, ps = _sequence()
    g = torch.Generator().manual_seed(0)
    U = pm.draw_reve_uniforms((10,), cfg.reve, g)
    _, a = pm.run_scan_to_map(ps[:10], cfg, uniforms=U)
    _, b = pm.run_scan_to_map(ps[:10], cfg.override(**{"gicp.inner_gn_steps": 1}),
                              uniforms=U)
    assert (b.iterations % 2 == 0).all() and (b.iterations >= 2).all()
    pa, pb = a.world_T.numpy()[:, :3, 3], b.world_T.numpy()[:, :3, 3]
    np.testing.assert_allclose(pb, pa, atol=5e-2)
    gt = seq.poses[:10, :3, 3]
    assert ate_rmse(pb, gt, align=False) <= 1.5 * ate_rmse(pa, gt, align=False) + 5e-3


def test_blocked_warm_up_honours_use_vgicp_like_jax():
    """`run_scan_to_map_blocked` with `gicp.use_vgicp=False` runs its warm-up
    frames on kNN GICP and its blocks on VGICP, as the JAX package does
    (its blocks always call vgicp_align); it used to raise."""
    cfg = _cfg().override(**{"gicp.use_vgicp": False})
    seq, js, ps = _sequence()
    _, jo = j_run_blocked(js, cfg, block=8, use_const_velocity_rot=True)
    pcfg = config_from_dict(cfg.to_dict())
    U = _blocked_draws(cfg, F, 8)
    _, po = pm.run_scan_to_map_blocked(ps, pcfg, uniforms=U, block=8,
                                       use_const_velocity_rot=True)
    ate = _assert_tracks(po, jo, seq)
    assert ate < 0.3
    # the warm-up is the per-frame kNN-GICP tracker on the same draws
    _, warm = pm.run_scan_to_map(pm._sort_scans_by_sensor_x(ps[:8]), pcfg, uniforms=U[:8],
                                 use_const_velocity_rot=True)
    torch.testing.assert_close(po.world_T[:8], warm.world_T, rtol=0, atol=0)


def test_blocked_runner_accepts_inner_gn_steps():
    """With `gicp.inner_gn_steps=1` the blocked runner's warm-up frames take
    inner steps (even iteration counts) and its blocks ignore the knob, as
    the JAX package's blocks do; it used to raise. The JAX CPU run ignores
    the knob everywhere, so it is held as the per-frame inner-step run is:
    positions within 5 cm, ATE within 1.5 times JAX's plus 5 mm."""
    cfg = _cfg()
    seq, js, ps = _sequence()
    _, jo = j_run_blocked(js, cfg, block=8, use_const_velocity_rot=True)
    _, po = pm.run_scan_to_map_blocked(
        ps, config_from_dict(cfg.override(**{"gicp.inner_gn_steps": 1}).to_dict()),
        uniforms=_blocked_draws(cfg, F, 8), block=8, use_const_velocity_rot=True)
    assert (po.iterations[:8] % 2 == 0).all()
    pw, jw = po.world_T.numpy()[:, :3, 3], np.asarray(jo.world_T)[:, :3, 3]
    np.testing.assert_allclose(pw, jw, atol=5e-2)
    gt = seq.poses[:, :3, 3]
    assert ate_rmse(pw, gt, align=False) <= 1.5 * ate_rmse(jw, gt, align=False) + 5e-3


def test_cli_default_scene_tracks_like_jax():
    """The CLI's default synthetic scene (`models/run_odometry.py`: 20,000
    landmarks, 2 m a frame), 12 frames of 512 points, per-frame VGICP with
    the constant-velocity rotation prior: the port reproduces the JAX
    package frame by frame, on JAX's own REVE draws. Its scans subsample a
    scene four times denser than the bench scene's, so consecutive scans
    share few points and the registration's fitness stays near 1-2 m^2;
    the tracking gate then holds every frame after the first at its
    prediction in both packages (only frame 0 is inserted, the track
    dead-reckons and the submap shrinks as the sensor drives away). The
    high fitness there is the scene's, not a parity fault."""
    n = 12
    cfg = JaxConfig().override(**{"voxel_map.capacity": 1 << 15,
                                  "voxel_map.submap_max_points": 1 << 12, "max_points": 512})
    seq = JaxSequence(num_frames=n, max_points=512, num_landmarks=20000, seed=0)
    js = jax_stack([seq.scan(k) for k in range(n)])
    ps = scans_from_numpy({k: np.asarray(getattr(js, k)) for k in SCAN_FIELDS}, device="cpu")
    U = _draws(jax.random.split(jax.random.key(cfg.seed), n), reve_hypotheses(cfg.reve))
    _, jo = j_run(js, cfg, use_const_velocity_rot=True)
    _, po = pm.run_scan_to_map(ps, config_from_dict(cfg.to_dict()), uniforms=torch.tensor(U),
                               use_const_velocity_rot=True)
    ate = _assert_tracks(po, jo, seq)
    np.testing.assert_allclose(po.fitness.numpy(), np.asarray(jo.fitness), rtol=1e-3,
                               atol=1e-5)
    inserted = po.insert_mask.numpy().sum(axis=1)
    np.testing.assert_array_equal(inserted, np.asarray(jo.insert_mask).sum(axis=1))
    assert inserted[0] > 0 and (inserted[1:] == 0).all()
    assert np.median(po.fitness.numpy()[1:]) > cfg.tracking.max_fitness and ate > 0.5


def test_cli_scan_to_map_knn_gicp(tmp_path, capsys):
    out = tmp_path / "o"
    rc = run_odometry.main(["--mode", "scan_to_map", "--synthetic", "6",
                            "--max-points", "256", "--cv-rot", "--device", "cpu",
                            "--set", "gicp.use_vgicp=false",
                            "--set", "voxel_map.submap_max_points=2048",
                            "--out", str(out)])
    assert rc == 0
    odom = np.loadtxt(out / "radar_odometry.txt")
    assert odom.shape[0] == 6 and np.isfinite(odom).all()
    assert '"mode": "scan_to_map"' in capsys.readouterr().out.strip().splitlines()[-1]


def test_entry_points_default_to_the_card():
    """State and interop land on the card unless the caller names the CPU."""
    import inspect

    from icp4dradar_tpu_torch import interop
    from icp4dradar_tpu_torch.mapping import voxel_map_create
    from icp4dradar_tpu_torch.models import scan_to_scan_init

    for fn in (pm.scan_to_map_init, voxel_map_create, scan_to_scan_init,
               interop.scan_from_numpy, interop.scans_from_numpy,
               interop.voxel_map_from_numpy):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn


def test_cli_scan_to_map_writes_outputs(tmp_path, capsys):
    out = tmp_path / "o"
    rc = run_odometry.main(["--mode", "scan_to_map", "--synthetic", "16",
                            "--max-points", "256", "--map-interval", "8", "--cv-rot",
                            "--device", "cpu", "--out", str(out)])
    assert rc == 0
    odom = np.loadtxt(out / "radar_odometry.txt")
    vel = np.loadtxt(out / "velocity.txt")
    assert odom.shape[0] == 16 and vel.shape[0] == 16
    assert np.isfinite(odom).all()
    assert '"mode": "scan_to_map"' in capsys.readouterr().out.strip().splitlines()[-1]
