"""The port's `run_pose_graph_odometry` on the CPU against the JAX
package's, on tests/test_pose_graph_odometry.py's circle (48 frames, one
full turn, keyframes every 4, loop radius 8 m, gap 24) cut to 256 points a
scan and 15 ICP iterations. At 256 points the JAX fixture's 3000 landmarks
leave consecutive scans too few common points (both packages' odometry
ends 8.9 m off and no closure verifies), so the landmarks are cut to 600:
the scans keep about the 1024-point fixture's density.

The port runs on the JAX package's RANSAC draws (`utils.threefry`), so the
two front ends differ only where JAX's CPU ICP searches with expanded
distances. Bands: odometry ATE (align=False) within 5e-3 m of JAX's (the
s2s parity band, test_torch_scan_to_scan.py's 1e-3 m per transform over
the track), accepted closures within 1, refined ATE within 0.05 m of
JAX's. The back end alone, on the same keyframe odometry and factors in
both packages: refined keyframes within 1e-4 m.

Port only, as the JAX tests: the no-loop identity, the wrong-closure
containment, the span-scaled gate, the blocked front end's fallback
warning, structure factors on the scan-to-map front end; a `mesh=` that is not
a DeviceMesh raises.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icp4dradar_tpu import graph as jg
from icp4dradar_tpu.config import PipelineConfig as JaxPipelineConfig
from icp4dradar_tpu.config import PoseGraphConfig as JaxPoseGraphConfig
from icp4dradar_tpu.io import SyntheticSequence as JaxSequence
from icp4dradar_tpu.io.scan import stack_scans as jax_stack
from icp4dradar_tpu.models import run_pose_graph_odometry as jax_run
from icp4dradar_tpu_torch.graph import optimize_pose_graph_block
from icp4dradar_tpu_torch.interop import (
    SCAN_FIELDS,
    POSE_GRAPH_FACTOR_FIELDS,
    config_from_dict,
    pose_graph_from_numpy,
    scans_from_numpy,
)
from icp4dradar_tpu_torch.models import PoseGraphOdometryResult, run_pose_graph_odometry
from icp4dradar_tpu_torch.models.pose_graph_odometry import _relative_between
from icp4dradar_tpu_torch.utils import ate_rmse, doppler_uniforms
from tests._torch_threads import one_torch_thread  # noqa: F401

F, N = 48, 256
KW = dict(keyframe_every=4, loop_radius=8.0, min_loop_gap=24)


@pytest.fixture(scope="module")
def circle():
    """The circle as JAX scans and the port's CPU scans, the config of
    both, the JAX package's draws for the port, and both packages' runs."""
    seq = JaxSequence(num_frames=F, max_points=N, num_landmarks=600, world_extent=40.0,
                      max_range=35.0, speed=1.0, turn_rate=2 * np.pi / F, pos_noise=0.02,
                      dynamic_fraction=0.05)
    js = jax_stack([seq.scan(k) for k in range(F)])
    ps = scans_from_numpy({k: np.asarray(getattr(js, k)) for k in SCAN_FIELDS}, device="cpu")
    jcfg = JaxPipelineConfig().override(**{"icp.max_iterations": 15,
                                            "pose_graph.max_iterations": 10})
    cfg = config_from_dict(jcfg.to_dict())
    U = torch.from_numpy(doppler_uniforms(cfg.seed, F, cfg.doppler.num_hypotheses))
    jres = jax_run(js, jcfg, **KW)
    res = run_pose_graph_odometry(ps, cfg, uniforms=U, **KW)
    return dict(seq=seq, ps=ps, cfg=cfg, U=U, jres=jres, res=res)


def _ate(poses, seq):
    return ate_rmse(poses[:, :3, 3], seq.poses[: len(poses), :3, 3], align=False)


def test_pipeline_matches_jax(circle):
    seq, res, jres = circle["seq"], circle["res"], circle["jres"]
    assert isinstance(res, PoseGraphOdometryResult)
    assert res.poses.shape == res.odom_poses.shape == (F, 4, 4)
    assert np.isfinite(res.poses).all()
    np.testing.assert_array_equal(res.keyframe_indices, jres.keyframe_indices)
    assert res.num_loop_closures >= 1
    assert abs(res.num_loop_closures - jres.num_loop_closures) <= 1
    ate_odom, ate_ref = _ate(res.odom_poses, seq), _ate(res.poses, seq)
    assert abs(ate_odom - _ate(jres.odom_poses, seq)) <= 5e-3
    assert abs(ate_ref - _ate(jres.poses, seq)) <= 0.05
    # the JAX test's acceptance: refinement at least as good as the
    # odometry, and the end of the loop closer to the truth
    assert ate_ref <= ate_odom * 1.05, (ate_ref, ate_odom)
    gt = seq.poses[:, :3, 3]
    assert (np.linalg.norm(res.poses[-1, :3, 3] - gt[-1])
            <= np.linalg.norm(res.odom_poses[-1, :3, 3] - gt[-1]) + 1e-6)


def test_back_end_matches_jax_on_the_same_factors(circle):
    """The same keyframe odometry (JAX's) and the same factors — the
    odometry chain and closures measured from the ground truth between
    keyframes near in space and far in time — into both packages'
    `optimize_pose_graph_block`."""
    seq, jres, cfg = circle["seq"], circle["jres"], circle["cfg"]
    odom = np.asarray(jres.odom_poses, np.float32)
    kf = np.arange(0, F, 4)
    K = len(kf)
    gt = seq.poses.astype(np.float32)
    d = np.linalg.norm(gt[kf][:, None, :3, 3] - gt[kf][None, :, :3, 3], axis=-1)
    li, lj = np.nonzero(np.triu((d < 8.0) & (np.abs(kf[:, None] - kf[None, :]) >= 24), 1))
    assert len(li) >= 2
    i = np.concatenate([np.arange(K - 1), li]).astype(np.int32)
    j = np.concatenate([np.arange(1, K), lj]).astype(np.int32)
    T = np.concatenate([_relative_between(odom, kf[:-1], kf[1:]),
                        _relative_between(gt, kf[li], kf[lj])]).astype(np.float32)
    w = np.concatenate([np.full(K - 1, 100.0), np.full(len(li), 10.0)]).astype(np.float32)
    rel = jg.RelPoseFactors.build(i, j, T, w)
    jout, jcost = jg.optimize_pose_graph_block(jg.PoseGraph(poses=jnp.asarray(odom[kf]), rel=rel),
                                               JaxPoseGraphConfig(**vars(cfg.pose_graph)))
    graph = pose_graph_from_numpy({"poses": odom[kf], "rel": {
        f: np.asarray(getattr(rel, f)) for f in POSE_GRAPH_FACTOR_FIELDS["rel"]}}, device="cpu")
    out, cost = optimize_pose_graph_block(graph, cfg.pose_graph)
    np.testing.assert_allclose(out.poses.numpy(), np.asarray(jout.poses), atol=1e-4)
    np.testing.assert_allclose(float(cost), float(jcost), rtol=1e-4, atol=1e-6)


def test_no_loops_identity_refinement(circle):
    ps, cfg = circle["ps"], circle["cfg"]
    res = run_pose_graph_odometry(ps[:16], cfg, uniforms=circle["U"][:16], keyframe_every=4,
                                  loop_radius=0.01, min_loop_gap=100)
    assert res.num_loop_closures == 0
    np.testing.assert_allclose(res.poses, res.odom_poses, atol=5e-2)


def _inject(res, offset, weight, a=1, b=None):
    kf = res.keyframe_indices
    K = len(kf)
    b = K - 2 if b is None else b
    T = np.linalg.inv(res.odom_poses[kf[a]]) @ res.odom_poses[kf[b]]
    T[:3, 3] += np.asarray(offset)
    return (a, b, T, weight)


def test_wrong_closure_contained_by_residual_regate(circle):
    """An unverified closure 10 m off, at weight 100, is dropped by the
    gating pass; without the gates it drags the trajectory."""
    seq, ps, cfg, U, clean = (circle[k] for k in ("seq", "ps", "cfg", "U", "res"))
    bogus = [_inject(clean, [10.0, 0.0, 0.0], 100.0)]
    inj = run_pose_graph_odometry(ps, cfg, uniforms=U, inject_loop_factors=bogus, **KW)
    assert inj.num_loop_closures == clean.num_loop_closures
    assert _ate(inj.poses, seq) < _ate(clean.poses, seq) + 0.2
    blind = run_pose_graph_odometry(ps, cfg, uniforms=U, inject_loop_factors=bogus,
                                    loop_residual_gate_t=float("inf"),
                                    loop_residual_gate_r_deg=float("inf"), **KW)
    assert _ate(blind.poses, seq) > _ate(inj.poses, seq) + 0.5


def test_residual_gate_scales_with_loop_span(circle):
    """tests/test_pose_graph_odometry.py's span-scaled gate: a closure off
    by a drift plausible for its span (2 m + 5 mm a frame: the JAX test's
    1 cm a frame lies beyond this fixture's gating residual, in both
    packages) survives, a fabrication does not; with fixed gates both
    go."""
    ps, cfg, U, clean = (circle[k] for k in ("ps", "cfg", "U", "res"))
    kf = clean.keyframe_indices
    span = abs(int(kf[len(kf) - 2]) - int(kf[1]))
    factors = [_inject(clean, [2.0 + 0.005 * span, 0.0, 0.0], 1.0),
               _inject(clean, [0.0, 4.0 + 0.1 * span, 0.0], 1.0)]
    inj = run_pose_graph_odometry(ps, cfg, uniforms=U, inject_loop_factors=factors, **KW)
    assert inj.num_loop_closures == clean.num_loop_closures + 1
    fixed = run_pose_graph_odometry(ps, cfg, uniforms=U, inject_loop_factors=factors,
                                    loop_residual_gate_t_per_frame=0.0,
                                    loop_residual_gate_r_deg_per_frame=0.0, **KW)
    assert fixed.num_loop_closures == clean.num_loop_closures


def test_mesh_raises(circle):
    """A `mesh` that is not a DeviceMesh is refused before any work; the
    multi-device back end itself runs in tests/test_torch_parallel.py."""
    with pytest.raises(TypeError, match="DeviceMesh"):
        run_pose_graph_odometry(circle["ps"], circle["cfg"], mesh=object(), **KW)


def test_unknown_front_end_raises(circle):
    with pytest.raises(ValueError, match="front_end"):
        run_pose_graph_odometry(circle["ps"][:4], circle["cfg"], front_end="bogus")


def test_scan_to_map_front_end_fallback_warns(circle):
    """10 frames do not fit pose_graph.front_end_block = 8: the front end
    falls back to the per-frame tracker, with a warning."""
    with pytest.warns(RuntimeWarning, match="front_end_block"):
        res = run_pose_graph_odometry(circle["ps"][:10], circle["cfg"], keyframe_every=4,
                                      loop_radius=0.01, min_loop_gap=100,
                                      front_end="scan_to_map")
    assert np.isfinite(res.poses).all()


def test_scan_to_map_front_end_with_structure_factors():
    """tests/test_structure_factors.py's pipeline case on the port: 24
    frames of 512 points through the blocked scan-to-map front end, two
    structure-mining rounds on a 2^14 map; the refinement must not degrade
    the odometry it consumes."""
    seq = JaxSequence(num_frames=24, max_points=512, num_landmarks=2000, world_extent=30.0,
                      max_range=25.0, speed=1.0, turn_rate=0.05, pos_noise=0.02)
    js = jax_stack([seq.scan(k) for k in range(24)])
    ps = scans_from_numpy({k: np.asarray(getattr(js, k)) for k in SCAN_FIELDS}, device="cpu")
    cfg = config_from_dict(JaxPipelineConfig().override(**{
        "icp.max_iterations": 15, "pose_graph.max_iterations": 10,
        "voxel_map.capacity": 1 << 14}).to_dict())
    times = {}
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)     # 24 frames fit block 8
        res = run_pose_graph_odometry(ps, cfg, keyframe_every=4, front_end="scan_to_map",
                                      structure_factors=True, phase_times=times)
    assert np.isfinite(res.poses).all()
    assert set(times) == {"front_end", "structure", "optimize"}
    ate_odom, ate_ref = _ate(res.odom_poses, seq), _ate(res.poses, seq)
    assert ate_ref <= ate_odom * 1.1 + 0.02, (ate_ref, ate_odom)


def test_jax_and_port_take_the_same_arguments():
    import inspect

    jax_params = list(inspect.signature(jax_run).parameters)
    port_params = list(inspect.signature(run_pose_graph_odometry).parameters)
    assert port_params[:len(jax_params)] == jax_params
    assert port_params[len(jax_params):] == ["uniforms", "phase_times"]
