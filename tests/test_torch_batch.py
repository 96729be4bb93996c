"""Port B-stream serving on the CPU: `run_scan_to_map_batch` (B = 2
streams, each with its own map) against the JAX package's, with the blocked
tracker (block 8, 24 frames of 512 points, constant-velocity rotation
prior) and the per-frame one (6 frames); each stream against the batch
that orders the streams otherwise and against the port's single-stream
runners; the per-stream sequential re-track of a stream whose block looks
lost (accumulation and the rigid union in a batch: tests/test_torch_accumulate.py).

Two scenes. "windows": the streams are windows of one sequence, frames
[24 b, 24 b + 24), as the bench's batch cell cuts its streams. "sequences":
stream b is a sequence of its own, made with seed b; stream 1's track is
hard (ATE ~0.34 m over 24 frames) and chaotic: there JAX's own batch and
its single-stream runner on the same stream and key part by ~1.3e-2 m.
Each stream's ground truth is re-anchored at its first frame. JAX's own
REVE draws are injected per stream (`utils.reve_batch_uniforms`: stream b's
key is split(key(seed), B)[b], split further as JAX's runners split
theirs).

Tolerances. Against JAX, each stream as tests/test_torch_scan_to_map.py
holds a single stream (`_assert_tracks`: positions 1e-2 m, rotation entries
1e-3, ATE 1e-3 m, equal inlier counts, submap sizes within 1% plus two
voxels, sweeps within two): against JAX's batch or JAX's batch on the scans
moved by one ulp (a frame's sweeps differ by up to 2 between those two), and
on the "sequences" scene also against JAX's single-stream runner of the same
stream, runs of the same semantics that lie farther apart there than the
tolerance. A stream of the batch equals, bit for bit, the
same stream in a batch that orders the streams otherwise and the port's
single-stream runner on it (a single stream runs as a batch of one):
every output, the final pose and every table."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icp4dradar_tpu.config import PipelineConfig as JaxConfig
from icp4dradar_tpu.io import SyntheticSequence as JaxSequence
from icp4dradar_tpu.io.scan import stack_scans as jax_stack
from icp4dradar_tpu.models.scan_to_map import run_scan_to_map as j_run
from icp4dradar_tpu.models.scan_to_map import run_scan_to_map_batch as j_batch
from icp4dradar_tpu.models.scan_to_map import run_scan_to_map_blocked as j_blocked
from icp4dradar_tpu_torch.interop import (
    SCAN_FIELDS,
    VOXEL_MAP_FIELDS,
    config_from_dict,
    scans_from_numpy,
    voxel_map_from_numpy,
)
from icp4dradar_tpu_torch.models import scan_to_map as pm
from icp4dradar_tpu_torch.preprocess.reve import draw_reve_uniforms, reve_hypotheses
from icp4dradar_tpu_torch.utils import ate_rmse, reve_batch_uniforms
from tests._torch_threads import one_torch_thread  # noqa: F401

F, N, B = 24, 512, 2
T_ATOL, R_ATOL, ATE_ATOL = 1e-2, 1e-3, 1e-3


def _cfg():
    """The small config of tests/test_models.py."""
    return JaxConfig().override(**{
        "voxel_map.capacity": 1 << 14, "voxel_map.submap_max_points": 1 << 12,
        "icp.max_iterations": 15, "gicp.max_iterations": 15})


def _sequence(num_frames, n, seed):
    return JaxSequence(num_frames=num_frames, max_points=n, num_landmarks=4000,
                       world_extent=80.0, max_range=60.0, dynamic_fraction=0.05,
                       pos_noise=0.01, speed=1.0, turn_rate=0.03, seed=seed)


def _streams(n=N, junk=False, scene="windows"):
    """B streams of F frames: stream b the frames [F b, F b + F) of one
    sequence ("windows"), or the first F frames of the sequence of seed b
    ("sequences"). -> (JAX scans (B, F, ...), port scans, per-stream ground
    truth re-anchored at the stream's first frame). `junk`: frames 12-15
    of stream 1 are structureless (an interference burst)."""
    if scene == "windows":
        seq = _sequence(B * F, n, 0)
        parts = [(seq, b * F) for b in range(B)]
    else:
        parts = [(_sequence(F, n, b), 0) for b in range(B)]
    js = jax.tree.map(lambda *x: jnp.stack(x),
                      *[jax_stack([seq.scan(k) for k in range(k0, k0 + F)])
                        for seq, k0 in parts])
    if junk:
        xyz = np.asarray(js.xyz).copy()
        xyz[1, 12:16] = np.random.default_rng(7).uniform(-60, 60, xyz[1, 12:16].shape)
        js = js.replace(xyz=jnp.asarray(xyz.astype(np.float32)))
    gt = np.stack([np.linalg.inv(seq.poses[k0]) @ seq.poses[k0:k0 + F] for seq, k0 in parts])
    ps = scans_from_numpy({k: np.asarray(getattr(js, k)) for k in SCAN_FIELDS}, device="cpu")
    return js, ps, gt


def _stream(o, b):
    return pm._map_outputs(lambda xs: xs[0][b], o)


def _assert_tracks(po, jo, gt):
    pw, jw = po.world_T.numpy(), np.asarray(jo.world_T)
    assert np.isfinite(pw).all()
    np.testing.assert_allclose(pw[:, :3, 3], jw[:, :3, 3], atol=T_ATOL)
    np.testing.assert_allclose(pw[:, :3, :3], jw[:, :3, :3], atol=R_ATOL)
    n = pw.shape[0]
    ate_p = ate_rmse(pw[:, :3, 3], gt[:n, :3, 3], align=False)
    ate_j = ate_rmse(jw[:, :3, 3], gt[:n, :3, 3], align=False)
    assert abs(ate_p - ate_j) < ATE_ATOL, (ate_p, ate_j)
    np.testing.assert_array_equal(po.num_inliers.numpy(), np.asarray(jo.num_inliers))
    np.testing.assert_allclose(po.submap_points.numpy(), np.asarray(jo.submap_points),
                               rtol=0.01, atol=2)
    np.testing.assert_array_equal(po.velocity_valid.numpy(), np.asarray(jo.velocity_valid))
    np.testing.assert_allclose(po.velocity.numpy(), np.asarray(jo.velocity), rtol=1e-4,
                               atol=1e-5)
    assert np.abs(po.iterations.numpy() - np.asarray(jo.iterations)).max() <= 2
    return ate_p


def _assert_tracks_one_of(po, refs, gt):
    """`_assert_tracks` against the first of `refs` it holds for."""
    failures = []
    for ref in refs:
        try:
            return _assert_tracks(po, ref, gt)
        except AssertionError as e:
            failures.append(e)
    raise AssertionError(failures)


def _jax_single(js, cfg, b, frames, block):
    """JAX's single-stream runner on stream b with the key JAX's batch
    gives that stream."""
    key = jax.random.split(jax.random.key(cfg.seed), B)[b]
    one = jax.tree.map(lambda x: x[b, :frames], js)
    if block > 1:
        return j_blocked(one, cfg, key=key, block=block, use_const_velocity_rot=True,
                         sequential_fallback=False)[1]
    return j_run(one, cfg, key=key, use_const_velocity_rot=True)[1]


@pytest.mark.parametrize("block,frames,scene", [
    (8, F, "windows"), (0, 6, "windows"), (8, F, "sequences"), (0, 6, "sequences")])
def test_batch_matches_jax(block, frames, scene):
    """The blocked batch (JAX's vmap of run_scan_to_map_blocked, no
    sequential fallback) and the per-frame batch (its vmap of
    run_scan_to_map), stream by stream; on the "sequences" scene each
    stream against JAX's batch or JAX's single-stream runner (module
    docstring); the final maps cross interop as the vmapped map's
    (B, C, ...) leaves."""
    cfg = _cfg()
    js, ps, gt = _streams(scene=scene)
    jst, jo = j_batch(jax.tree.map(lambda x: x[:, :frames], js), cfg, block=block,
                      use_const_velocity_rot=True)
    U = reve_batch_uniforms(cfg.seed, B, frames, block, reve_hypotheses(cfg.reve))
    before = pm.SEQUENTIAL_FALLBACK_BLOCKS
    pst, po = pm.run_scan_to_map_batch(ps[:, :frames], config_from_dict(cfg.to_dict()),
                                       uniforms=torch.from_numpy(U), block=block,
                                       use_const_velocity_rot=True)
    assert pm.SEQUENTIAL_FALLBACK_BLOCKS == before
    assert po.world_T.shape == (B, frames, 4, 4) and po.insert_mask.shape == (B, frames, N)
    assert pst.world_T.shape == (B, 4, 4) and pst.vmap.streams == B
    # JAX's own spread: its batch again on the scans moved by one ulp
    nudged = js.replace(xyz=jnp.asarray(np.nextafter(np.asarray(js.xyz), np.float32(np.inf))))
    _, jn = j_batch(jax.tree.map(lambda x: x[:, :frames], nudged), cfg, block=block,
                    use_const_velocity_rot=True)
    for b in range(B):
        refs = [jax.tree.map(lambda x, b=b: x[b], jo), jax.tree.map(lambda x, b=b: x[b], jn)]
        if scene == "sequences":
            refs.append(_jax_single(js, cfg, b, frames, block))
        ate = _assert_tracks_one_of(_stream(po, b), refs, gt[b])
        assert ate < (0.3 if scene == "windows" else 0.4)     # stream 1 of "sequences": 0.34
    jmap = voxel_map_from_numpy({k: np.asarray(getattr(jst.vmap, k)) for k in VOXEL_MAP_FIELDS},
                                voxel_size=jst.vmap.voxel_size,
                                max_probes=jst.vmap.max_probes, device="cpu")
    assert jmap.streams == B and jmap.capacity == pst.vmap.capacity
    np.testing.assert_allclose(pst.vmap.num_voxels.numpy(), jmap.num_voxels.numpy(),
                               rtol=0.01, atol=2)


@pytest.mark.parametrize("block,frames", [(8, F), (0, 6)])
def test_batch_streams_match_single_stream_runs(block, frames):
    """Stream b of the batch, bit for bit: stream b of the batch that holds
    the streams in the reverse order (no stream reads another's data, and
    none depends on its place), and the port's single-stream runner on
    stream b with the same draws (a stream tracks alike alone and
    batched)."""
    cfg = config_from_dict(_cfg().to_dict())
    _, ps, _ = _streams()
    g = torch.Generator().manual_seed(5)
    U = torch.stack([draw_reve_uniforms((frames,), cfg.reve, g) for _ in range(B)])
    kw = dict(block=block, use_const_velocity_rot=True)
    bst, bo = pm.run_scan_to_map_batch(ps[:, :frames], cfg, uniforms=U, **kw)
    rev = list(range(B))[::-1]
    ost, oo = pm.run_scan_to_map_batch(ps[rev, :frames], cfg, uniforms=U[rev], **kw)
    for b in range(B):
        r = rev[b]
        for a, c in zip(_map_fields(bo, b), _map_fields(oo, r)):
            assert torch.equal(a, c)
        for a, c in zip(bst.vmap.stream(b).tables(), ost.vmap.stream(r).tables()):
            assert torch.equal(a, c)
        assert torch.equal(bst.world_T[b], ost.world_T[r])
        if block:
            sst, so = pm.run_scan_to_map_blocked(ps[b, :frames], cfg, uniforms=U[b],
                                                 sequential_fallback=False, **kw)
        else:
            sst, so = pm.run_scan_to_map(ps[b, :frames], cfg, uniforms=U[b],
                                         use_const_velocity_rot=True)
        for name, a, c in zip(_FIELDS, _map_fields(bo, b), _map_fields(so, slice(None))):
            assert torch.equal(a, c), name
        for a, c in zip(bst.vmap.stream(b).tables(), sst.vmap.tables()):
            assert torch.equal(a, c)
        assert torch.equal(bst.world_T[b], sst.world_T)


_FIELDS = ("world_T", "correction", "velocity", "velocity_sigma", "velocity_valid", "fitness",
           "num_inliers", "submap_points", "iterations", "insert_mask")


def _map_fields(o, b):
    return [getattr(o, f)[b] for f in _FIELDS]


def test_batch_sequential_fallback_retracks_only_the_lost_stream():
    """With `sequential_fallback=True` a stream whose block looks lost (four
    frames of junk in stream 1) re-tracks that block frame by frame, alone:
    stream 0's outputs and map equal those of the run without the fallback
    bit for bit, stream 1's block differs from that run and every pose
    stays finite and proper."""
    cfg = config_from_dict(_cfg().to_dict())
    _, ps, _ = _streams(n=1024, junk=True)
    g = torch.Generator().manual_seed(11)
    U = torch.stack([draw_reve_uniforms((F,), cfg.reve, g) for _ in range(B)])
    kw = dict(uniforms=U, block=8, use_const_velocity_rot=True)
    _, plain = pm.run_scan_to_map_batch(ps, cfg, **kw)
    before = pm.SEQUENTIAL_FALLBACK_BLOCKS
    st, fb = pm.run_scan_to_map_batch(ps, cfg, sequential_fallback=True, **kw)
    fallbacks = pm.SEQUENTIAL_FALLBACK_BLOCKS - before
    assert fallbacks >= 1
    lost = (plain.fitness >= cfg.tracking.max_fitness) | ~torch.isfinite(plain.fitness)
    assert not bool(lost[0].any()) and bool(lost[1, 8:16].any())
    for a, c in zip(_map_fields(fb, 0), _map_fields(plain, 0)):
        assert torch.equal(a, c)
    assert not torch.equal(fb.world_T[1, 8:16], plain.world_T[1, 8:16])
    P = fb.world_T.numpy()
    assert np.isfinite(P).all()
    np.testing.assert_allclose(np.linalg.det(P[..., :3, :3]), 1.0, atol=1e-2)


def test_knn_gicp_batch_matches_jax():
    """kNN GICP inside the per-frame batch (`gicp.use_vgicp=False`): each
    stream against JAX's vmapped `run_scan_to_map_batch` on JAX's draws,
    with the tolerances of the single-stream kNN parity test
    (tests/test_torch_scan_to_map.py:
    `_assert_tracks`, fitness within 2e-3 relative), and stream 0 against
    the port's single-stream runner on the same draws, bit for bit."""
    frames = 6
    jcfg = _cfg().override(**{"gicp.use_vgicp": False})
    cfg = config_from_dict(jcfg.to_dict())
    js, ps, gt = _streams()
    _, jo = j_batch(jax.tree.map(lambda x: x[:, :frames], js), jcfg, use_const_velocity_rot=True)
    U = torch.from_numpy(reve_batch_uniforms(cfg.seed, B, frames, 0, reve_hypotheses(cfg.reve)))
    pst, po = pm.run_scan_to_map_batch(ps[:, :frames], cfg, uniforms=U,
                                       use_const_velocity_rot=True)
    for b in range(B):
        jb = jax.tree.map(lambda x, b=b: x[b], jo)
        _assert_tracks(_stream(po, b), jb, gt[b])
        np.testing.assert_allclose(po.fitness[b].numpy(), np.asarray(jb.fitness), rtol=2e-3,
                                   atol=1e-5)
    sst, so = pm.run_scan_to_map(ps[0, :frames], cfg, uniforms=U[0],
                                 use_const_velocity_rot=True)
    for name, a, c in zip(_FIELDS, _map_fields(po, 0), _map_fields(so, slice(None))):
        assert torch.equal(a, c), name
    for a, c in zip(pst.vmap.stream(0).tables(), sst.vmap.tables()):
        assert torch.equal(a, c)
