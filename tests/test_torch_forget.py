"""Port scan-to-map tracking with a finite `voxel_map.forget_radius` on the
CPU: after each insert the voxels beyond the radius are tombstoned and,
once tombstones pass `rehash_tombstone_fraction` of the table, the table is
rebuilt (`voxel_map_forget_far`, `voxel_map_maybe_rehash`), in the
per-frame tracker (10 frames) and in the blocked one (24 frames, block 8,
constant-velocity rotation prior), against the JAX package's CPU run on the
same SyntheticSequence with JAX's own REVE draws (`utils.reve_uniforms`);
and in `run_scan_to_map_batch` (B = 2 streams, 12 frames per frame, 16
blocked: the warm-up and one block), stream by stream against the JAX
package's batch and, bit for bit, against the port's single-stream
runners. The radius (25 m, under
the scans' 60 m range) and the fraction (0.05 of 2^14 slots)
make each single-stream run rebuild its table at least once. In the batch
the radius is 40 m and the fraction 0.02, and stream 1's radar reaches
35 m, so none of its points lie beyond the radius and its table is never
rebuilt while stream 0's is: each rebuild takes one stream of the two, in
the per-frame steps and in the block step. (Past frame 16 this scene turns
chaotic: on the last of 24 frames the JAX package's batch sweeps 3 times,
its single-stream runner on the same stream and key 14.)

Tolerances: those of tests/test_torch_scan_to_map.py (positions 1e-2 m,
rotation entries 1e-3, ATE 1e-3 m, equal inlier counts, submap sizes within
1% plus two voxels, sweeps within two), and the live voxels of the final
maps within 1% plus five: a stored point a few mm elsewhere may fall on
the other side of the radius."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icp4dradar_tpu.config import PipelineConfig as JaxConfig
from icp4dradar_tpu.io import SyntheticSequence as JaxSequence
from icp4dradar_tpu.io.scan import stack_scans as jax_stack
from icp4dradar_tpu.models import run_scan_to_map as j_run
from icp4dradar_tpu.models import run_scan_to_map_blocked as j_run_blocked
from icp4dradar_tpu.models.scan_to_map import run_scan_to_map_batch as j_batch
from icp4dradar_tpu_torch.interop import SCAN_FIELDS, config_from_dict, scans_from_numpy
from icp4dradar_tpu_torch.mapping import voxel_hash as pvh
from icp4dradar_tpu_torch.models import scan_to_map as pm
from icp4dradar_tpu_torch.preprocess.reve import reve_hypotheses
from icp4dradar_tpu_torch.utils import ate_rmse, reve_batch_uniforms, reve_uniforms
from tests._torch_threads import one_torch_thread  # noqa: F401

F, N, B = 24, 512, 2


def _cfg():
    return JaxConfig().override(**{
        "voxel_map.capacity": 1 << 14, "voxel_map.submap_max_points": 1 << 12,
        "icp.max_iterations": 15, "gicp.max_iterations": 15,
        "voxel_map.forget_radius": 25.0, "voxel_map.rehash_tombstone_fraction": 0.05})


def _sequence(num_frames, max_range=60.0):
    return JaxSequence(num_frames=num_frames, max_points=N, num_landmarks=4000,
                       world_extent=80.0, max_range=max_range, dynamic_fraction=0.05,
                       pos_noise=0.01, speed=1.0, turn_rate=0.03, seed=0)


def _assert_tracks(po, jo, pst, jst, gt, radius=25.0, frac=0.05):
    """Tracks within the module docstring's tolerances, far voxels gone
    from the final map and few tombstones left in it."""
    pw, jw = po.world_T.numpy(), np.asarray(jo.world_T)
    assert np.isfinite(pw).all()
    np.testing.assert_allclose(pw[:, :3, 3], jw[:, :3, 3], atol=1e-2)
    np.testing.assert_allclose(pw[:, :3, :3], jw[:, :3, :3], atol=1e-3)
    ate_p, ate_j = (ate_rmse(w[:, :3, 3], gt, align=False) for w in (pw, jw))
    assert abs(ate_p - ate_j) < 1e-3, (ate_p, ate_j)
    np.testing.assert_array_equal(po.num_inliers.numpy(), np.asarray(jo.num_inliers))
    np.testing.assert_allclose(po.submap_points.numpy(), np.asarray(jo.submap_points),
                               rtol=0.01, atol=2)
    assert np.abs(po.iterations.numpy() - np.asarray(jo.iterations)).max() <= 2
    live = float(pst.vmap.num_voxels)
    assert abs(live - float(jst.vmap.num_voxels)) <= 0.01 * live + 5
    far = (torch.linalg.vector_norm(pst.vmap.points - pst.world_T[:3, 3], dim=-1) > radius)
    assert not bool((far & (pst.vmap.occupied > 0.5)).any())
    tombs = int(((pst.vmap.keys[:, 0] != pvh._EMPTY) & (pst.vmap.occupied <= 0.5)).sum())
    assert tombs <= frac * pst.vmap.capacity


@pytest.mark.parametrize("block", [0, 8])
def test_forgetting_tracker_matches_jax(block, monkeypatch):
    cfg = _cfg()
    seq = _sequence(F)
    n = F if block else 10
    js = jax_stack([seq.scan(k) for k in range(n)])
    ps = scans_from_numpy({k: np.asarray(getattr(js, k)) for k in SCAN_FIELDS}, device="cpu")
    H = reve_hypotheses(cfg.reve)
    rebuilds = []
    rehash = pvh.voxel_map_rehash
    monkeypatch.setattr(pvh, "voxel_map_rehash", lambda m: rebuilds.append(1) or rehash(m))
    pcfg = config_from_dict(cfg.to_dict())
    U = torch.from_numpy(reve_uniforms(cfg.seed, n, block, H))
    if block:
        jst, jo = j_run_blocked(js, cfg, block=block, use_const_velocity_rot=True)
        pst, po = pm.run_scan_to_map_blocked(ps, pcfg, uniforms=U, block=block,
                                             use_const_velocity_rot=True)
    else:
        jst, jo = j_run(js, cfg)
        pst, po = pm.run_scan_to_map(ps, pcfg, uniforms=U)
    assert rebuilds, "the run never rebuilt its table"
    _assert_tracks(po, jo, pst, jst, seq.poses[:n, :3, 3])


@pytest.mark.parametrize("block", [0, 8])
def test_forgetting_batch_matches_jax(block, monkeypatch):
    """`run_scan_to_map_batch` with a finite forget radius, stream by stream
    against the JAX package's batch: each stream forgets around its own
    pose, and `voxel_map_maybe_rehash` rebuilds only the streams over the
    tombstone fraction (here stream 0 alone); and each stream of the batch
    equals the port's single-stream runner on it, bit for bit."""
    cfg = _cfg().override(**{"voxel_map.forget_radius": 40.0,
                             "voxel_map.rehash_tombstone_fraction": 0.02})
    n = 16 if block else 12
    seqs = [_sequence(n), _sequence(n, max_range=35.0)]
    js = jax.tree.map(lambda *x: jnp.stack(x),
                      *[jax_stack([seq.scan(k) for k in range(n)]) for seq in seqs])
    ps = scans_from_numpy({k: np.asarray(getattr(js, k)) for k in SCAN_FIELDS}, device="cpu")
    rebuilt = []
    rehash = pvh.voxel_map_rehash
    monkeypatch.setattr(pvh, "voxel_map_rehash",
                        lambda m: rebuilt.append(m.streams) or rehash(m))
    U = reve_batch_uniforms(cfg.seed, B, n, block, reve_hypotheses(cfg.reve))
    jst, jo = j_batch(js, cfg, block=block, use_const_velocity_rot=True)
    pcfg = config_from_dict(cfg.to_dict())
    pst, po = pm.run_scan_to_map_batch(ps, pcfg, uniforms=torch.from_numpy(U), block=block,
                                       use_const_velocity_rot=True)
    # one stream at a time, in the warm-up and in the block step
    assert rebuilt == [1] * len(rebuilt) and len(rebuilt) >= (2 if block else 1), rebuilt
    for b in range(B):
        gt = seqs[b].poses[:n, :3, 3]
        one = jax.tree.map(lambda x, b=b: x[b], jst)
        _assert_tracks(pm._stream_outputs(po, b), jax.tree.map(lambda x, b=b: x[b], jo),
                       pm._stream_state(pst, b), one, gt, radius=40.0, frac=0.02)
        kw = dict(uniforms=torch.from_numpy(U[b]), use_const_velocity_rot=True)
        sst, so = (pm.run_scan_to_map_blocked(ps[b], pcfg, block=block,
                                              sequential_fallback=False, **kw)
                   if block else pm.run_scan_to_map(ps[b], pcfg, **kw))
        for f in dataclasses.fields(so):
            assert torch.equal(getattr(po, f.name)[b], getattr(so, f.name)), f.name
        for a, c in zip(pst.vmap.stream(b).tables(), sst.vmap.tables()):
            assert torch.equal(a, c)
