"""Port sparse-vendor tracking on the CPU against the JAX package: scan
accumulation (`accumulate_scans` > 1, the step's `aux_world_xyz` /
`aux_mask` / `insert_override`) and the blocked runner's `rigid_union`.

- the step with aux points and an override insert, VGICP (K4 at N + A
  sources) and kNN GICP (K2 at N + A sources), on one map bit for bit JAX's;
- `run_scan_to_map` with `accumulate_scans` 2 and 3 (the ring of refined,
  not yet inserted scans), and with `insert_before_registration`, where the
  override is ignored, as in the JAX package;
- the per-frame batch with accumulation (each stream a ring of its own);
- the rigid union in `run_scan_to_map_blocked` and in the blocked batch
  (K4's stream axis over every stream's union in one launch);
- what reads `accumulate_scans` and what does not: the blocked runner's
  warm-up frames accumulate and its blocks do not, in both packages; the
  session's `process` and `process_batch(block=8)` run as with 1.

Tolerances are tests/test_torch_scan_to_map.py's (`_assert_tracks`:
positions 1e-2 m, rotation entries 1e-3, ATE 1e-3 m, equal inlier counts,
sweeps within two), each track against either of two JAX runs one ulp
apart (`_nudged`). A stream of a batch equals its single-stream run bit
for bit, as everywhere in the port."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icp4dradar_tpu import geom as jg
from icp4dradar_tpu.mapping import voxel_map_insert as j_insert
from icp4dradar_tpu.models.scan_to_map import run_scan_to_map_batch as j_batch
from icp4dradar_tpu.models.scan_to_map import scan_to_map_init as j_init
from icp4dradar_tpu.models.scan_to_map import scan_to_map_step as j_step
from icp4dradar_tpu.models.streaming import OdometrySession as JaxSession
from icp4dradar_tpu_torch.interop import (
    SCAN_FIELDS,
    VOXEL_MAP_FIELDS,
    config_from_dict,
    scans_from_numpy,
    voxel_map_from_numpy,
)
from icp4dradar_tpu_torch.models import OdometrySession
from icp4dradar_tpu_torch.models import scan_to_map as pm
from icp4dradar_tpu_torch.preprocess.reve import reve_hypotheses
from icp4dradar_tpu_torch.utils import reve_batch_uniforms
from tests._torch_threads import one_torch_thread  # noqa: F401
from tests.test_torch_scan_to_map import (
    F,
    N,
    _assert_tracks_one_of,
    _blocked_draws,
    _cfg,
    _draws,
    _nudged,
    _sequence,
    j_run,
    j_run_blocked,
)

_FIELDS = ("world_T", "correction", "velocity", "velocity_sigma", "velocity_valid", "fitness",
           "num_inliers", "submap_points", "iterations", "insert_mask")


def _per_frame_draws(cfg, n):
    return torch.tensor(_draws(jax.random.split(jax.random.key(cfg.seed), n),
                               reve_hypotheses(cfg.reve)))


def _assert_same_tables(pmap, jmap):
    for k in VOXEL_MAP_FIELDS:
        np.testing.assert_array_equal(getattr(pmap, k).numpy(), np.asarray(getattr(jmap, k)),
                                      err_msg=k)


@pytest.mark.parametrize("use_vgicp", [True, False])
def test_step_with_aux_points_and_override_matches_jax(use_vgicp):
    """One step on a map of frames 0-3 inserted at their ground-truth poses
    (the same tables in both packages): frame 6 registers with frames 4-5 at
    their poses as aux points (A = 2N; VGICP re-expresses them in the
    predicted sensor frame, kNN GICP keeps them in the world frame), and
    frame 4 is the override that enters the map. The pose agrees within the
    trackers' tolerance, the inliers, the insert mask and every table bit
    for bit (the override's points are given, the scan itself is not
    inserted); without the aux points the step registers elsewhere."""
    cfg = _cfg().override(**{"gicp.use_vgicp": use_vgicp})
    pcfg = config_from_dict(cfg.to_dict())
    seq, js, ps = _sequence()
    G = seq.poses.astype(np.float32)
    jst = j_init(cfg)
    for k in range(4):
        jst = jst.replace(vmap=j_insert(jst.vmap, jg.se3_apply(jnp.asarray(G[k]), js.xyz[k]),
                                        js.mask[k], js.intensity[k]))
    jst = jst.replace(world_T=jnp.asarray(G[5]))
    world = [np.asarray(jg.se3_apply(jnp.asarray(G[k]), js.xyz[k])) for k in (4, 5)]
    aux_w, aux_m = np.concatenate(world), np.concatenate([np.asarray(js.mask[k]) for k in (4, 5)])
    over = (world[0], np.asarray(js.mask[4]), np.asarray(js.intensity[4]))
    key = jax.random.key(11)
    jn, jo = j_step(jst, jax.tree.map(lambda x: x[6], js), key, cfg, use_doppler_prior=True,
                    aux_world_xyz=jnp.asarray(aux_w), aux_mask=jnp.asarray(aux_m),
                    insert_override=tuple(jnp.asarray(x) for x in over))
    pst = pm.ScanToMapState(
        world_T=torch.tensor(G[5]),
        vmap=voxel_map_from_numpy({k: np.asarray(getattr(jst.vmap, k)) for k in VOXEL_MAP_FIELDS},
                                  device="cpu"))
    u = torch.tensor(np.asarray(jax.random.uniform(key, (3 * reve_hypotheses(pcfg.reve),))))
    kw = dict(use_doppler_prior=True)
    pn, po = pm.scan_to_map_step(pst, ps[6], u, pcfg, aux_world_xyz=torch.tensor(aux_w),
                                 aux_mask=torch.tensor(aux_m),
                                 insert_override=tuple(torch.tensor(x) for x in over), **kw)
    pw, jw = po.world_T.numpy(), np.asarray(jo.world_T)
    np.testing.assert_allclose(pw[:3, 3], jw[:3, 3], atol=1e-2)
    np.testing.assert_allclose(pw[:3, :3], jw[:3, :3], atol=1e-3)
    if use_vgicp:
        assert abs(int(po.iterations) - int(jo.iterations)) <= 2
    else:
        # the JAX CPU 1-NN's expanded distances keep its GN sweeping after
        # the port's exact ones have converged (ROADMAP queue 3: 52.9
        # against 4.86 iterations a frame on the gicp-64 cell): 3 against 6
        assert int(po.iterations) <= int(jo.iterations)
    np.testing.assert_array_equal(po.insert_mask.numpy(), np.asarray(jo.insert_mask))
    assert int(po.num_inliers) == int(jo.num_inliers)
    _assert_same_tables(pn.vmap, jn.vmap)
    # the aux points took part, and the map holds the override, not the scan
    _, bare = pm.scan_to_map_step(pst, ps[6], u, pcfg, **kw)
    assert not torch.equal(bare.world_T, po.world_T)
    only = pm.voxel_map_insert(pst.vmap, *(torch.tensor(x) for x in over))
    for a, c in zip(pn.vmap.tables(), only.tables()):
        assert torch.equal(a, c)


@pytest.mark.parametrize("k", [2, 3])
def test_run_scan_to_map_accumulates_like_jax(k):
    """`run_scan_to_map` with `accumulate_scans` = k over 12 frames: the ring
    of k - 1 refined scans registers with each frame (VGICP at (1 + k - 1)
    N = kN sources) and enters the map k - 1 frames late; against JAX's run
    on its own draws, and JAX's map within a few voxels. The run differs
    from the one without accumulation."""
    cfg = _cfg().override(accumulate_scans=k)
    pcfg = config_from_dict(cfg.to_dict())
    seq, js, ps = _sequence()
    n = 12
    js, ps = jax.tree.map(lambda x: x[:n], js), ps[:n]
    jst, jo = j_run(js, cfg)
    _, jn = j_run(_nudged(js), cfg)
    U = _per_frame_draws(cfg, n)
    pst, po = pm.run_scan_to_map(ps, pcfg, uniforms=U)
    ate, _ = _assert_tracks_one_of(po, [jo, jn], seq)
    assert ate < 0.3
    assert abs(float(pst.vmap.num_voxels) - float(jst.vmap.num_voxels)) <= 5
    _, plain = pm.run_scan_to_map(ps, config_from_dict(_cfg().to_dict()), uniforms=U)
    assert not torch.equal(plain.iterations, po.iterations)


def test_override_ignored_under_insert_before_registration():
    """With `insert_before_registration` the window's points still register,
    but the override is ignored (JAX `scan_to_map.py:239`, ROADMAP queue 3,
    copied): every scan is inserted at its predicted pose before it
    registers. The port against JAX on ground-truth poses with
    `accumulate_scans=2`, and a step with an override equal, bit for bit,
    to the same step without it."""
    cfg = _cfg().override(accumulate_scans=2)
    pcfg = config_from_dict(cfg.to_dict())
    seq, js, ps = _sequence()
    n = 8
    js, ps = jax.tree.map(lambda x: x[:n], js), ps[:n]
    G = seq.poses[:n].astype(np.float32)
    jst, jo = j_run(js, cfg, gt_poses=jnp.asarray(G), insert_before_registration=True)
    U = _per_frame_draws(cfg, n)
    pst, po = pm.run_scan_to_map(ps, pcfg, uniforms=U, gt_poses=torch.tensor(G),
                                 insert_before_registration=True)
    np.testing.assert_allclose(po.world_T.numpy()[:, :3, 3], np.asarray(jo.world_T)[:, :3, 3],
                               atol=1e-2)
    np.testing.assert_array_equal(po.insert_mask.numpy(), np.asarray(jo.insert_mask))
    np.testing.assert_array_equal(pst.vmap.keys.numpy(), np.asarray(jst.vmap.keys))
    np.testing.assert_array_equal(pst.vmap.stat_n.numpy(), np.asarray(jst.vmap.stat_n))
    st0 = pm.scan_to_map_init(pcfg, device="cpu")
    st0, _ = pm.scan_to_map_step(st0, ps[0], U[0], pcfg)
    aux = pm.se3_apply(torch.tensor(G[1]), ps[1].xyz)
    kw = dict(gt_pose=torch.tensor(G[2]), insert_before_registration=True,
              aux_world_xyz=aux, aux_mask=ps[1].mask)
    a_st, a = pm.scan_to_map_step(st0, ps[2], U[2], pcfg,
                                  insert_override=(aux, ps[1].mask, ps[1].intensity), **kw)
    b_st, b = pm.scan_to_map_step(st0, ps[2], U[2], pcfg, **kw)
    for f in _FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    for x, y in zip(a_st.vmap.tables(), b_st.vmap.tables()):
        assert torch.equal(x, y)


def _batch_streams(n_frames):
    """B = 2 windows of n_frames frames of one sequence (JAX and port
    scans) and their ground truth re-anchored at each window's start."""
    from tests.test_torch_batch import _sequence as batch_sequence

    B = 2
    seq = batch_sequence(B * n_frames, N, 0)
    from icp4dradar_tpu.io.scan import stack_scans as jax_stack

    js = jax.tree.map(lambda *x: jnp.stack(x), *[
        jax_stack([seq.scan(k) for k in range(b * n_frames, (b + 1) * n_frames)])
        for b in range(B)])
    ps = scans_from_numpy({k: np.asarray(getattr(js, k)) for k in SCAN_FIELDS}, device="cpu")
    gt = np.stack([np.linalg.inv(seq.poses[b * n_frames]) @ seq.poses[
        b * n_frames:(b + 1) * n_frames] for b in range(B)])
    return js, ps, gt


def _stream(o, b):
    return pm._map_outputs(lambda xs: xs[0][b], o)


def test_batch_accumulates_like_jax():
    """The per-frame batch with `accumulate_scans=2` (each stream its own
    ring): each stream against JAX's vmapped batch (or the batch on scans one
    ulp apart), stream 0 equal to its single-stream run bit for bit; a
    batch needs a stream axis."""
    cfg = _cfg().override(accumulate_scans=2)
    pcfg = config_from_dict(cfg.to_dict())
    n = 6
    js, ps, gt = _batch_streams(n)
    _, jo = j_batch(js, cfg, use_const_velocity_rot=True)
    _, jn = j_batch(_nudged(js), cfg, use_const_velocity_rot=True)
    U = torch.from_numpy(reve_batch_uniforms(cfg.seed, 2, n, 0, reve_hypotheses(pcfg.reve)))
    pst, po = pm.run_scan_to_map_batch(ps, pcfg, uniforms=U, use_const_velocity_rot=True)
    for b in range(2):
        refs = [jax.tree.map(lambda x, b=b: x[b], r) for r in (jo, jn)]
        _assert_tracks_one_of(_stream(po, b), refs, SimpleNamespace(poses=gt[b]))
    sst, so = pm.run_scan_to_map(ps[0], pcfg, uniforms=U[0], use_const_velocity_rot=True)
    for f in _FIELDS:
        assert torch.equal(getattr(po, f)[0], getattr(so, f)), f
    for a, c in zip(pst.vmap.stream(0).tables(), sst.vmap.tables()):
        assert torch.equal(a, c)
    with pytest.raises(ValueError):
        pm.run_scan_to_map_batch(ps[0], pcfg)                 # no stream axis


def test_rigid_union_blocked_matches_jax():
    """`run_scan_to_map_blocked(block=8, use_const_velocity_rot=True,
    rigid_union=True)` over 24 frames: one registration a block of the
    8 x 512-point union (K4 at 4,096 sources), its correction applied to
    the block's eight predictions, its fitness and sweeps broadcast over
    them, no sequential re-track; against JAX's runner."""
    cfg = _cfg()
    pcfg = config_from_dict(cfg.to_dict())
    seq, js, ps = _sequence()
    kw = dict(block=8, use_const_velocity_rot=True, rigid_union=True)
    jst, jo = j_run_blocked(js, cfg, **kw)
    _, jn = j_run_blocked(_nudged(js), cfg, **kw)
    before = pm.SEQUENTIAL_FALLBACK_BLOCKS
    pst, po = pm.run_scan_to_map_blocked(ps, pcfg, uniforms=_blocked_draws(cfg, F, 8), **kw)
    assert pm.SEQUENTIAL_FALLBACK_BLOCKS == before
    ate, _ = _assert_tracks_one_of(po, [jo, jn], seq)
    assert ate < 0.5
    for x in (po.fitness, po.iterations):
        blocks = x[8:].reshape(-1, 8)
        assert torch.equal(blocks, blocks[:, :1].expand_as(blocks))
    assert abs(float(pst.vmap.num_voxels) - float(jst.vmap.num_voxels)) <= 10


def test_rigid_union_batch_matches_jax():
    """The blocked batch with `rigid_union=True` (B = 2 windows of 24
    frames): one K4 sweep an iteration over both streams' unions, each
    against its own submap; each stream against JAX's vmapped runner (or
    the runner on scans one ulp apart), stream 0 equal to its single-stream
    run bit for bit."""
    cfg = _cfg()
    pcfg = config_from_dict(cfg.to_dict())
    js, ps, gt = _batch_streams(F)
    kw = dict(block=8, use_const_velocity_rot=True, rigid_union=True)
    _, jo = j_batch(js, cfg, **kw)
    _, jn = j_batch(_nudged(js), cfg, **kw)
    U = torch.from_numpy(reve_batch_uniforms(cfg.seed, 2, F, 8, reve_hypotheses(pcfg.reve)))
    pst, po = pm.run_scan_to_map_batch(ps, pcfg, uniforms=U, **kw)
    for b in range(2):
        refs = [jax.tree.map(lambda x, b=b: x[b], r) for r in (jo, jn)]
        _assert_tracks_one_of(_stream(po, b), refs, SimpleNamespace(poses=gt[b]))
    sst, so = pm.run_scan_to_map_blocked(ps[0], pcfg, uniforms=U[0],
                                         sequential_fallback=False, **kw)
    for f in _FIELDS:
        assert torch.equal(getattr(po, f)[0], getattr(so, f)), f
    for a, c in zip(pst.vmap.stream(0).tables(), sst.vmap.tables()):
        assert torch.equal(a, c)


def test_what_reads_accumulate_scans():
    """Only the per-frame tracker reads `accumulate_scans`, in both
    packages. The blocked runner with 4 against JAX's with 4: its warm-up
    frames accumulate (they differ from the run with 1) and its blocks do
    not. The session's `process` (the step) and `process_batch(block=8)`
    (the blocked runner from a state: no warm-up) run with 4 exactly as
    with 1, in the port bit for bit and in JAX within the tolerance."""
    cfg = _cfg().override(accumulate_scans=4)
    pcfg = config_from_dict(cfg.to_dict())
    seq, js, ps = _sequence()
    kw = dict(block=8, use_const_velocity_rot=True)
    _, jo = j_run_blocked(js, cfg, **kw)
    _, jn = j_run_blocked(_nudged(js), cfg, **kw)
    U = _blocked_draws(cfg, F, 8)
    _, po = pm.run_scan_to_map_blocked(ps, pcfg, uniforms=U, **kw)
    _assert_tracks_one_of(po, [jo, jn], seq)
    _, p1 = pm.run_scan_to_map_blocked(ps, config_from_dict(_cfg().to_dict()), uniforms=U, **kw)
    assert not torch.equal(po.world_T[:8], p1.world_T[:8])

    def session(c):
        s = OdometrySession(c, device="cpu")
        outs = [s.process(ps[k]) for k in range(8)]
        out = s.process_batch(ps[8:], block=8)
        return torch.stack([o.world_T for o in outs]), out, s

    a, a_b, a_s = session(pcfg)
    b, b_b, b_s = session(config_from_dict(_cfg().to_dict()))
    assert torch.equal(a, b)
    for f in _FIELDS:
        assert torch.equal(getattr(a_b, f), getattr(b_b, f)), f
    for x, y in zip(a_s.state.vmap.tables(), b_s.state.vmap.tables()):
        assert torch.equal(x, y)
    jses = JaxSession(cfg)
    jw = [np.asarray(jses.process(jax.tree.map(lambda x, k=k: x[k], js)).world_T)
          for k in range(8)]
    np.testing.assert_allclose(a.numpy()[:, :3, 3], np.stack(jw)[:, :3, 3], atol=1e-2)
