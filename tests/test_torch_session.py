"""Port streaming session (`OdometrySession`) and checkpoints on the CPU,
against the JAX package's session on the same 12 frames: 4 `process` calls,
then one `process_batch` of 8 frames with block 4.

- The two sessions hold the same Threefry key after every call, so they
  make the same REVE draws; their tracks agree within the scan-to-map
  parity tolerance of tests/test_torch_scan_to_map.py (positions 1e-2 m,
  rotation entries 1e-3; equal inlier counts and insert masks), which
  covers the JAX CPU path's expanded distances.
- A checkpoint written by the JAX session resumes in the port and
  continues like JAX's own resumed session (same tolerance); one written by
  the port loads in JAX with equal leaves and the same structure text.
- The port's run straight through equals its checkpoint -> resume run bit
  for bit: outputs, pose and every table.
- `guard_nonfinite`: an all-NaN scan is absorbed without a skip (as in
  JAX), a step whose pose goes non-finite is skipped and the state kept
  bit for bit.
- `save_checkpoint` / `load_checkpoint` on nested tuples, lists, dicts and
  None write JAX's leaf order and structure text.

Small scene: 256 points a scan in a 50 m world of 400 landmarks (dense
enough to track at this size), map capacity 2^12, submap 2^10."""

import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icp4dradar_tpu.config import PipelineConfig as JaxConfig
from icp4dradar_tpu.io import SyntheticSequence as JaxSequence
from icp4dradar_tpu.io.scan import stack_scans as jax_stack
from icp4dradar_tpu.mapping import voxel_hash as jvh
from icp4dradar_tpu.models.scan_to_map import ScanToMapState as JaxState
from icp4dradar_tpu.models.streaming import OdometrySession as JaxSession
from icp4dradar_tpu.utils import checkpoint as jck
from icp4dradar_tpu_torch.interop import (
    SCAN_FIELDS,
    VOXEL_MAP_FIELDS,
    config_from_dict,
    scans_from_numpy,
)
from icp4dradar_tpu_torch.mapping import voxel_map_create
from icp4dradar_tpu_torch.models import OdometrySession, streaming
from icp4dradar_tpu_torch.models.scan_to_map import ScanToMapState
from icp4dradar_tpu_torch.preprocess.reve import reve_hypotheses
from icp4dradar_tpu_torch.utils import load_checkpoint, save_checkpoint, threefry
from tests._torch_threads import one_torch_thread  # noqa: F401

F, N, WARM, BLOCK = 12, 256, 4, 4
T_ATOL, R_ATOL = 1e-2, 1e-3


def _cfg():
    return JaxConfig().override(**{"voxel_map.capacity": 1 << 12,
                                   "voxel_map.submap_max_points": 1 << 10})


def _frames(x, sl):
    return jax.tree.map(lambda a: a[sl], x)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The JAX session's run (checkpointed after the 4 `process` calls),
    JAX's own session resumed from that file, and the scans."""
    tmp = tmp_path_factory.mktemp("session")
    seq = JaxSequence(num_frames=F, max_points=N, num_landmarks=400, world_extent=50.0,
                      max_range=50.0, dynamic_fraction=0.05, speed=1.0, turn_rate=0.02,
                      seed=0)
    js = jax_stack([seq.scan(k) for k in range(F)])
    ps = scans_from_numpy({k: np.asarray(getattr(js, k)) for k in SCAN_FIELDS}, device="cpu")
    cfg = _cfg()
    a = JaxSession(cfg, checkpoint_dir=os.fspath(tmp / "jax"))
    outs, keys = [], []
    for k in range(WARM):
        outs.append(jax.tree.map(lambda x: x[None], a.process(_frames(js, k))))
        keys.append(np.asarray(jax.random.key_data(a._key)))
    a.checkpoint()
    outs.append(a.process_batch(_frames(js, slice(WARM, F)), block=BLOCK))
    keys.append(np.asarray(jax.random.key_data(a._key)))
    b = JaxSession(cfg, checkpoint_dir=os.fspath(tmp / "jax"))
    assert b.resume() == WARM
    resumed = b.process_batch(_frames(js, slice(WARM, F)), block=BLOCK)
    return dict(tmp=tmp, seq=seq, js=js, ps=ps, cfg=cfg, pcfg=config_from_dict(cfg.to_dict()),
                outs=jax.tree.map(lambda *x: jnp.concatenate(x), *outs), keys=keys,
                state=a.state, resumed=resumed, resumed_state=b.state)


def _port_run(r, ckpt_dir=None):
    """The port's session over the same schedule; checkpoints after the 4
    `process` calls into ckpt_dir. -> (session, stacked outputs, keys)."""
    s = OdometrySession(r["pcfg"], checkpoint_dir=ckpt_dir, device="cpu")
    outs, keys = [], []
    for k in range(WARM):
        o = s.process(r["ps"][k])
        outs.append({f: getattr(o, f)[None] for f in ("world_T", "correction", "num_inliers",
                                                      "insert_mask", "iterations")})
        keys.append(s._key.copy())
    if ckpt_dir:
        s.checkpoint()
    o = s.process_batch(r["ps"][WARM:F], block=BLOCK)
    outs.append({f: getattr(o, f) for f in outs[0]})
    keys.append(s._key.copy())
    return s, {f: torch.cat([x[f] for x in outs]) for f in outs[0]}, keys


def _assert_tracks(po, jo):
    pw, jw = po["world_T"].numpy(), np.asarray(jo.world_T)
    assert np.isfinite(pw).all()
    np.testing.assert_allclose(pw[:, :3, 3], jw[:, :3, 3], atol=T_ATOL)
    np.testing.assert_allclose(pw[:, :3, :3], jw[:, :3, :3], atol=R_ATOL)
    np.testing.assert_array_equal(po["num_inliers"].numpy(), np.asarray(jo.num_inliers))
    np.testing.assert_array_equal(po["insert_mask"].numpy(), np.asarray(jo.insert_mask))


def test_session_matches_jax(run):
    s, po, keys = _port_run(run)
    for got, want in zip(keys, run["keys"]):
        np.testing.assert_array_equal(got, want)          # the same draws
    _assert_tracks(po, run["outs"])
    err = np.linalg.norm(po["world_T"].numpy()[:, :3, 3] - run["seq"].poses[:F, :3, 3], axis=1)
    assert err.max() < 0.1, err
    np.testing.assert_allclose(s.pose, np.asarray(run["state"].world_T), atol=T_ATOL)
    assert abs(float(s.state.vmap.num_voxels) - float(run["state"].vmap.num_voxels)) <= 5
    assert s.frame == F and s.skipped_frames == 0


def test_continued_block_draws_are_the_jax_runner_draws():
    """A blocked run from an init_state draws every frame from its block key
    (no warm-up key), as JAX's run_scan_to_map_blocked does."""
    H = reve_hypotheses(config_from_dict(_cfg().to_dict()).reve)
    k = jax.random.key(5)
    _, kblocks = jax.random.split(k)
    want = np.stack([np.asarray(jax.random.uniform(kf, (3 * H,)))
                     for kf in jax.random.split(kblocks, 8)])
    got = threefry.reve_uniforms(0, 8, 4, H, k=np.asarray(jax.random.key_data(k)),
                                 continued=True)
    np.testing.assert_array_equal(got, want)


def test_port_resumes_a_jax_checkpoint(run, tmp_path):
    shutil.copytree(run["tmp"] / "jax", tmp_path / "ck")
    s = OdometrySession(run["pcfg"], checkpoint_dir=os.fspath(tmp_path / "ck"), device="cpu")
    assert OdometrySession.has_checkpoint(os.fspath(tmp_path / "ck"))
    assert s.resume() == WARM
    (jstate, _), _ = jck.load_checkpoint(
        os.fspath(tmp_path / "ck" / "session"),
        (run["state"], jax.random.key_data(jax.random.key(0))))
    np.testing.assert_array_equal(s.pose, np.asarray(jstate.world_T))
    for k in VOXEL_MAP_FIELDS:
        np.testing.assert_array_equal(getattr(s.state.vmap, k).numpy(),
                                      np.asarray(getattr(jstate.vmap, k)), err_msg=k)
    np.testing.assert_array_equal(s._key, run["keys"][WARM - 1])
    o = s.process_batch(run["ps"][WARM:F], block=BLOCK)
    _assert_tracks({f: getattr(o, f) for f in ("world_T", "num_inliers", "insert_mask")},
                   run["resumed"])
    np.testing.assert_array_equal(s._key, run["keys"][-1])


def test_port_checkpoint_loads_in_jax_and_resumes_bit_for_bit(run, tmp_path):
    ck = os.fspath(tmp_path / "port")
    s, po, _ = _port_run(run, ck)
    like = (run["state"], jax.random.key_data(jax.random.key(0)))
    # the file holds the state after the 4 `process` calls: load it in JAX
    r = OdometrySession(run["pcfg"], checkpoint_dir=ck, device="cpu")
    assert r.resume() == WARM
    (jstate, jkey), meta = jck.load_checkpoint(os.path.join(ck, "session"), like)
    assert meta == {"frame": WARM}
    np.testing.assert_array_equal(np.asarray(jkey), r._key)
    np.testing.assert_array_equal(np.asarray(jstate.world_T), r.pose)
    for k in VOXEL_MAP_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(jstate.vmap, k)),
                                      getattr(r.state.vmap, k).numpy(), err_msg=k)
    with np.load(os.path.join(ck, "session.npz")) as f, \
            np.load(os.fspath(run["tmp"] / "jax" / "session.npz")) as g:
        assert bytes(f["__treedef__"]) == bytes(g["__treedef__"])
        assert sorted(f.files) == sorted(g.files)
        for name in f.files:
            assert f[name].dtype == g[name].dtype and f[name].shape == g[name].shape, name
    # checkpoint -> resume -> continue equals the run straight through
    o = r.process_batch(run["ps"][WARM:F], block=BLOCK)
    for f in ("world_T", "correction", "iterations", "insert_mask"):
        assert torch.equal(getattr(o, f), po[f][WARM:]), f
    assert torch.equal(r.state.world_T, s.state.world_T)
    for a, b in zip(r.state.vmap.tables(), s.state.vmap.tables()):
        assert torch.equal(a, b)


def _snapshot(s):
    return [s.state.world_T.clone()] + [t.clone() for t in s.state.vmap.tables()]


def _assert_state(s, snap):
    for a, b in zip([s.state.world_T] + list(s.state.vmap.tables()), snap):
        assert torch.equal(a, b)


def test_guard_nonfinite(run, monkeypatch):
    """An all-NaN scan is absorbed, as in the JAX session: REVE's gates drop
    every point, so nothing registers or inserts and the state stays the
    same, bit for bit, without a skip. A step whose pose goes non-finite (a
    solver blow-up, injected here) is skipped: skipped_frames counts it (B
    for a batch) and the state is kept bit for bit; without the guard the
    session takes it."""
    s = OdometrySession(run["pcfg"], device="cpu")
    for k in range(3):
        s.process(run["ps"][k])
    snap = _snapshot(s)
    bad = run["ps"][3]
    nan = float("nan")
    bad = bad.replace(xyz=torch.full_like(bad.xyz, nan), doppler=torch.full_like(bad.doppler, nan),
                      intensity=torch.full_like(bad.intensity, nan))
    out = s.process(bad)
    assert s.skipped_frames == 0 and s.frame == 4 and float(out.num_inliers) == 0.0
    _assert_state(s, snap)

    def blown(fn):
        def run_(*args, **kw):
            state, out = fn(*args, **kw)
            return dataclasses.replace(state, world_T=state.world_T * nan), out
        return run_

    monkeypatch.setattr(streaming, "scan_to_map_step", blown(streaming.scan_to_map_step))
    monkeypatch.setattr(streaming, "run_scan_to_map_blocked",
                        blown(streaming.run_scan_to_map_blocked))
    s.process(run["ps"][4])
    assert s.skipped_frames == 1 and s.frame == 5
    _assert_state(s, snap)
    s.process_batch(run["ps"][4:8], block=BLOCK)
    assert s.skipped_frames == 5 and s.frame == 9
    _assert_state(s, snap)
    s.guard_nonfinite = False
    s.process(run["ps"][8])
    assert s.skipped_frames == 5 and not bool(torch.isfinite(s.state.world_T).any())


def test_checkpoint_layout_matches_jax(tmp_path):
    """Nested tuples, lists, dicts (keys out of order), None and a map:
    the port's file has JAX's leaves in JAX's order and its structure
    text, and each package loads the other's file."""
    rng = np.random.default_rng(0)
    arrs = [rng.normal(size=s).astype(np.float32) for s in ((3,), (2, 2), (1,))]
    jmap = jvh.voxel_map_create(capacity=16, voxel_size=0.25, max_probes=4)
    pmap = voxel_map_create(capacity=16, voxel_size=0.25, max_probes=4, device="cpu")
    pmap = pmap.replace(points=torch.from_numpy(rng.normal(size=(16, 3)).astype(np.float32)))
    jmap = jmap.replace(points=jnp.asarray(pmap.points.numpy()))
    pstate = ScanToMapState(world_T=torch.eye(4), vmap=pmap)

    def tree(m, st, conv):
        return {"z": (conv(arrs[0]), None, [conv(arrs[1])]), "a": st,
                "m": [m, (conv(arrs[2]),)]}

    jstate = JaxState(world_T=jnp.eye(4), vmap=jmap)
    port_tree = tree(pmap, pstate, torch.from_numpy)
    jax_tree = tree(jmap, jstate, jnp.asarray)
    save_checkpoint(os.fspath(tmp_path / "p"), port_tree, {"x": 1})
    jck.save_checkpoint(os.fspath(tmp_path / "j"), jax_tree, {"x": 1})
    with np.load(tmp_path / "p.npz") as f, np.load(tmp_path / "j.npz") as g:
        assert sorted(f.files) == sorted(g.files)
        for name in f.files:
            np.testing.assert_array_equal(f[name], g[name], err_msg=name)
    got, meta = load_checkpoint(os.fspath(tmp_path / "j"), port_tree)
    assert meta == {"x": 1}
    assert got["z"][1] is None and got["m"][0].voxel_size == 0.25
    assert got["m"][0].max_probes == 4
    np.testing.assert_array_equal(got["z"][2][0], arrs[1])
    np.testing.assert_array_equal(got["a"].vmap.points, pmap.points.numpy())
    back, _ = jck.load_checkpoint(os.fspath(tmp_path / "p"), jax_tree)
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(jax_tree)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
