"""Port VGICP parity on the CPU: the plain version of the CUDA sweep kernel
against the Pallas kernel run in interpret mode (as tests/test_ops.py runs
it) over several target tiles, a partial live count, a gate axis, exact
ties within and across tiles and an empty target; the batched form against
separate calls; the measurement-model covariances; `vgicp_align` and
`vgicp_align_block` against the JAX package.

Tolerances. Sweep sums: 1e-4 of the largest entry of each output, plus
1e-3 (the selections and per-point terms are the same; the sums run in
float64 here and in f32 there, where H's per-point terms of up to ~1e4
cancel to entries of ~1e3 and carry ~0.1 of f32 rounding; XLA also
contracts p = R s + t into FMAs, which moves d2 by ~4e-6 relative).
Matched payloads [mean3, cov6]: exact. Aligners: 1e-3 m and 1e-4 on
rotation entries; the JAX CPU path forms d2 as |p|^2 - 2 p.q + |q|^2, takes
the first argmin and inverts with jnp.linalg.inv, so it agrees only to
round-off."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icp4dradar_tpu.config import GicpConfig
from icp4dradar_tpu.geom import se3_exp as j_se3_exp
from icp4dradar_tpu.ops import vgicp_fused as jv
from icp4dradar_tpu.registration import vgicp as jreg
from icp4dradar_tpu_torch.ops import vgicp_fused as pv
from icp4dradar_tpu_torch.registration import vgicp as preg
from tests._torch_threads import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-4, 1e-3
NAMES = ("H", "g", "cost", "wsum", "d2sum")


def _pose(xi):
    return np.asarray(j_se3_exp(jnp.asarray(xi, dtype=jnp.float32)))


def _covs(rng, P):
    """(P, 6) packed covariances that are positive definite: diagonal
    0.01-0.1, small off-diagonal terms."""
    c = np.zeros((P, 6), np.float32)
    c[:, :3] = np.abs(rng.normal(0.05, 0.02, (P, 3))) + 0.01
    c[:, 3:] = rng.normal(0.0, 0.003, (P, 3))
    return c


def _case(seed, n, P, count=None, scale=20.0):
    rng = np.random.default_rng(seed)
    src = rng.uniform(-scale, scale, (n, 3)).astype(np.float32)
    sm = (rng.uniform(size=n) > 0.1).astype(np.float32)
    scov = np.asarray(jv.radar_point_covariances_packed(jnp.asarray(src)))
    tgt = rng.uniform(-scale, scale, (P, 3)).astype(np.float32)
    tcov = _covs(rng, P)
    count = P if count is None else count
    tmask = (np.arange(P) < count).astype(np.float32)
    T = _pose([0.1, -0.2, 0.05, 0.02, 0.0, 0.1])
    return T, src, sm, scov, tgt, tcov, tmask, count


def _both(T, src, sm, scov, tgt, tcov, tmask, count, ts=128, **kw):
    j_kw = dict(kw)
    if "gate_axis" in kw:
        j_kw["gate_axis"] = jnp.asarray(kw["gate_axis"])
        kw["gate_axis"] = torch.tensor(kw["gate_axis"])
    jo = jv.vgicp_iteration(*map(jnp.asarray, (T, src, sm, scov, tgt, tcov, tmask)),
                            tgt_count=jnp.int32(count), ts=ts, interpret=True,
                            return_best=True, **j_kw)
    po = pv.vgicp_iteration(*(torch.tensor(x) for x in (T, src, sm, scov, tgt, tcov, tmask)),
                            tgt_count=torch.tensor(count, dtype=torch.int32), ts=ts,
                            return_best=True, **kw)
    return jo, po


def _assert_sums(jo, po):
    for name, j, p in zip(NAMES, jo[:5], po[:5]):
        j = np.asarray(j)
        np.testing.assert_allclose(p.numpy(), j, rtol=0,
                                   atol=ATOL + RTOL * np.abs(j).max(), err_msg=name)


def _assert_sweep(jo, po):
    _assert_sums(jo, po)
    jb, pb = np.asarray(jo[5]), po[5].numpy()
    assert pb.shape == jb.shape
    np.testing.assert_array_equal(pb[:, 1:], jb[:, 1:])       # matched payloads
    np.testing.assert_allclose(pb[:, 0], jb[:, 0], rtol=1e-5, atol=1e-5)


def test_radar_covariances_match_jax():
    xyz = np.random.default_rng(3).uniform(-60, 60, (500, 3)).astype(np.float32)
    want = np.asarray(jv.radar_point_covariances_packed(jnp.asarray(xyz), 0.2, 0.02, 0.03))
    got = pv.radar_point_covariances_packed(torch.tensor(xyz), 0.2, 0.02, 0.03)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("n,P,count", [
    (300, 2100, 2100),    # three target tiles, all live
    (300, 2100, 1100),    # partial live count: tile 2 is skipped
    (257, 700, 650),      # one tile, padded sources (ts=128)
    (200, 500, 0),        # empty target: nothing matches
])
def test_plain_matches_pallas_interpret(n, P, count):
    jo, po = _both(*_case(n + P, n, P, count))
    _assert_sweep(jo, po)
    if count == 0:
        assert float(po[3]) == 0.0 and float(np.asarray(jo[3])) == 0.0


def test_gate_axis_changes_nothing():
    """The Pallas kernel skips (block, tile) pairs outside the band gate;
    the port sweeps every live tile. A skipped tile holds no voxel within
    the gate, so the sums agree with the gated Pallas sweep and with the
    port's own ungated call."""
    T, src, sm, scov, tgt, tcov, tmask, count = _case(5, 512, 3000, 2900, scale=40.0)
    # sorted along x, as the blocked tracker sorts scans and submaps
    o = np.argsort(src[:, 0])
    src, scov = src[o], scov[o]
    o = np.argsort(tgt[:, 0])
    tgt, tcov = tgt[o], tcov[o]
    T = np.eye(4, dtype=np.float32)
    jo, po = _both(T, src, sm, scov, tgt, tcov, tmask, count,
                   gate_axis=np.asarray([1.0, 0.0], np.float32))
    _assert_sums(jo, po)
    plain = pv.vgicp_iteration(*(torch.tensor(x) for x in (T, src, sm, scov, tgt, tcov, tmask)),
                               tgt_count=torch.tensor(count), ts=128)
    for p, q in zip(po[:5], plain):
        torch.testing.assert_close(p, q, rtol=0, atol=0)


def test_exact_ties_within_and_across_tiles():
    """Source 0 at the origin: rows 3 and 700 (tile 0) both lie at d2 = 5
    and average to (1, 0, 0); row 1500 (tile 1) at the same d2 = 5 is not
    strictly closer and does not replace them. Source 1 at (20, 0, 0):
    tile 0's best is d2 = 9; rows 1100 and 1800 of tile 1 lie at d2 = 2,
    replace it and average to (20, 0, 0)."""
    rng = np.random.default_rng(11)
    P = 2048
    far = rng.uniform(60, 100, (P, 3)) * rng.choice([-1.0, 1.0], (P, 3))
    tgt = far.astype(np.float32)
    tgt[3], tgt[700], tgt[1500] = (1, 2, 0), (1, -2, 0), (-1, 2, 0)
    tgt[5], tgt[1100], tgt[1800] = (20, 3, 0), (21, 0, 1), (19, 0, -1)
    tcov = _covs(rng, P)
    src = np.asarray([[0, 0, 0], [20, 0, 0], [0, 30, 0]], np.float32)
    sm = np.ones(3, np.float32)
    scov = np.asarray(jv.radar_point_covariances_packed(jnp.asarray(src)))
    T = np.eye(4, dtype=np.float32)
    jo, po = _both(T, src, sm, scov, tgt, tcov, np.ones(P, np.float32), P, ts=8,
                   max_correspondence_dist=3.0)
    _assert_sweep(jo, po)
    best = po[5].numpy()[0]                                    # (10, ts)
    np.testing.assert_array_equal(best[:4, 0], [5.0, 1.0, 0.0, 0.0])
    np.testing.assert_array_equal(best[4:, 0], (tcov[3] + tcov[700]) / 2)
    np.testing.assert_array_equal(best[:4, 1], [2.0, 20.0, 0.0, 0.0])
    np.testing.assert_array_equal(best[4:, 1], (tcov[1100] + tcov[1800]) / 2)


def test_three_way_ties_with_masked_rows():
    """Three rows of one tile at d2 = 5 from source 0, masked rows between
    them (the port packs each tile's live rows first), dyadic means and
    covariances: every summation order gives the same payload, so the
    Pallas kernel and the port agree exactly."""
    P = 1024
    tgt = np.full((P, 3), 90.0, np.float32)
    tgt[3], tgt[400], tgt[1000] = (2, 1, 0), (1, 2, 0), (-2, 1, 0)
    tcov = np.zeros((P, 6), np.float32)
    tcov[:, :3] = np.arange(P, dtype=np.float32)[:, None] / 64.0
    tmask = np.ones(P, np.float32)
    tmask[100:300] = 0.0
    src = np.asarray([[0, 0, 0], [20, 0, 0]], np.float32)
    scov = np.asarray(jv.radar_point_covariances_packed(jnp.asarray(src)))
    jo, po = _both(np.eye(4, dtype=np.float32), src, np.ones(2, np.float32), scov, tgt, tcov,
                   tmask, P, ts=8, max_correspondence_dist=3.0)
    _assert_sweep(jo, po)
    best = po[5].numpy()[0]
    three = np.float32(3.0)
    np.testing.assert_array_equal(best[:4, 0], [5.0, np.float32(1.0) / three,
                                                np.float32(4.0) / three, 0.0])
    np.testing.assert_array_equal(best[4:7, 0], np.float32(1403 / 64.0) / three)


def test_prepared_targets_pack_each_tile_live_first():
    rng = np.random.default_rng(8)
    P = 2100                                            # tiles of 1024, 1024, 52
    mean = torch.tensor(rng.uniform(-9, 9, (P, 3)).astype(np.float32))
    cov = torch.tensor(_covs(rng, P))
    mask = torch.tensor((rng.uniform(size=P) > 0.3).astype(np.float32))
    mask[1024:2048] = 0.0                               # tile 1: nothing live
    src = torch.zeros((4, 3))
    ops = pv.vgicp_prepare(src, torch.ones(4), torch.zeros((4, 6)), mean, cov, mask,
                           tgt_count=torch.tensor(1500))
    assert ops.tm == 1024 and ops.count.tolist() == [1500]
    assert ops.tile_live.tolist() == [int(mask[:1024].sum()), 0, int(mask[2048:].sum())]
    for j in range(3):
        rows = torch.arange(j * 1024, min(P, (j + 1) * 1024))
        on = mask[rows] > 0.5
        order = torch.cat([rows[on], rows[~on]])
        assert torch.equal(ops.tgt[rows, :3], mean[order])
        assert torch.equal(ops.tgt[rows, 3], torch.where(mask[order] > 0.5, 0.0, 1e30))
        assert torch.equal(ops.tgt_cov[rows, :6], cov[order])
    assert float(ops.tgt_cov[:, 6:].abs().max()) == 0.0


def test_unpack_accumulators_is_symmetric_upper_packing():
    acc = torch.arange(2 * 30, dtype=torch.float64).reshape(2, 30)
    H, g, cost, wsum, d2sum = pv._unpack_accumulators(acc)
    iu = torch.triu_indices(6, 6)
    want = torch.zeros((2, 6, 6))
    want[:, iu[0], iu[1]] = acc[:, :21].float()
    want[:, iu[1], iu[0]] = acc[:, :21].float()
    assert torch.equal(H, want) and torch.equal(g, acc[:, 21:27].float())
    assert torch.equal(cost, acc[:, 27]) and torch.equal(d2sum, acc[:, 29])


@pytest.mark.parametrize("path", ["single", "batch", "frozen"])
def test_prepared_operands_match_per_call(path):
    """Operands packed once and swept at several transforms give what the
    per-call functions give (they prepare for one call and sweep)."""
    rng = np.random.default_rng(31)
    B, N, P = 3, 256, 1500
    src = torch.tensor(rng.uniform(-20, 20, (B, N, 3)).astype(np.float32))
    sm = torch.tensor((rng.uniform(size=(B, N)) > 0.2).astype(np.float32))
    scov = pv.radar_point_covariances_packed(src)
    tgt = torch.tensor(rng.uniform(-20, 20, (P, 3)).astype(np.float32))
    tcov = torch.tensor(_covs(rng, P))
    tmask = torch.tensor((rng.uniform(size=P) > 0.25).astype(np.float32))
    cnt = torch.tensor(1400, dtype=torch.int32)
    kw = dict(max_correspondence_dist=3.0)
    if path == "batch":
        ops = pv.vgicp_prepare(src, sm, scov, tgt, tcov, tmask, ts=128, tgt_count=cnt)
    else:
        ops = pv.vgicp_prepare(src[0], sm[0], scov[0], tgt, tcov, tmask, ts=128,
                               tgt_count=cnt)
    for step in (0.0, 0.03):
        T = torch.tensor(np.stack([_pose([0.1 * b + step, -0.2, 0.05, 0.02, step, 0.1 * b])
                                   for b in range(B)]))
        if path == "batch":
            got = pv.vgicp_sweep(T, ops, return_best=True, _acc_groups=B, **kw)
            want = pv.vgicp_iteration_batch(T, src, sm, scov, tgt, tcov, tmask, ts=128,
                                            tgt_count=cnt, return_best=True, **kw)
        else:
            got = pv.vgicp_sweep(T[0], ops, return_best=True, **kw)
            want = pv.vgicp_iteration(T[0], src[0], sm[0], scov[0], tgt, tcov, tmask,
                                      ts=128, tgt_count=cnt, return_best=True, **kw)
        if path == "frozen":
            T1 = T[0] @ torch.tensor(_pose([0.01, 0.0, 0.0, 0.0, 0.002, 0.0]))
            got = pv.vgicp_frozen(T1, ops, want[5], **kw)
            want = pv.vgicp_iteration_frozen(T1, src[0], sm[0], scov[0], want[5], **kw)
        for x, y in zip(got, want):
            assert torch.equal(x, y)
    with pytest.raises(ValueError):                     # operands of one frame
        pv.vgicp_sweep(T, ops if path != "batch" else pv.vgicp_prepare(src[0], sm[0],
                                                                       scov[0]), **kw)


def test_batch_matches_separate_calls():
    rng = np.random.default_rng(2)
    B, N, P = 3, 256, 1500
    src = rng.uniform(-20, 20, (B, N, 3)).astype(np.float32)
    sm = (rng.uniform(size=(B, N)) > 0.2).astype(np.float32)
    scov = pv.radar_point_covariances_packed(torch.tensor(src))
    tgt = torch.tensor(rng.uniform(-20, 20, (P, 3)).astype(np.float32))
    tcov = torch.tensor(_covs(rng, P))
    tmask = torch.ones(P)
    T = torch.tensor(np.stack([_pose([0.1 * b, -0.2, 0.05, 0.02, 0.0, 0.1 * b])
                               for b in range(B)]))
    src, sm = torch.tensor(src), torch.tensor(sm)
    batched = pv.vgicp_iteration_batch(T, src, sm, scov, tgt, tcov, tmask, ts=128)
    # the plain version one frame per chunk (the chunking the card takes
    # for large batches) gives the same sums
    chunked = pv.vgicp_iteration_plain(T, src.reshape(-1, 3), sm.reshape(-1),
                                       scov.reshape(-1, 6), tgt, tcov, tmask, ts=128,
                                       _acc_groups=B, max_tile_elems=N * 1024)
    for b in range(B):
        one = pv.vgicp_iteration(T[b], src[b], sm[b], scov[b], tgt, tcov, tmask, ts=128)
        for name, x, y, z in zip(NAMES, batched, one, chunked):
            torch.testing.assert_close(x[b], y, rtol=1e-6, atol=1e-6, msg=name)
            torch.testing.assert_close(z[b], x[b], rtol=0, atol=0, msg=name)
    with pytest.raises(ValueError):
        pv.vgicp_iteration_batch(T, src[:, :200], sm[:, :200], scov[:, :200],
                                 tgt, tcov, tmask, ts=128)


def _scene(seed, B=1, N=400, M=600):
    """Voxel-like means and covariances of a random scene, and B scans of
    it in the sensor frame with their true poses."""
    rng = np.random.default_rng(seed)
    world = rng.uniform(-25, 25, (M, 3)).astype(np.float32)
    world[:, 2] *= 0.1
    tcov = np.zeros((M, 6), np.float32)
    tcov[:, :3] = np.abs(rng.normal(0.02, 0.005, (M, 3)))
    poses = np.stack([_pose([0.5 * b + 0.2, 0.1, 0.0, 0.0, 0.0, 0.03 * b])
                      for b in range(B)])
    scans = []
    for b in range(B):
        pick = rng.choice(M, N, replace=False)
        pts = world[pick] + rng.normal(0, 0.02, (N, 3))
        R, t = poses[b, :3, :3], poses[b, :3, 3]
        scans.append(((pts - t) @ R).astype(np.float32))
    return world, tcov, np.stack(scans), poses


def _assert_pose(got, want):
    got, want = got.numpy(), np.asarray(want)
    np.testing.assert_allclose(got[..., :3, 3], want[..., :3, 3], atol=1e-3)
    np.testing.assert_allclose(got[..., :3, :3], want[..., :3, :3], atol=1e-4)


def test_vgicp_align_matches_jax():
    world, tcov, scans, poses = _scene(0)
    src = scans[0]
    sm = np.ones(src.shape[0], np.float32)
    tmask = np.ones(world.shape[0], np.float32)
    init = _pose([0.35, 0.2, 0.0, 0.0, 0.0, 0.01])          # off by ~0.2 m
    cfg = GicpConfig(max_iterations=15)
    jr = jreg.vgicp_align(jnp.asarray(src), jnp.asarray(world), jnp.asarray(tcov),
                          jnp.asarray(sm), jnp.asarray(tmask),
                          init_transform=jnp.asarray(init), cfg=cfg)
    pr = preg.vgicp_align(torch.tensor(src), torch.tensor(world), torch.tensor(tcov),
                          torch.tensor(sm), torch.tensor(tmask),
                          init_transform=torch.tensor(init), cfg=cfg)
    _assert_pose(pr.transform, jr.transform)
    np.testing.assert_allclose(pr.transform.numpy()[:3, 3], poses[0, :3, 3], atol=1e-2)
    assert int(pr.iterations) == int(jr.iterations)
    assert bool(pr.converged) == bool(jr.converged)
    np.testing.assert_allclose(float(pr.fitness), float(jr.fitness), rtol=1e-3, atol=1e-5)


def test_vgicp_align_block_matches_jax():
    B = 4
    world, tcov, scans, poses = _scene(1, B=B)
    N = scans.shape[1]
    rng = np.random.default_rng(4)
    sm = (rng.uniform(size=(B, N)) > 0.05).astype(np.float32)
    scov = np.asarray(jv.radar_point_covariances_packed(
        jnp.asarray(scans.reshape(-1, 3)))).reshape(B, N, 6)
    tmask = np.ones(world.shape[0], np.float32)
    init = poses.copy()
    init[:, :3, 3] += rng.normal(0, 0.1, (B, 3)).astype(np.float32)
    cfg = GicpConfig(max_iterations=15)
    jr, jw = jreg.vgicp_align_block(*map(jnp.asarray, (scans, world, tcov, sm, tmask,
                                                       scov, init)), cfg=cfg)
    pr, pw = preg.vgicp_align_block(*(torch.tensor(x) for x in (scans, world, tcov, sm,
                                                               tmask, scov, init)),
                                    cfg=cfg)
    _assert_pose(pr.transform, jr.transform)
    np.testing.assert_allclose(pr.transform.numpy()[:, :3, 3], poses[:, :3, 3], atol=1e-2)
    np.testing.assert_array_equal(pr.iterations.numpy(), np.asarray(jr.iterations))
    np.testing.assert_array_equal(pr.converged.numpy(), np.asarray(jr.converged))
    np.testing.assert_allclose(pw.numpy(), np.asarray(jw), rtol=1e-5)
    np.testing.assert_allclose(pr.fitness.numpy(), np.asarray(jr.fitness),
                               rtol=1e-3, atol=1e-5)


def test_cuda_tensors_never_take_the_plain_version(monkeypatch):
    """On the CPU the wrapper runs the plain version only because its
    tensors lie on the CPU; mixed devices raise."""
    T, src, sm, scov, tgt, tcov, tmask, count = _case(1, 64, 64)
    args = [torch.tensor(x) for x in (T, src, sm, scov, tgt, tcov, tmask)]
    calls = []
    monkeypatch.setattr(pv, "_vgicp_sweep_cuda", lambda *a, **k: calls.append(1))
    pv.vgicp_iteration(*args)
    assert calls == []
    with pytest.raises(ValueError):
        pv.vgicp_iteration(*args[:6], args[6].to("meta"))


# ---- the frozen-payload GN pass (inner GN steps, K5). Same budget as the
# sweep's sums: the per-point terms agree, the sums run in float64 here.

def _frozen_both(T1, src, sm, scov, best, groups=1, **kw):
    jo = jv.vgicp_iteration_frozen(*map(jnp.asarray, (T1, src, sm, scov, best)),
                                   interpret=True, _acc_groups=groups, **kw)
    po = pv.vgicp_iteration_frozen(*(torch.tensor(np.asarray(x))
                                     for x in (T1, src, sm, scov, best)),
                                   _acc_groups=groups, **kw)
    return jo, po


@pytest.mark.parametrize("n,P,count", [
    (300, 2100, 2100),    # every source matched
    (257, 700, 650),      # padded sources (ts=128)
    (200, 500, 0),        # empty target: no source ever matched, all sums 0
])
def test_frozen_plain_matches_pallas_interpret(n, P, count):
    T, src, sm, scov, tgt, tcov, tmask, count = _case(n + P + 1, n, P, count)
    jo, _ = _both(T, src, sm, scov, tgt, tcov, tmask, count,
                  max_correspondence_dist=4.0)
    best = np.asarray(jo[5])
    T1 = _pose([0.13, -0.17, 0.04, 0.015, 0.005, 0.09])      # a GN step later
    jf, pf = _frozen_both(T1, src, sm, scov, best, max_correspondence_dist=4.0)
    _assert_sums(jf, pf)
    if count == 0:
        assert float(pf[3]) == 0.0 and float(np.asarray(jf[3])) == 0.0
    else:
        assert float(pf[3]) > 0.5 * sm.sum()


@pytest.mark.parametrize("groups", [3, 1])
def test_frozen_batch_groups_and_never_matched_rows(groups):
    """B = 3 frames against one target, per-frame sums (`_acc_groups` = B)
    or one sum over all frames (1). Frame 1's payload rows are marked never
    matched (stale d2 1e30, as a sweep against an empty submap leaves
    them): they add nothing, although their fresh distances lie inside the
    gate. The results are views of one finished (groups, 45) row block, as
    the kernel writes it."""
    rng = np.random.default_rng(21)
    B, N, P = 3, 256, 1500
    src = rng.uniform(-20, 20, (B, N, 3)).astype(np.float32)
    sm = (rng.uniform(size=(B, N)) > 0.2).astype(np.float32)
    scov = np.asarray(jv.radar_point_covariances_packed(
        jnp.asarray(src.reshape(-1, 3)))).reshape(B, N, 6)
    tgt = rng.uniform(-20, 20, (P, 3)).astype(np.float32)
    tcov, tmask = _covs(rng, P), np.ones(P, np.float32)
    T = np.stack([_pose([0.1 * b, -0.2, 0.05, 0.02, 0.0, 0.1 * b]) for b in range(B)])
    jo = jv.vgicp_iteration_batch(*map(jnp.asarray, (T, src, sm, scov, tgt, tcov, tmask)),
                                  ts=128, interpret=True, return_best=True,
                                  max_correspondence_dist=3.0)
    best = np.asarray(jo[5]).copy()                     # (6, 10, 128): 2 blocks a frame
    rows = pv.best_payload_to_rows(torch.tensor(best), B * N)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(
        jv.best_payload_to_rows(jnp.asarray(best), B * N)))
    T1 = np.stack([_pose([0.1 * b + 0.03, -0.18, 0.05, 0.02, 0.004, 0.1 * b - 0.01])
                   for b in range(B)])
    flat = (src.reshape(-1, 3), sm.reshape(-1), scov.reshape(-1, 6))
    _, matched = _frozen_both(T1, *flat, best, groups=B, max_correspondence_dist=3.0)
    assert float(matched[3][1]) > 100.0
    best[2:4, 0, :] = 1e30
    jf, pf = _frozen_both(T1, *flat, best, groups=groups, max_correspondence_dist=3.0)
    _assert_sums(jf, pf)
    lead = (B,) if groups > 1 else ()
    assert pf[0].shape == lead + (6, 6) and pf[1].shape == lead + (6,)
    assert all(x.shape == lead for x in pf[2:])
    assert len({x.untyped_storage().data_ptr() for x in pf}) == 1
    torch.testing.assert_close(pf[0], pf[0].transpose(-1, -2), rtol=0, atol=0)
    if groups > 1:
        for x, y in zip(pf, matched):
            assert float(x[1].abs().sum()) == 0.0        # frame 1 never matched
            torch.testing.assert_close(x[[0, 2]], y[[0, 2]], rtol=0, atol=0)
    else:
        assert float(pf[3]) == float(matched[3][[0, 2]].sum())
    with pytest.raises(ValueError):                     # payload of other sources
        pv.vgicp_iteration_frozen(torch.tensor(T1[0]), torch.tensor(src[0, :100]),
                                  torch.tensor(sm[0, :100]), torch.tensor(scov[0, :100]),
                                  torch.tensor(best))


def _reference_inner_align(src, tgt, tcov, sm, tmask, scov, init, cfg):
    """The JAX package's TPU body of vgicp_align with inner GN steps
    (vgicp.py:74-124), run from its own functions with interpret=True (its
    CPU path forces inner = 0)."""
    from icp4dradar_tpu.geom.linalg import solve_spd6

    kw = dict(max_correspondence_dist=cfg.max_correspondence_dist, cov_eps=cfg.cov_epsilon)
    center = init[:3, 3].copy()
    T = jnp.asarray(init).at[:3, 3].set(0.0)
    tgt_c = jnp.asarray(tgt - center[None])
    src, sm, scov = map(jnp.asarray, (src, sm, scov))

    def update(T, H, g):
        xi = solve_spd6(H + cfg.lm_lambda * jnp.eye(6), -g)
        xi = jnp.where(jnp.isfinite(xi), xi, 0.0)
        return j_se3_exp(xi) @ T, float(jnp.sum(jnp.abs(xi)))

    it, delta = 0, np.inf
    while it < cfg.max_iterations and delta > cfg.vgicp_transformation_epsilon:
        H, g, _, wsum, d2sum, best = jv.vgicp_iteration(
            T, src, sm, scov, tgt_c, jnp.asarray(tcov), jnp.asarray(tmask),
            interpret=True, return_best=True, **kw)
        T, delta = update(T, H, g)
        it += 1
        for _ in range(cfg.inner_gn_steps):
            H, g, _, wsum, d2sum = jv.vgicp_iteration_frozen(T, src, sm, scov, best,
                                                             interpret=True, **kw)
            T, dlt = update(T, H, g)
            delta += dlt
            it += 1
    T = np.asarray(T).copy()
    T[:3, 3] += center
    return T, it, float(d2sum) / max(float(wsum), 1.0)


@pytest.mark.parametrize("max_iterations", [15, 3])
def test_vgicp_align_inner_steps_match_reference(max_iterations):
    """One sweep then one frozen step per GN body; every step counts, and
    the cap is checked only at the top (3 -> 4 iterations)."""
    world, tcov, scans, poses = _scene(0)
    src = scans[0]
    sm = np.ones(src.shape[0], np.float32)
    tmask = np.ones(world.shape[0], np.float32)
    scov = np.asarray(jv.radar_point_covariances_packed(jnp.asarray(src)))
    init = _pose([0.35, 0.2, 0.0, 0.0, 0.0, 0.01])
    cfg = GicpConfig(max_iterations=max_iterations, inner_gn_steps=1)
    T, it, fit = _reference_inner_align(src, world, tcov, sm, tmask, scov, init, cfg)
    pr = preg.vgicp_align(torch.tensor(src), torch.tensor(world), torch.tensor(tcov),
                          torch.tensor(sm), torch.tensor(tmask), torch.tensor(scov),
                          init_transform=torch.tensor(init), cfg=cfg)
    _assert_pose(pr.transform, T)
    assert int(pr.iterations) == it and it % 2 == 0
    np.testing.assert_allclose(float(pr.fitness), fit, rtol=1e-3, atol=1e-5)
    if max_iterations == 3:
        assert it == 4
    else:
        np.testing.assert_allclose(pr.transform.numpy()[:3, 3], poses[0, :3, 3], atol=1e-2)


def test_vgicp_align_block_ignores_inner_steps():
    """Blocks run no inner steps, as in the JAX package: the knob changes
    nothing there (it used to raise)."""
    B = 2
    world, tcov, scans, poses = _scene(1, B=B)
    N = scans.shape[1]
    sm = np.ones((B, N), np.float32)
    scov = pv.radar_point_covariances_packed(torch.tensor(scans))
    args = [torch.tensor(x) for x in (scans, world, tcov, sm, np.ones(len(world), np.float32))]
    init = torch.tensor(poses)
    r0, w0 = preg.vgicp_align_block(*args, scov, init, cfg=GicpConfig(max_iterations=15))
    r1, w1 = preg.vgicp_align_block(*args, scov, init,
                                    cfg=GicpConfig(max_iterations=15, inner_gn_steps=1))
    torch.testing.assert_close(r1.transform, r0.transform, rtol=0, atol=0)
    assert torch.equal(r1.iterations, r0.iterations) and torch.equal(w1, w0)


def _streams(seed, S, F, N, P, counts):
    """S streams of F frames against S submaps of P rows, counts[s] live."""
    rng = np.random.default_rng(seed)
    src = rng.uniform(-20, 20, (S * F, N, 3)).astype(np.float32)
    sm = (rng.uniform(size=(S * F, N)) > 0.1).astype(np.float32)
    scov = np.asarray(jv.radar_point_covariances_packed(
        jnp.asarray(src.reshape(-1, 3)))).reshape(S * F, N, 6)
    tgt = rng.uniform(-20, 20, (S, P, 3)).astype(np.float32)
    tcov = np.stack([_covs(rng, P) for _ in range(S)])
    tmask = (np.arange(P)[None] < np.asarray(counts)[:, None]).astype(np.float32)
    T = np.stack([_pose([0.1 * b, -0.2, 0.05, 0.02, 0.01 * b, 0.1]) for b in range(S * F)])
    return T, src, sm, scov, tgt, tcov, tmask, np.asarray(counts, np.int32)


def test_stream_axis_plain_matches_single_targets_and_pallas():
    """The sweep with a stream axis (frames b of stream b // F against
    submap b // F, one of them empty): equal to S single-target calls bit
    for bit, in one chunk of frames and in chunks that straddle streams;
    each stream within the sums' tolerance of the Pallas kernel run in
    interpret mode on that stream (`_assert_sums`: the JAX sums run in f32),
    payloads equal."""
    S, F, N, P, ts = 3, 2, 256, 1500, 128
    T, src, sm, scov, tgt, tcov, tmask, cnt = _streams(21, S, F, N, P, (1400, 0, 700))
    t = [torch.tensor(x) for x in (T, src, sm, scov, tgt, tcov, tmask, cnt)]
    ops = pv.vgicp_prepare(*t[1:7], ts=ts, tgt_count=t[7])
    assert ops.streams == S and ops.tile_live.shape == (S, 2) and ops.count.tolist() == [1400, 0, 700]
    got = pv.vgicp_sweep(t[0], ops, max_correspondence_dist=3.0, return_best=True,
                         _acc_groups=S * F)
    chunked = pv._sweep_plain(t[0].contiguous(), ops, pv.sweep_gate(3.0),
                              float(np.float32(1e-3)), True, S * F, max_tile_elems=N * 1024)
    nb = F * N // ts
    for s in range(S):
        fs = slice(s * F, (s + 1) * F)
        one = pv.vgicp_iteration_batch(t[0][fs], t[1][fs], t[2][fs], t[3][fs], t[4][s], t[5][s],
                                       t[6][s], ts=ts, tgt_count=t[7][s],
                                       max_correspondence_dist=3.0, return_best=True)
        jo = jv.vgicp_iteration_batch(*map(jnp.asarray, (T[fs], src[fs], sm[fs], scov[fs],
                                                         tgt[s], tcov[s], tmask[s])),
                                      tgt_count=jnp.int32(cnt[s]), ts=ts, interpret=True,
                                      max_correspondence_dist=3.0, return_best=True)
        for name, a, c, b in zip(NAMES, got, chunked, one):
            assert torch.equal(a[fs], b) and torch.equal(c[fs], b), name
        _assert_sums(jo, [x[fs] for x in got[:5]])
        assert torch.equal(got[5][s * nb:(s + 1) * nb], one[5])
        np.testing.assert_array_equal(got[5][s * nb:(s + 1) * nb].numpy()[:, 1:],
                                      np.asarray(jo[5])[:, 1:])
    assert float(got[3][F:2 * F].abs().sum()) == 0.0          # the empty stream
    with pytest.raises(ValueError):                            # 6 frames over 4 streams
        pv.vgicp_prepare(t[1], t[2], t[3], torch.cat([t[4], t[4][:1]]),
                         torch.cat([t[5], t[5][:1]]), torch.cat([t[6], t[6][:1]]))


def test_vgicp_align_streams_matches_single_calls_and_jax():
    """S one-frame streams, each against its own submap and centred on its
    own prediction, in one GN loop with per-stream active masks: each
    stream bit for bit `vgicp_align` on it alone (its one-stream case), the
    same with one inner step a sweep, and within the JAX aligner's
    tolerance of the JAX package's."""
    S = 3
    world, tcov, scans, poses = _scene(5, B=S)
    init = poses @ np.stack([_pose([0.3 * s - 0.3, 0.15, 0.0, 0.0, 0.0, 0.01 * s])
                             for s in range(S)])
    shift = np.asarray([[0.0, 0.0, 0.0], [30.0, -5.0, 0.0], [-12.0, 40.0, 0.0]], np.float32)
    tgt = np.stack([world + shift[s] for s in range(S)])
    init[:, :3, 3] += shift
    sm = np.ones(scans.shape[:2], np.float32)
    tmask = np.ones((S, world.shape[0]), np.float32)
    tmask[1, 300:] = 0.0
    cnt = torch.tensor([world.shape[0], 300, world.shape[0]], dtype=torch.int32)
    scov = pv.radar_point_covariances_packed(torch.tensor(scans))
    t = [torch.tensor(x) for x in (scans, tgt, np.stack([tcov] * S), sm, tmask)]
    for inner in (0, 1):
        cfg = GicpConfig(max_iterations=15, inner_gn_steps=inner)
        r = preg.vgicp_align_streams(*t, scov, torch.tensor(init), cfg, tgt_count=cnt)
        assert r.transform.shape == (S, 4, 4) and r.iterations.shape == (S,)
        for s in range(S):
            o = preg.vgicp_align(t[0][s], t[1][s], t[2][s], t[3][s], t[4][s], src_cov6=scov[s],
                                 init_transform=torch.tensor(init[s]), cfg=cfg,
                                 tgt_count=cnt[s])
            for a, c in ((r.transform[s], o.transform), (r.iterations[s], o.iterations),
                         (r.converged[s], o.converged), (r.fitness[s], o.fitness)):
                assert torch.equal(a, c)
            if inner == 0:
                jr = jreg.vgicp_align(*(jnp.asarray(x[s]) for x in (scans, tgt,
                                                                     np.stack([tcov] * S),
                                                                     sm, tmask)),
                                      init_transform=jnp.asarray(init[s]), cfg=cfg)
                _assert_pose(r.transform[s], jr.transform)
        assert (r.iterations % (1 + inner) == 0).all()


def test_vgicp_align_block_stream_axis_matches_per_stream_calls():
    """The block aligner with a stream axis (S x B frames, stream s centred
    at its first prediction, held once none of its frames is active) gives
    each stream what the block aligner gives it alone, bit for bit."""
    S, B = 2, 3
    world, tcov, scans, poses = _scene(6, B=S * B)
    N = scans.shape[1]
    rng = np.random.default_rng(9)
    shift = np.asarray([[0.0, 0.0, 0.0], [-20.0, 15.0, 0.5]], np.float32)
    tgt = np.stack([world + shift[s] for s in range(S)])
    init = poses.copy().reshape(S, B, 4, 4)
    init[:, :, :3, 3] += shift[:, None] + rng.normal(0, 0.1, (S, B, 3)).astype(np.float32)
    sm = (rng.uniform(size=(S, B, N)) > 0.05).astype(np.float32)
    src = scans.reshape(S, B, N, 3)
    scov = pv.radar_point_covariances_packed(torch.tensor(src))
    tmask = np.ones((S, world.shape[0]), np.float32)
    tmask[1, ::3] = 0.0
    cfg = GicpConfig(max_iterations=15)
    t = [torch.tensor(x) for x in (src, tgt, np.stack([tcov] * S), sm, tmask)]
    r, w = preg.vgicp_align_block(*t, scov, torch.tensor(init), cfg=cfg)
    assert r.transform.shape == (S, B, 4, 4) and w.shape == (S, B)
    for s in range(S):
        o, ow = preg.vgicp_align_block(t[0][s], t[1][s], t[2][s], t[3][s], t[4][s], scov[s],
                                       torch.tensor(init[s]), cfg=cfg)
        for a, b in zip((r.transform[s], r.iterations[s], r.fitness[s], r.converged[s], w[s]),
                        (o.transform, o.iterations, o.fitness, o.converged, ow)):
            assert torch.equal(a, b)
