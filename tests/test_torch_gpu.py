"""Card tests of the port's CUDA kernels (ICP moments, also beyond one
target tile, VGICP sweep with its stream axis and its frozen-payload step,
the 1-NN search on prepared targets and its coordinate form) against their
plain PyTorch versions, of the batched voxel map and the map API on the
card against the CPU, of a stream of the batched tracker against its
single-stream run on the card (VGICP and kNN GICP), of the 1-NN search
with a stream axis against its plain version and single-target calls, of
a session's checkpoint -> resume against its straight run, of the host
side's device steps (a bag's stacked scans, the replay) on the card
against the CPU, and of the multi-device layer under NCCL at world size 1.
Marked `gpu`: they skip where torch.cuda.is_available() is False. This
file imports neither jax nor the JAX package, so on a machine with a card
and no jax it runs without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from icp4dradar_tpu_torch.geom import se3_exp
from icp4dradar_tpu_torch.ops import icp_fused
from icp4dradar_tpu_torch.ops.icp_fused import (
    icp_iteration_moments,
    icp_iteration_moments_plain,
)

pytestmark = pytest.mark.gpu

# Same selections and products on both sides; only the order of the
# f32/f64 sums differs (per-block double partials vs one double sum).
RTOL, ATOL = 1e-4, 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _case(rng, B, N, M, device):
    xi = rng.normal(0.0, [1.0, 1.0, 0.2, 0.02, 0.02, 0.1], (B, 6)).astype(np.float32)
    T = se3_exp(torch.from_numpy(xi)).contiguous()
    src = torch.from_numpy(rng.normal(0, 15, (B, N, 3)).astype(np.float32))
    tgt = torch.from_numpy(rng.normal(0, 15, (B, M, 3)).astype(np.float32))
    sm = torch.from_numpy((rng.uniform(size=(B, N)) > 0.2).astype(np.float32))
    tm = torch.from_numpy((rng.uniform(size=(B, M)) > 0.3).astype(np.float32))
    return [x.to(device) for x in (T, src, sm, tgt, tm)]


@pytest.mark.parametrize("B,N,M", [(1, 1, 1), (3, 257, 1025), (5, 700, 2048)])
def test_kernel_matches_plain(cuda, B, N, M):
    args = _case(np.random.default_rng(N + M), B, N, M, cuda)
    before = icp_fused.ICP_MOMENTS_LAUNCHES
    k = icp_iteration_moments(*args)
    torch.cuda.synchronize()
    assert icp_fused.ICP_MOMENTS_LAUNCHES == before + 1
    p = icp_iteration_moments_plain(*args)
    torch.testing.assert_close(k, p, rtol=RTOL, atol=ATOL)


def test_fully_masked_pairs(cuda):
    T, src, sm, tgt, tm = _case(np.random.default_rng(1), 3, 300, 400, cuda)
    tm[1] = 0.0
    sm[2] = 0.0
    k = icp_iteration_moments(T, src, sm, tgt, tm)
    p = icp_iteration_moments_plain(T, src, sm, tgt, tm)
    torch.testing.assert_close(k, p, rtol=RTOL, atol=ATOL)
    assert k[1, 0].item() == 0.0 and k[2].abs().max().item() == 0.0


def test_exact_ties_average(cuda):
    tgt = torch.tensor([[1.0, 2.0, 0.0], [1.0, -2.0, 0.0], [50.0, 50.0, 50.0]],
                       device=cuda)
    m = icp_iteration_moments(torch.eye(4, device=cuda),
                              torch.zeros((1, 3), device=cuda),
                              torch.ones(1, device=cuda), tgt,
                              torch.ones(3, device=cuda))
    assert m.shape == (19,)
    torch.testing.assert_close(m[4:7], torch.tensor([1.0, 0.0, 0.0], device=cuda))
    assert m[16].item() == 5.0


def test_three_way_ties_and_inactive_pairs(cuda):
    """Pair 0: four targets at d2 = 5 from source 0 at the origin (rows 1,
    40, 900 and 2000: two in the kernel's first 64-row chunk, then two
    chunks later) average to (0.25, 0.75, 0.5); two at d2 = 5 from source 1
    at (30, 0, 0), only in different chunks, to (31.5, 1.5, 0). Pair 1:
    sources masked in between; pair 2 inactive: a zero row, and the other
    rows identical to the call without the mask."""
    B, N, M = 3, 600, 2048
    T, src, sm, tgt, tm = _case(np.random.default_rng(7), B, N, M, cuda)
    tgt[0] = 60.0
    for row, v in ((1, (2., 1., 0.)), (40, (1., 2., 0.)), (900, (-2., 1., 0.)),
                   (2000, (0., -1., 2.)), (100, (32., 1., 0.)), (1500, (31., 2., 0.))):
        tgt[0, row] = torch.tensor(v, device=cuda)
    tm[0] = 1.0
    tm[0, 500:700] = 0.0
    T[0] = torch.eye(4, device=cuda)
    src[0, 0] = 0.0
    src[0, 1] = torch.tensor([30.0, 0.0, 0.0], device=cuda)
    sm[0, :2] = 1.0
    sm[1, ::3] = 0.0
    k = icp_iteration_moments(T, src, sm, tgt, tm)
    torch.testing.assert_close(k, icp_iteration_moments_plain(T, src, sm, tgt, tm),
                               rtol=RTOL, atol=ATOL)
    two = icp_iteration_moments(T[0], src[0, :2], sm[0, :2], tgt[0], tm[0])
    assert two[4:7].tolist() == [31.75, 2.25, 0.5] and two[16].item() == 10.0
    active = torch.tensor([True, True, False], device=cuda)
    ka = icp_iteration_moments(T, src, sm, tgt, tm, active=active)
    assert torch.equal(ka[:2], k[:2]) and ka[2].abs().max().item() == 0.0
    pa = icp_iteration_moments_plain(T, src, sm, tgt, tm, active=active)
    torch.testing.assert_close(ka, pa, rtol=RTOL, atol=ATOL)


def test_multi_tile_ties(cuda):
    """K1 beyond one 2048-row tile (the local-map shape): 4 pairs x 4096 x
    4096, the tie re-scan reading L2. Pair 0: a tie across the tile
    boundary (rows 2047 and 2048), a four-way tie over both tiles, a tie
    whose first row is in the second tile; pair 3: 2049 live targets among
    masked rows, a tie between the first and the last. Dyadic offsets, so
    the averages are exact."""
    rng = np.random.default_rng(12)
    B, N, M = 4, 4096, 4096
    T, src, sm, tgt, tm = _case(rng, B, N, M, cuda)
    tm[:3] = 1.0
    T[0] = T[3] = torch.eye(4, device=cuda)
    ties = [((200., 0., 0.), 0, (2047, 2048), ((1., 2., 0.), (1., -2., 0.))),
            ((0., 200., 0.), 0, (5, 1000, 3000, 4095),
             ((2., 1., 0.), (1., 2., 0.), (-2., 1., 0.), (0., -1., 2.))),
            ((0., -200., 0.), 0, (3500, 3600), ((1., 2., 0.), (2., 1., 0.)))]
    live = np.sort(rng.choice(M, 2049, replace=False))
    tm[3] = 0.0
    tm[3, torch.from_numpy(live).to(cuda)] = 1.0
    ties.append(((0., 0., 300.), 3, (int(live[0]), int(live[-1])),
                 ((1., 2., 0.), (2., 1., 0.))))
    for i, (p, b, rows, offs) in enumerate(ties):
        src[b, i], sm[b, i] = torch.tensor(p, device=cuda), 1.0
        for r, o in zip(rows, offs):
            tgt[b, r] = torch.tensor(p, device=cuda) + torch.tensor(o, device=cuda)
    k = icp_iteration_moments(T, src, sm, tgt, tm)
    torch.testing.assert_close(k, icp_iteration_moments_plain(T, src, sm, tgt, tm),
                               rtol=RTOL, atol=ATOL)
    for i, (p, b, rows, offs) in enumerate(ties):
        m = icp_iteration_moments(T[b], src[b, i:i + 1], sm[b, i:i + 1], tgt[b], tm[b])
        assert m[4:7].tolist() == list(np.asarray(p) + np.mean(offs, axis=0)), rows
        assert m[16].item() == 5.0, rows


def test_prepared_clouds_match_per_call(cuda):
    from icp4dradar_tpu_torch.ops.icp_fused import icp_moments, icp_prepare

    T, src, sm, tgt, tm = _case(np.random.default_rng(9), 4, 700, 3000, cuda)
    ops = icp_prepare(src, sm, tgt, tm)
    src4, src_live, tgt4, tgt_live = ops.packed
    assert torch.equal(src_live, (sm != 0).sum(1, dtype=torch.int32))
    assert torch.equal(tgt4[0, :int(tgt_live[0]), :3], tgt[0][tm[0] > 0.5])
    for step in (0.0, 0.01):
        Ts = (se3_exp(torch.full((4, 6), step)) @ T.cpu()).to(cuda).contiguous()
        assert torch.equal(icp_moments(Ts, ops), icp_iteration_moments(Ts, src, sm, tgt, tm))


def test_rejects_what_the_kernel_does_not_take(cuda):
    T, src, sm, tgt, tm = _case(np.random.default_rng(2), 2, 64, 64, cuda)
    with pytest.raises(ValueError):
        icp_iteration_moments(T, src.double(), sm, tgt, tm)
    with pytest.raises(ValueError):
        icp_iteration_moments(T, src.transpose(0, 1).contiguous().transpose(0, 1),
                              sm, tgt, tm)
    with pytest.raises(ValueError):
        icp_iteration_moments(T, src, sm.cpu(), tgt, tm)


# ---- the fused VGICP sweep (csrc/vgicp_sweep.cu) against its plain version.
# Same selections and per-point f32 terms on both sides (-fmad=false and the
# plain version's separately rounded ops); only the order of the float64
# sums differs, so the f32 results agree to a few ulps.
from icp4dradar_tpu_torch.ops import vgicp_fused  # noqa: E402
from icp4dradar_tpu_torch.ops.vgicp_fused import (  # noqa: E402
    radar_point_covariances_packed,
    vgicp_iteration,
    vgicp_iteration_batch,
    vgicp_iteration_plain,
)

VG_RTOL, VG_ATOL = 1e-5, 1e-4


def _vgicp_case(rng, B, N, P, count, device, scale=20.0):
    xi = rng.normal(0.0, [0.3, 0.3, 0.05, 0.01, 0.01, 0.05], (B, 6)).astype(np.float32)
    T = se3_exp(torch.from_numpy(xi)).contiguous()
    src = torch.from_numpy(rng.uniform(-scale, scale, (B, N, 3)).astype(np.float32))
    sm = torch.from_numpy((rng.uniform(size=(B, N)) > 0.1).astype(np.float32))
    scov = radar_point_covariances_packed(src)
    tgt = torch.from_numpy(rng.uniform(-scale, scale, (P, 3)).astype(np.float32))
    tcov = np.zeros((P, 6), np.float32)
    tcov[:, :3] = np.abs(rng.normal(0.05, 0.02, (P, 3))) + 0.01
    tcov[:, 3:] = rng.normal(0.0, 0.003, (P, 3))
    tmask = torch.from_numpy((np.arange(P) < count).astype(np.float32))
    cnt = torch.tensor(count, dtype=torch.int32)
    return [x.to(device) for x in (T, src, sm, scov, tgt, torch.from_numpy(tcov),
                                   tmask, cnt)]


def _assert_vgicp_close(k, p):
    for a, b in zip(k, p):
        torch.testing.assert_close(a, b, rtol=VG_RTOL, atol=VG_ATOL)


@pytest.mark.parametrize("B,N,P,count", [
    (1, 1, 1, 1), (1, 700, 2100, 2100), (3, 256, 2100, 1100), (8, 512, 5000, 900),
    (2, 384, 500, 0)])
def test_vgicp_kernel_matches_plain(cuda, B, N, P, count):
    T, src, sm, scov, tgt, tcov, tmask, cnt = _vgicp_case(
        np.random.default_rng(B + N + P), B, N, P, count, cuda)
    kw = dict(tgt_count=cnt, ts=min(128, N), return_best=True)
    before = vgicp_fused.VGICP_SWEEP_LAUNCHES
    if B == 1:
        args = (T[0], src[0], sm[0], scov[0], tgt, tcov, tmask)
        k = vgicp_iteration(*args, **kw)
        p = vgicp_iteration_plain(*args, **kw)
    else:
        k = vgicp_iteration_batch(T, src, sm, scov, tgt, tcov, tmask, **kw)
        p = vgicp_iteration_plain(T, src.reshape(B * N, 3), sm.reshape(B * N),
                                  scov.reshape(B * N, 6), tgt, tcov, tmask,
                                  _acc_groups=B, **kw)
    torch.cuda.synchronize()
    assert vgicp_fused.VGICP_SWEEP_LAUNCHES == before + 1
    _assert_vgicp_close(k, p)
    if count == 0:
        assert float(k[3].sum()) == 0.0


def test_vgicp_kernel_exact_ties(cuda):
    """Ties average inside a tile; a later tile must be strictly closer."""
    P = 2048
    tgt = torch.full((P, 3), 90.0)
    tgt[3], tgt[700], tgt[1500] = (torch.tensor(v) for v in
                                   ((1., 2., 0.), (1., -2., 0.), (-1., 2., 0.)))
    tgt[5], tgt[1100], tgt[1800] = (torch.tensor(v) for v in
                                    ((20., 3., 0.), (21., 0., 1.), (19., 0., -1.)))
    tcov = torch.zeros((P, 6))
    tcov[:, :3] = 0.05
    src = torch.tensor([[0.0, 0.0, 0.0], [20.0, 0.0, 0.0]])
    args = [x.to(cuda) for x in (torch.eye(4), src, torch.ones(2),
                                 radar_point_covariances_packed(src), tgt, tcov,
                                 torch.ones(P))]
    k = vgicp_iteration(*args, max_correspondence_dist=3.0, ts=8, return_best=True)
    best = k[5][0].cpu()
    assert best[:4, 0].tolist() == [5.0, 1.0, 0.0, 0.0]
    assert best[:4, 1].tolist() == [2.0, 20.0, 0.0, 0.0]
    p = vgicp_iteration_plain(*args, max_correspondence_dist=3.0, ts=8, return_best=True)
    _assert_vgicp_close(k, p)


def test_vgicp_kernel_three_way_ties_across_row_ranges(cuda):
    """Three rows of one tile at d2 = 5 from source 0, in three different
    warps' row ranges (rows 3, 400, 1000 of 1024 live), average in row
    order; masked rows between them are skipped."""
    P = 1024
    tgt = torch.full((P, 3), 90.0)
    for row, v in ((3, (2., 1., 0.)), (400, (1., 2., 0.)), (1000, (-2., 1., 0.))):
        tgt[row] = torch.tensor(v)
    tcov = torch.zeros((P, 6))
    tcov[:, :3] = torch.arange(P, dtype=torch.float32)[:, None] / 64.0
    tmask = torch.ones(P)
    tmask[100:300] = 0.0
    src = torch.tensor([[0.0, 0.0, 0.0], [20.0, 0.0, 0.0]])
    args = [x.to(cuda) for x in (torch.eye(4), src, torch.ones(2),
                                 radar_point_covariances_packed(src), tgt, tcov, tmask)]
    k = vgicp_iteration(*args, max_correspondence_dist=3.0, ts=8, return_best=True)
    best = k[5][0].cpu()
    three = np.float32(3.0)
    assert best[:4, 0].tolist() == [5.0, float(np.float32(1.0) / three),
                                    float(np.float32(4.0) / three), 0.0]
    want = float(np.float32((3 + 400 + 1000) / 64.0) / three)
    assert best[4, 0].item() == want
    p = vgicp_iteration_plain(*args, max_correspondence_dist=3.0, ts=8, return_best=True)
    _assert_vgicp_close(k, p)


def test_vgicp_prepared_operands_match_per_call(cuda):
    """The prepared path (operands packed once, swept at several T) gives
    what the per-call path gives, for the sweep, the batched sweep and the
    frozen step; neither call copies anything from the host."""
    from icp4dradar_tpu_torch.ops.vgicp_fused import vgicp_frozen, vgicp_prepare, vgicp_sweep

    B, N, P = 4, 512, 3000
    T, src, sm, scov, tgt, tcov, tmask, cnt = _vgicp_case(
        np.random.default_rng(17), B, N, P, 2500, cuda)
    ops = vgicp_prepare(src, sm, scov, tgt, tcov, tmask, ts=128, tgt_count=cnt)
    one = vgicp_prepare(src[0], sm[0], scov[0], tgt, tcov, tmask, ts=128, tgt_count=cnt)
    for step in (0.0, 0.02):
        Ts = (se3_exp(torch.full((B, 6), step)) @ T.cpu()).to(cuda).contiguous()
        torch.cuda.set_sync_debug_mode("error")
        try:
            kb = vgicp_sweep(Ts, ops, return_best=True, _acc_groups=B)
            k1 = vgicp_sweep(Ts[0], one, return_best=True)
            f1 = vgicp_frozen(Ts[0], one, k1[5])
        finally:
            torch.cuda.set_sync_debug_mode("default")
        wb = vgicp_iteration_batch(Ts, src, sm, scov, tgt, tcov, tmask, ts=128, tgt_count=cnt,
                                   return_best=True)
        w1 = vgicp_iteration(Ts[0], src[0], sm[0], scov[0], tgt, tcov, tmask, ts=128,
                             tgt_count=cnt, return_best=True)
        g1 = vgicp_iteration_frozen(Ts[0], src[0], sm[0], scov[0], k1[5])
        for a, b in zip(kb + k1 + f1, wb + w1 + g1):
            assert torch.equal(a, b)
    # all frames summed into one result: the per-block rows summed by torch
    ka = vgicp_sweep(T, ops, _acc_groups=1)
    pa = vgicp_iteration_plain(T, src.reshape(B * N, 3), sm.reshape(B * N),
                               scov.reshape(B * N, 6), tgt, tcov, tmask, ts=128, tgt_count=cnt)
    _assert_vgicp_close(ka, pa)


def test_vgicp_kernel_rejects_what_it_does_not_take(cuda):
    T, src, sm, scov, tgt, tcov, tmask, cnt = _vgicp_case(
        np.random.default_rng(3), 1, 64, 64, 64, cuda)
    with pytest.raises(ValueError):
        vgicp_iteration(T[0], src[0].double(), sm[0], scov[0], tgt, tcov, tmask)
    with pytest.raises(ValueError):
        vgicp_iteration(T[0], src[0], sm[0].cpu(), scov[0], tgt, tcov, tmask)


def _streams_case(rng, S, F, N, P, counts, device):
    """S streams of F frames of N sources, each stream against its own
    P-row submap whose first counts[s] rows are live."""
    xi = rng.normal(0.0, [0.3, 0.3, 0.05, 0.01, 0.01, 0.05], (S * F, 6)).astype(np.float32)
    T = se3_exp(torch.from_numpy(xi)).contiguous()
    src = torch.from_numpy(rng.uniform(-20, 20, (S * F, N, 3)).astype(np.float32))
    sm = torch.from_numpy((rng.uniform(size=(S * F, N)) > 0.1).astype(np.float32))
    scov = radar_point_covariances_packed(src)
    tgt = torch.from_numpy(rng.uniform(-20, 20, (S, P, 3)).astype(np.float32))
    tcov = np.zeros((S, P, 6), np.float32)
    tcov[..., :3] = np.abs(rng.normal(0.05, 0.02, (S, P, 3))) + 0.01
    tcov[..., 3:] = rng.normal(0.0, 0.003, (S, P, 3))
    cnt = torch.tensor(counts, dtype=torch.int32)
    tmask = (torch.arange(P)[None] < cnt[:, None]).float()
    return [x.to(device) for x in (T, src, sm, scov, tgt, torch.from_numpy(tcov), tmask, cnt)]


@pytest.mark.parametrize("S,F,N,P,counts", [
    (4, 8, 2048, 16384, (801, 0, 542, 16384)),    # serving: 4 x 8 frames, an empty stream
    (3, 1, 512, 2100, (1100, 2100, 7)),           # the per-frame batch: one frame a stream
    (2, 40000, 8, 16, (16, 9))])                  # two launches: grid.y holds 65,535 frames
def test_vgicp_kernel_stream_axis(cuda, S, F, N, P, counts):
    """K4 with a stream axis: frame b sweeps the submap of stream b // F. One
    launch per 65,535 frames (the second chunk starts inside stream 1), no
    host sync; equal to S single-target calls bit for bit, and to the plain
    version within the tolerance of the single-target tests."""
    from icp4dradar_tpu_torch.ops.vgicp_fused import vgicp_prepare, vgicp_sweep

    T, src, sm, scov, tgt, tcov, tmask, cnt = _streams_case(
        np.random.default_rng(S + F), S, F, N, P, counts, cuda)
    ts = min(2048, N)
    ops = vgicp_prepare(src, sm, scov, tgt, tcov, tmask, ts=ts, tgt_count=cnt)
    before = vgicp_fused.VGICP_SWEEP_LAUNCHES
    torch.cuda.set_sync_debug_mode("error")
    try:
        k = vgicp_sweep(T, ops, return_best=True, _acc_groups=S * F)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert vgicp_fused.VGICP_SWEEP_LAUNCHES == before + -(-(S * F) // 65535)
    nb = F * N // ts
    for s in range(S):
        fs = slice(s * F, (s + 1) * F)
        one = vgicp_iteration_batch(T[fs], src[fs], sm[fs], scov[fs], tgt[s], tcov[s],
                                    tmask[s], ts=ts, tgt_count=cnt[s], return_best=True)
        for a, b in zip(k[:5], one[:5]):
            assert torch.equal(a[fs], b.reshape(a[fs].shape))   # one frame: no (1,) axis
        assert torch.equal(k[5][s * nb:(s + 1) * nb], one[5])
        if counts[s] == 0:
            assert float(k[3][fs].abs().sum()) == 0.0
    if F * S <= 64:
        p = vgicp_iteration_plain(T, src.reshape(-1, 3), sm.reshape(-1), scov.reshape(-1, 6),
                                  tgt, tcov, tmask, tgt_count=cnt, ts=ts, return_best=True,
                                  _acc_groups=S * F)
        _assert_vgicp_close(k, p)


@pytest.mark.parametrize("S,N,counts", [
    (1, 16384, (2932,)),                          # the rigid union: 8 x 2048 sources
    (4, 16384, (801, 189, 2932, 16384)),          # a union a stream (the blocked batch)
    (1, 8192, (2932,))])                          # a window of 4 scans (accumulate_scans=4)
def test_vgicp_kernel_at_the_union_and_window_shapes(cuda, S, N, counts):
    """K4 at the sparse-vendor paths' shapes, packed as the trackers pack
    them (ts 2048, one transform a stream against its own 16,384-row
    submap): one launch, no host sync, equal to the plain version within
    the single-target tests' tolerance."""
    from icp4dradar_tpu_torch.ops.vgicp_fused import vgicp_prepare, vgicp_sweep

    T, src, sm, scov, tgt, tcov, tmask, cnt = _streams_case(
        np.random.default_rng(S + N), S, 1, N, 16384, counts, cuda)
    ops = vgicp_prepare(src, sm, scov, tgt, tcov, tmask, tgt_count=cnt)
    assert ops.ts == 2048 and ops.frames == S
    before = vgicp_fused.VGICP_SWEEP_LAUNCHES
    torch.cuda.set_sync_debug_mode("error")
    try:
        k = vgicp_sweep(T, ops, _acc_groups=S)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert vgicp_fused.VGICP_SWEEP_LAUNCHES == before + 1
    p = vgicp_iteration_plain(T, src.reshape(-1, 3), sm.reshape(-1), scov.reshape(-1, 6), tgt,
                              tcov, tmask, tgt_count=cnt, _acc_groups=S)
    _assert_vgicp_close(k, p)


def test_batched_map_cuda_matches_cpu(cuda):
    """A batched map's insert (with and without the leader budget), forget
    and rehash on the card give the CPU's tables, bit for bit."""
    from icp4dradar_tpu_torch.mapping import (
        voxel_map_create, voxel_map_forget_far, voxel_map_insert, voxel_map_maybe_rehash,
        voxel_map_rehash,
    )

    rng = np.random.default_rng(4)
    S, n = 3, 2048
    maps = {d: voxel_map_create(1 << 14, streams=S, device=d) for d in ("cpu", cuda)}
    for rnd in range(4):
        pts = rng.uniform(-30, 30, (S, n, 3)).astype(np.float32) + [2.0 * rnd, 0.0, 0.0]
        mask = (rng.uniform(size=(S, n)) > 0.1).astype(np.float32)
        inten = rng.uniform(0, 30, (S, n)).astype(np.float32)
        lb = 1500 if rnd % 2 else None
        maps = {d: voxel_map_insert(m, *(torch.from_numpy(x).to(d) for x in (pts, mask, inten)),
                                    leader_budget=lb) for d, m in maps.items()}
    center = torch.tensor([[20.0, 0.0, 0.0], [-25.0, 5.0, 0.0], [0.0, 0.0, 0.0]])
    forgot = {d: voxel_map_forget_far(m, center.to(d), 15.0) for d, m in maps.items()}
    for stage in (maps, forgot,
                  {d: voxel_map_rehash(m) for d, m in forgot.items()},
                  {d: voxel_map_maybe_rehash(m, 0.05) for d, m in forgot.items()}):
        for a, b in zip(stage["cpu"].tables(), stage[cuda].tables()):
            assert torch.equal(a, b.cpu())
    assert bool((forgot["cpu"].num_voxels < maps["cpu"].num_voxels).all())


def test_small_products_round_alike_at_every_batch_size(cuda):
    """On the card, where a cuBLAS product and a library reduction may round
    a row by the size of its batch, `small_matmul`, `small_matvec` and
    `pairwise_sum` give row 0 the same bits at every batch size, within
    float32 round-off of `@` and torch's sum."""
    from icp4dradar_tpu_torch.geom.linalg import pairwise_sum, small_matmul, small_matvec

    g = torch.Generator(device=cuda).manual_seed(3)
    A, B = (torch.randn(1024, 4, 4, device=cuda, generator=g) for _ in range(2))
    M, v = torch.randn(1024, 3, 3, device=cuda, generator=g), torch.randn(1024, 3, device=cuda,
                                                                          generator=g)
    P = torch.randn(64, 2048, 3, device=cuda, generator=g) * 30
    for n in (2, 4, 37, 1024):
        k = min(n, 64)
        for got, one in ((small_matmul(A[:n], B[:n]), small_matmul(A[:1], B[:1])),
                         (small_matvec(M[:n], v[:n]), small_matvec(M[:1], v[:1])),
                         (small_matmul(P[:k], M[:k]), small_matmul(P[:1], M[:1])),
                         (pairwise_sum(P[:k], dim=-2), pairwise_sum(P[:1], dim=-2))):
            assert torch.equal(got[:1], one)
    torch.testing.assert_close(small_matmul(A, B), A @ B, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(pairwise_sum(P, dim=-2), P.sum(-2), rtol=1e-5, atol=1e-2)


def test_map_api_cuda_matches_cpu(cuda):
    """The ikd-Tree-style edits and queries on the card give the CPU's
    tables, points, masks and counts, bit for bit."""
    from icp4dradar_tpu_torch.mapping import (
        voxel_map_add_box, voxel_map_box_search, voxel_map_create, voxel_map_delete_box,
        voxel_map_delete_box_acquire, voxel_map_delete_points, voxel_map_insert,
        voxel_map_maybe_rehash, voxel_map_radius_search,
    )

    rng = np.random.default_rng(6)
    vm = voxel_map_create(1 << 14, device="cpu")
    for rnd in range(3):
        pts = rng.uniform(-30, 30, (2048, 3)).astype(np.float32) + [3.0 * rnd, 0.0, 0.0]
        vm = voxel_map_insert(vm, torch.from_numpy(pts), torch.ones(2048),
                              torch.from_numpy(rng.uniform(0, 30, 2048).astype(np.float32)))
    probe = torch.from_numpy(np.concatenate([pts[:500], rng.uniform(60, 90, (100, 3))])
                             .astype(np.float32))
    pmask = (torch.arange(600) % 3 != 0).float()
    c, lo, hi = torch.tensor([2.0, 1.0, 0.0]), torch.tensor([-5.0, -8.0, -30.0]), \
        torch.tensor([12.0, 9.0, 30.0])

    def run(dev):
        m = vm.with_tables(t.to(dev) for t in vm.tables())
        cd, lod, hid = c.to(dev), lo.to(dev), hi.to(dev)
        deleted = voxel_map_delete_box(m, lod, hid)
        acq = voxel_map_delete_box_acquire(m, lod, hid, 4096)
        return [voxel_map_radius_search(m, cd, 10.0, 4096),
                voxel_map_box_search(m, lod, hid, 1024),
                deleted.tables(), acq[0].tables() + acq[1:],
                voxel_map_add_box(deleted, lod, cd).tables(),
                voxel_map_delete_points(m, probe.to(dev), pmask.to(dev)).tables(),
                voxel_map_maybe_rehash(deleted, 0.01).tables()]

    for got, want in zip(run(cuda), run("cpu")):
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b)


def test_session_resume_equals_straight_run(cuda, tmp_path):
    """A session on the card checkpointed after 4 `process` calls, resumed
    by a new session and fed the same 8 frames in `process_batch(block=4)`,
    equals the session that ran straight through, bit for bit."""
    from icp4dradar_tpu_torch.config import PipelineConfig
    from icp4dradar_tpu_torch.io import SyntheticSequence, stack_scans
    from icp4dradar_tpu_torch.models import OdometrySession

    cfg = PipelineConfig().override(**{"voxel_map.capacity": 1 << 14,
                                       "voxel_map.submap_max_points": 1 << 12})
    seq = SyntheticSequence(num_frames=12, max_points=512, num_landmarks=4000,
                            world_extent=80.0, max_range=60.0, seed=0)
    scans = stack_scans([seq.scan(k, device=cuda) for k in range(12)])
    a = OdometrySession(cfg, checkpoint_dir=str(tmp_path), checkpoint_every=4, device=cuda)
    for k in range(4):
        a.process(scans[k])
    assert OdometrySession.has_checkpoint(str(tmp_path))
    a.checkpoint_every = 0
    out_a = a.process_batch(scans[4:12], block=4)
    b = OdometrySession(cfg, checkpoint_dir=str(tmp_path), device=cuda)
    assert b.resume() == 4
    out_b = b.process_batch(scans[4:12], block=4)
    for f in ("world_T", "correction", "iterations", "insert_mask", "fitness"):
        assert torch.equal(getattr(out_a, f), getattr(out_b, f)), f
    assert torch.equal(a.state.world_T, b.state.world_T)
    for x, y in zip(a.state.vmap.tables(), b.state.vmap.tables()):
        assert x.is_cuda and torch.equal(x, y)


@pytest.mark.parametrize("block", [0, 8])
def test_batch_stream_equals_its_single_stream_run(cuda, block):
    """A stream of `run_scan_to_map_batch` on the card equals the
    single-stream runner on it (a batch of one), bit for bit: every output,
    the final pose and the tables."""
    import dataclasses

    from icp4dradar_tpu_torch.config import PipelineConfig
    from icp4dradar_tpu_torch.io import SyntheticSequence, stack_scans
    from icp4dradar_tpu_torch.models import scan_to_map as pm
    from icp4dradar_tpu_torch.preprocess import draw_reve_uniforms

    cfg = PipelineConfig().override(**{"voxel_map.capacity": 1 << 14,
                                       "voxel_map.submap_max_points": 1 << 12})
    B, F = 2, (16 if block else 6)
    seq = SyntheticSequence(num_frames=B * F, max_points=512, num_landmarks=4000,
                            world_extent=80.0, max_range=60.0, seed=0)
    frames = stack_scans([seq.scan(k, device=cuda) for k in range(B * F)])
    scans = type(frames)(**{f.name: getattr(frames, f.name).unflatten(0, (B, F))
                            for f in dataclasses.fields(frames)})
    g = torch.Generator(device=cuda).manual_seed(5)
    U = torch.stack([draw_reve_uniforms((F,), cfg.reve, g, cuda) for _ in range(B)])
    kw = dict(block=block, use_const_velocity_rot=True)
    bst, bo = pm.run_scan_to_map_batch(scans, cfg, uniforms=U, **kw)
    for b in range(B):
        if block:
            sst, so = pm.run_scan_to_map_blocked(scans[b], cfg, uniforms=U[b],
                                                 sequential_fallback=False, **kw)
        else:
            sst, so = pm.run_scan_to_map(scans[b], cfg, uniforms=U[b],
                                         use_const_velocity_rot=True)
        for f in dataclasses.fields(so):
            assert torch.equal(getattr(bo, f.name)[b], getattr(so, f.name)), f.name
        for x, y in zip(bst.vmap.stream(b).tables(), sst.vmap.tables()):
            assert torch.equal(x, y)
        assert torch.equal(bst.world_T[b], sst.world_T)


# ---- the masked 1-NN search (csrc/nn_search.cu, K2 and K3) against its
# plain version: the same fused multiply-adds and the same tie rule, so
# indices, distances and coordinates are equal, not merely close.
import importlib  # noqa: E402

nn = importlib.import_module("icp4dradar_tpu_torch.ops.knn")


def _nn_case(rng, n, m, live, device, scale=60.0):
    src = torch.from_numpy(rng.uniform(-scale, scale, (n, 3)).astype(np.float32))
    tgt = torch.from_numpy(rng.uniform(-scale, scale, (m, 3)).astype(np.float32))
    mask = torch.from_numpy((rng.uniform(size=m) < live).astype(np.float32))
    return [x.to(device) for x in (src, tgt, mask)]


def _assert_nn_equal(src, tgt, mask):
    """The per-call search and coordinate search (a packing launch and a
    search launch each), and the prepared search and coordinate search (one
    launch each, no host sync), against the all-rows plain version and the
    prepared plain versions: equal indices, distances and coordinates."""
    before = (nn.NN_SEARCH_LAUNCHES, nn.NN_COORDS_LAUNCHES, nn.NN_PACK_LAUNCHES)
    ki, kd = nn.nearest_neighbor(src, tgt, mask)
    kd2, kq = nn.nearest_neighbor_with_coords(src, tgt, mask)
    torch.cuda.synchronize()
    assert (nn.NN_SEARCH_LAUNCHES, nn.NN_COORDS_LAUNCHES, nn.NN_PACK_LAUNCHES) == (
        before[0] + 1, before[1] + 1, before[2] + 2)
    torch.cuda.set_sync_debug_mode("error")
    try:
        ops = nn.nn_prepare(tgt, mask)
        si, sd = nn.nn_search(src, ops)
        cd, cq = nn.nn_search_coords(src, ops)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert (nn.NN_SEARCH_LAUNCHES, nn.NN_COORDS_LAUNCHES, nn.NN_PACK_LAUNCHES) == (
        before[0] + 2, before[1] + 2, before[2] + 3)
    for a, b in zip((ops.rows, ops.orig, ops.count), nn.nn_pack_plain(tgt.cpu(), mask.cpu())):
        assert torch.equal(a.cpu(), b)
    pi, pd = nn.nearest_neighbor_plain(src, tgt, mask)
    qi, qd = nn.nn_search_plain(src, ops)
    pcd, pcq = nn.nn_search_coords_plain(src, ops)
    assert ki.dtype == torch.int32 and torch.equal(ki, pi)
    assert torch.equal(kd, pd) and torch.equal(kd2, pd) and torch.equal(cd, pd)
    assert torch.equal(kq, tgt[pi.long()]) and torch.equal(cq, kq)
    assert torch.equal(pcd, pd) and torch.equal(pcq, kq)
    assert torch.equal(si, pi) and torch.equal(sd, pd)
    assert torch.equal(qi, pi) and torch.equal(qd, pd)
    return ki, kd


@pytest.mark.parametrize("n,m,live", [(1, 1, 1.0), (2048, 16384, 0.05), (2048, 16384, 1.0),
                                      (4096, 16384, 0.15),   # kNN GICP with a window scan
                                      (1000, 5001, 0.7), (130, 300, 0.5)])
def test_nn_kernels_match_plain(cuda, n, m, live):
    src, tgt, mask = _nn_case(np.random.default_rng(n + m), n, m, live, cuda)
    mask[0] = 1.0
    _assert_nn_equal(src, tgt, mask)


def test_nn_kernels_ties_and_all_masked(cuda):
    m = 16384
    tgt = torch.full((m, 3), 90.0)
    # rows 3 and 9000 tie at d2 = 5 in different row ranges: 3 wins; rows
    # 12000 and 15000 tie at d2 = 2 for the second source: 12000 wins
    for row, v in ((3, (1., 2., 0.)), (9000, (1., -2., 0.)), (5, (20., 3., 0.)),
                   (12000, (21., 0., 1.)), (15000, (19., 0., -1.))):
        tgt[row] = torch.tensor(v)
    src = torch.tensor([[0.0, 0.0, 0.0], [20.0, 0.0, 0.0]])
    ki, kd = _assert_nn_equal(src.to(cuda), tgt.to(cuda), torch.ones(m, device=cuda))
    assert ki.tolist() == [3, 12000] and kd.tolist() == [5.0, 2.0]
    ki, kd = _assert_nn_equal(src.to(cuda), tgt.to(cuda), torch.zeros(m, device=cuda))
    assert ki.tolist() == [0, 0] and bool((kd == torch.tensor(1e30, device=cuda)).all())


@pytest.mark.parametrize("m,live", [(1, 1.0), (1023, 0.5), (1025, 0.0), (16384, 0.033),
                                    (20000, 1.0)])
def test_nn_packing_matches_plain(cuda, m, live):
    """The packing kernel against the stable sort of its plain version:
    the same rows, original indices and live count, also where the rows
    do not fill the block's runs evenly."""
    _, tgt, mask = _nn_case(np.random.default_rng(m), 1, m, live, cuda)
    ops = nn.nn_prepare(tgt, mask)
    for a, b in zip((ops.rows, ops.orig, ops.count), nn.nn_pack_plain(tgt, mask)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(ops.count) == int((mask > 0.5).sum())


def test_nn_search_far_live_row_falls_back(cuda):
    """One live row 2e15 m away among masked rows: its d2 (4e30) is not
    below the penalty, every source re-scans all rows, and masked row 0
    wins at 1e30, as in the Pallas kernel. Sources near a second, ordinary
    live row keep it."""
    src, tgt, _ = _nn_case(np.random.default_rng(6), 2048, 16384, 1.0, cuda)
    mask = torch.zeros(16384, device=cuda)
    tgt[7] = torch.tensor([2e15, 0.0, 0.0], device=cuda)
    mask[7] = 1.0
    ki, kd = _assert_nn_equal(src, tgt, mask)
    assert bool((ki == 0).all()) and bool((kd == torch.tensor(1e30, device=cuda)).all())
    mask[9000] = 1.0
    ki, kd = _assert_nn_equal(src, tgt, mask)
    assert bool((ki == 9000).all()) and bool((kd < 1e30).all())


def test_nn_search_coords_one_launch_no_sync(cuda):
    """A coordinate search on prepared targets is one launch of the search
    kernel, counted as a coordinate search, that never waits for the
    device; two launches give the same bits."""
    src, tgt, mask = _nn_case(np.random.default_rng(8), 2048, 16384, 0.04, cuda)
    ops = nn.nn_prepare(tgt, mask)
    torch.cuda.synchronize()
    before = (nn.NN_SEARCH_LAUNCHES, nn.NN_COORDS_LAUNCHES, nn.NN_PACK_LAUNCHES)
    torch.cuda.set_sync_debug_mode("error")
    try:
        d1, q1 = nn.nn_search_coords(src, ops)
        d2, q2 = nn.nn_search_coords(src, ops)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert (nn.NN_SEARCH_LAUNCHES, nn.NN_COORDS_LAUNCHES, nn.NN_PACK_LAUNCHES) == (
        before[0], before[1] + 2, before[2])
    assert torch.equal(d1, d2) and torch.equal(q1, q2)
    pd, pq = nn.nn_search_coords_plain(src, ops)
    assert torch.equal(d1, pd) and torch.equal(q1, pq)


def test_nn_kernels_reject_what_they_do_not_take(cuda):
    src, tgt, mask = _nn_case(np.random.default_rng(4), 64, 64, 1.0, cuda)
    with pytest.raises(ValueError):
        nn.nearest_neighbor(src.double(), tgt, mask)
    with pytest.raises(ValueError):
        nn.nearest_neighbor(src, tgt.t().contiguous().t(), mask)
    with pytest.raises(ValueError):
        nn.nearest_neighbor_with_coords(src, tgt, mask.cpu())
    with pytest.raises(ValueError):
        nn.nearest_neighbor_with_coords(src, tgt[:, :2].contiguous(), mask)
    ops = nn.nn_prepare(tgt, mask)
    with pytest.raises(ValueError):
        nn.nn_search_coords(src.double(), ops)
    with pytest.raises(ValueError):
        nn.nn_search_coords(src.cpu(), ops)
    with pytest.raises(ValueError):
        nn.nn_search(src.double(), ops)
    with pytest.raises(ValueError):
        nn.nn_search(src.t().contiguous().t(), ops)
    with pytest.raises(ValueError):
        nn.nn_search(src.cpu(), ops)
    with pytest.raises(ValueError):
        nn.nn_search(src[:, :2].contiguous(), ops)
    with pytest.raises(ValueError):
        nn.nn_prepare(tgt, mask.cpu())
    with pytest.raises(ValueError):
        nn.nn_prepare(tgt.double(), mask)


@pytest.mark.parametrize("S,n,m,lives", [(1, 300, 700, (0.5,)), (3, 1000, 5001, (0.7, 0.0, 1.0)),
                                         (4, 2048, 16384, (0.04, 0.05, 0.03, 1.0))])
def test_nn_stream_axis_matches_plain_and_single_target_calls(cuda, S, n, m, lives):
    """K2 with a stream axis: one packing launch and one search launch for
    all S streams, with no host sync, equal to the plain version with the
    stream axis and to S single-target calls, bit for bit (a stream with
    every row masked among them)."""
    rng = np.random.default_rng(S + n + m)
    cases = [_nn_case(rng, n, m, live, cuda) for live in lives]
    src, tgt, mask = (torch.stack([c[k] for c in cases]) for k in range(3))
    torch.cuda.synchronize()
    before = (nn.NN_SEARCH_LAUNCHES, nn.NN_PACK_LAUNCHES)
    torch.cuda.set_sync_debug_mode("error")
    try:
        ops = nn.nn_prepare(tgt, mask)
        ki, kd = nn.nn_search(src, ops)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert (nn.NN_SEARCH_LAUNCHES, nn.NN_PACK_LAUNCHES) == (before[0] + 1, before[1] + 1)
    assert ki.shape == kd.shape == (S, n) and ops.count.shape == (S,)
    for a, b in zip((ops.rows, ops.orig, ops.count), nn.nn_pack_plain(tgt, mask)):
        assert torch.equal(a, b)
    pi, pd = nn.nn_search_plain(src, ops)
    assert torch.equal(ki, pi) and torch.equal(kd, pd)
    for s in range(S):
        si, sd = nn.nearest_neighbor(src[s], tgt[s], mask[s])
        assert torch.equal(ki[s], si) and torch.equal(kd[s], sd)


def test_knn_gicp_batch_stream_equals_its_single_stream_run(cuda):
    """kNN GICP inside the per-frame batch on the card: each stream equals
    the single-stream runner on it, bit for bit (every output, the final
    pose and the tables)."""
    import dataclasses

    from icp4dradar_tpu_torch.config import PipelineConfig
    from icp4dradar_tpu_torch.io import SyntheticSequence, stack_scans
    from icp4dradar_tpu_torch.models import scan_to_map as pm
    from icp4dradar_tpu_torch.preprocess import draw_reve_uniforms

    cfg = PipelineConfig().override(**{"voxel_map.capacity": 1 << 14,
                                       "voxel_map.submap_max_points": 1 << 12,
                                       "gicp.use_vgicp": False})
    B, F = 2, 6
    seq = SyntheticSequence(num_frames=B * F, max_points=512, num_landmarks=4000,
                            world_extent=80.0, max_range=60.0, seed=0)
    frames = stack_scans([seq.scan(k, device=cuda) for k in range(B * F)])
    scans = type(frames)(**{f.name: getattr(frames, f.name).unflatten(0, (B, F))
                            for f in dataclasses.fields(frames)})
    g = torch.Generator(device=cuda).manual_seed(5)
    U = torch.stack([draw_reve_uniforms((F,), cfg.reve, g, cuda) for _ in range(B)])
    bst, bo = pm.run_scan_to_map_batch(scans, cfg, uniforms=U, use_const_velocity_rot=True)
    for b in range(B):
        sst, so = pm.run_scan_to_map(scans[b], cfg, uniforms=U[b], use_const_velocity_rot=True)
        for f in dataclasses.fields(so):
            assert torch.equal(getattr(bo, f.name)[b], getattr(so, f.name)), f.name
        for x, y in zip(bst.vmap.stream(b).tables(), sst.vmap.tables()):
            assert torch.equal(x, y)


def test_nccl_world_of_one(cuda, tmp_path):
    """The multi-device layer under NCCL at world size 1 (a FileStore, no
    network): the sharded batch equals run_scan_to_map_batch bit for bit,
    dp ICP equals the single-device ICP, and the distributed block GN lies
    within 1e-4 of the single-device solve."""
    import dataclasses

    import torch.distributed as dist

    from icp4dradar_tpu_torch.config import PipelineConfig
    from icp4dradar_tpu_torch.graph import PoseGraph, RelPoseFactors, optimize_pose_graph_block
    from icp4dradar_tpu_torch.io import SyntheticSequence, stack_scans
    from icp4dradar_tpu_torch.models import scan_to_map as pm
    from icp4dradar_tpu_torch.parallel import (
        batched_icp_pairs,
        distributed_optimize_pose_graph_block,
        make_mesh,
        shard_scan_batch,
        sharded_scan_to_map_batch,
    )
    from icp4dradar_tpu_torch.preprocess import reve_hypotheses
    from icp4dradar_tpu_torch.utils import reve_batch_uniforms

    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        mesh = make_mesh()
        cfg = PipelineConfig().override(**{"voxel_map.capacity": 1 << 14,
                                           "voxel_map.submap_max_points": 1 << 12})
        B, F = 2, 8
        seq = SyntheticSequence(num_frames=B * F, max_points=512, num_landmarks=4000,
                                world_extent=80.0, max_range=60.0, seed=0)
        frames = stack_scans([seq.scan(k, device=cuda) for k in range(B * F)])
        scans = type(frames)(**{f.name: getattr(frames, f.name).unflatten(0, (B, F))
                                for f in dataclasses.fields(frames)})
        st, so = sharded_scan_to_map_batch(scans, mesh, cfg, block=4,
                                           use_const_velocity_rot=True)
        U = torch.from_numpy(reve_batch_uniforms(cfg.seed, B, F, 4, reve_hypotheses(cfg.reve)))
        rst, ro = pm.run_scan_to_map_batch(scans, cfg, uniforms=U.to(cuda), block=4,
                                           use_const_velocity_rot=True,
                                           sequential_fallback=True)
        for f in dataclasses.fields(so):
            assert torch.equal(getattr(so, f.name), getattr(ro, f.name)), f.name
        src, tgt = frames[1:], frames[:-1]
        T = batched_icp_pairs(shard_scan_batch(src, mesh), shard_scan_batch(tgt, mesh), mesh,
                              cfg)
        from icp4dradar_tpu_torch.registration import icp_point_to_point
        assert torch.equal(T, icp_point_to_point(src.xyz, tgt.xyz, src.mask, tgt.mask,
                                                 cfg=cfg.icp).transform)
        K = T.shape[0] + 1
        rel = RelPoseFactors.build(np.arange(K - 1), np.arange(1, K), T)
        graph = PoseGraph(poses=torch.eye(4, device=cuda).repeat(K, 1, 1), rel=rel)
        gd, _ = distributed_optimize_pose_graph_block(graph, mesh)
        gs, _ = optimize_pose_graph_block(graph)
        torch.testing.assert_close(gd.poses, gs.poses, rtol=0, atol=1e-4)
    finally:
        dist.destroy_process_group()


# ---- the frozen-payload GN pass (vgicp_frozen_launch, K5) against its
# plain version on a payload of the sweep kernel.
from icp4dradar_tpu_torch.ops.vgicp_fused import (  # noqa: E402
    vgicp_iteration_frozen,
    vgicp_iteration_frozen_plain,
)


@pytest.mark.parametrize("B,N,P,count,groups", [
    (1, 700, 2100, 2100, 1), (8, 512, 5000, 900, 8), (8, 512, 5000, 900, 1),
    (1, 2048, 3000, 2500, 1), (2, 384, 500, 0, 2)])
def test_vgicp_frozen_kernel_matches_plain(cuda, B, N, P, count, groups):
    T, src, sm, scov, tgt, tcov, tmask, cnt = _vgicp_case(
        np.random.default_rng(B * N + P), B, N, P, count, cuda)
    kw = dict(tgt_count=cnt, ts=128, return_best=True)
    best = (vgicp_iteration_batch(T, src, sm, scov, tgt, tcov, tmask, **kw) if B > 1 else
            vgicp_iteration(T[0], src[0], sm[0], scov[0], tgt, tcov, tmask, **kw))[5]
    best[::3, 0, ::5] = 1e30                      # rows never matched: no weight
    T1 = (se3_exp(torch.full((B, 6), 0.01)) @ T.cpu()).to(cuda).contiguous()
    flat = (src.reshape(B * N, 3), sm.reshape(B * N), scov.reshape(B * N, 6), best)
    before = vgicp_fused.VGICP_FROZEN_LAUNCHES
    k = vgicp_iteration_frozen(T1 if B > 1 else T1[0], *flat, _acc_groups=groups)
    torch.cuda.synchronize()
    assert vgicp_fused.VGICP_FROZEN_LAUNCHES == before + 1
    p = vgicp_iteration_frozen_plain(T1 if B > 1 else T1[0], *flat, _acc_groups=groups)
    _assert_vgicp_close(k, p)
    assert k[0].shape == ((groups, 6, 6) if groups > 1 else (6, 6))
    if count == 0:
        assert float(k[3].abs().sum()) == 0.0


def test_vgicp_frozen_kernel_is_deterministic_and_syncs_nothing(cuda):
    """Two launches on the same inputs give the same bits (fixed-order
    float64 sums, no atomics); a call on prepared sources neither waits for
    the device nor copies from the host, and launches once."""
    from icp4dradar_tpu_torch.ops.vgicp_fused import vgicp_frozen, vgicp_prepare

    B, N = 8, 2048
    T, src, sm, scov, tgt, tcov, tmask, cnt = _vgicp_case(
        np.random.default_rng(23), B, N, 4000, 3000, cuda)
    best = vgicp_iteration_batch(T, src, sm, scov, tgt, tcov, tmask, tgt_count=cnt,
                                 return_best=True)[5]
    ops = vgicp_prepare(src, sm, scov, ts=best.shape[2])
    for groups in (1, B):
        before = vgicp_fused.VGICP_FROZEN_LAUNCHES
        torch.cuda.set_sync_debug_mode("error")
        try:
            a = vgicp_frozen(T, ops, best, _acc_groups=groups)
            b = vgicp_frozen(T, ops, best, _acc_groups=groups)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert vgicp_fused.VGICP_FROZEN_LAUNCHES == before + 2
        assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_vgicp_frozen_kernel_rejects_what_it_does_not_take(cuda):
    T, src, sm, scov, tgt, tcov, tmask, cnt = _vgicp_case(
        np.random.default_rng(5), 1, 64, 64, 64, cuda)
    best = vgicp_iteration(T[0], src[0], sm[0], scov[0], tgt, tcov, tmask, ts=64,
                           return_best=True)[5]
    with pytest.raises(ValueError):
        vgicp_iteration_frozen(T[0], src[0].double(), sm[0], scov[0], best)
    with pytest.raises(ValueError):
        vgicp_iteration_frozen(T[0], src[0], sm[0], scov[0], best.cpu())
    with pytest.raises(ValueError):
        vgicp_iteration_frozen(T[0], src[0, :32], sm[0, :32], scov[0, :32], best)
    with pytest.raises(ValueError):
        vgicp_iteration_frozen(T[0], src[0], sm[0], scov[0], best.transpose(1, 2))
    with pytest.raises(ValueError):                 # one frame in two groups
        vgicp_iteration_frozen(T[0][None].expand(1, 4, 4), src[0], sm[0], scov[0], best,
                               _acc_groups=2)


def test_bag_stacked_scans_cuda_equal_cpu(cuda, tmp_path):
    from icp4dradar_tpu_torch.io import RadarBagDataset, SyntheticSequence, write_synthetic_bag

    path = str(tmp_path / "a.bag")
    write_synthetic_bag(path, SyntheticSequence(num_frames=8, max_points=256,
                                                num_landmarks=2000, seed=0))
    ds = RadarBagDataset(path, "/radar", "/gt", "/imu", max_points=256, use_native=True)
    assert ds.native_used
    on_card, on_cpu = ds.stacked_scans(cuda), ds.stacked_scans()
    for f in ("xyz", "doppler", "intensity", "mask", "time"):
        a, b = getattr(on_card, f), getattr(on_cpu, f)
        assert a.is_cuda and a.shape[0] == 8 and torch.equal(a.cpu(), b), f


def test_replay_cuda_equals_cpu(cuda):
    from icp4dradar_tpu_torch import PipelineConfig
    from icp4dradar_tpu_torch.io import SyntheticSequence, stack_scans
    from icp4dradar_tpu_torch.models import run_scan_to_scan_replay
    from icp4dradar_tpu_torch.preprocess import draw_uniforms

    seq = SyntheticSequence(num_frames=16, max_points=512, num_landmarks=3000, seed=0)
    scans = stack_scans([seq.scan(k) for k in range(16)])
    rel = np.stack([np.eye(4, dtype=np.float32)] + [
        np.linalg.inv(seq.poses[k - 1]) @ seq.poses[k] for k in range(1, 16)])
    cfg = PipelineConfig()
    u = draw_uniforms((16,), cfg.doppler.num_hypotheses, torch.Generator().manual_seed(0))
    before = icp_fused.ICP_MOMENTS_LAUNCHES
    a = run_scan_to_scan_replay(scans.to(cuda), torch.from_numpy(rel).to(cuda), cfg,
                                uniforms=u.to(cuda))
    b = run_scan_to_scan_replay(scans, rel, cfg, uniforms=u)
    assert icp_fused.ICP_MOMENTS_LAUNCHES == before         # no ICP in a replay
    torch.testing.assert_close(a.world_T.cpu(), b.world_T, atol=1e-4, rtol=0)
    np.testing.assert_allclose(b.world_T[:, :3, 3].numpy(), seq.poses[:, :3, 3], atol=1e-4)
    torch.testing.assert_close(a.velocity.cpu(), b.velocity, atol=1e-4, rtol=0)


def test_timer_profiler_and_float_guard_on_cuda(cuda, tmp_path):
    import json

    from icp4dradar_tpu_torch.utils import StageTimer, checked, profile_trace

    timer = StageTimer()
    x = torch.rand(1 << 20, device=cuda)
    timer.tic("mm")
    y = {"a": [x * 2.0]}
    assert timer.toc("mm", sync=y) >= 0.0 and timer.counts["mm"] == 1
    with profile_trace(str(tmp_path / "prof")):
        (x @ x).item()
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())["traceEvents"]
    assert any(e.get("cat") == "kernel" for e in events)

    def masked(t):
        return torch.where(t > 5, torch.log(t - 2), torch.zeros_like(t))

    with pytest.raises(FloatingPointError, match="aten.log"):
        checked(masked)(torch.tensor([1.0, 10.0], device=cuda))


# ---- the trackers' spans and `host_syncs` counter on the card
def _synchronizing_calls(fn):
    """(result, synchronizing CUDA calls that sync debug mode reports,
    what the program recorded) of fn() under `recording()`."""
    import warnings

    from icp4dradar_tpu_torch.utils import profiling

    profiling.reset()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            with profiling.recording():
                out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    rec = profiling.recorded()
    profiling.reset()
    syncs = [w for w in caught if "synchronizing" in str(w.message)]
    return out, syncs, rec


@pytest.mark.parametrize("tracker", ["fleet", "s2s"])
def test_host_syncs_count_every_synchronizing_call(cuda, tracker):
    """Over one small fleet replay (the blocked batch) and one scan-to-scan
    replay, `host_syncs` equals the synchronizing calls sync debug mode
    reports, each counted at its call site."""
    from icp4dradar_tpu_torch.config import PipelineConfig
    from icp4dradar_tpu_torch.io import SyntheticSequence
    from icp4dradar_tpu_torch.io.scan import stack_scans
    from icp4dradar_tpu_torch.models.scan_to_map import run_scan_to_map_batch
    from icp4dradar_tpu_torch.models.scan_to_scan import run_scan_to_scan

    def frames(n, seed):
        seq = SyntheticSequence(num_frames=n, max_points=2048, num_landmarks=8000, seed=seed,
                                speed=1.0)
        return stack_scans([seq.scan(k, device=cuda) for k in range(n)])

    if tracker == "fleet":
        scans = stack_scans([frames(24, s) for s in (1, 2)])
        cfg = PipelineConfig().override(**{"voxel_map.capacity": 1 << 16,
                                           "voxel_map.submap_max_points": 1 << 13})

        def run():
            return run_scan_to_map_batch(scans, cfg, block=8, use_const_velocity_rot=True)[1]
    else:
        scans = frames(64, 3)

        def run():
            return run_scan_to_scan(scans, PipelineConfig(), use_doppler_prior=True)

    run()                        # first calls build their constants
    out, syncs, rec = _synchronizing_calls(run)
    assert int(out.iterations.max()) > 0
    where = sorted({f"{w.filename}:{w.lineno}" for w in syncs})
    assert rec.counters.get("host_syncs", 0) == len(syncs), where


def test_spans_hold_their_kernels_on_the_trace_clock(cuda, tmp_path):
    """Under a CUDA-only profile, as the benchmark's traced section runs it,
    each `torch.cuda._sleep` kernel launched inside a span starts at or
    after the span's start on the trace's clock (ts + baseTimeNanoseconds,
    moved by the clock anchors of the anchored span around them) to within
    50 us, and, launched on an idle stream, soon after it."""
    import json

    from torch.profiler import ProfilerActivity, profile

    from icp4dradar_tpu_torch.utils import profiling
    from radarbench import spans as bench

    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    profiling.reset()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with profiling.span("replay", anchor=True):
            for i in range(32):
                if i % 2:
                    torch.cuda.synchronize()        # every other kernel on an idle stream
                with profiling.span("sleep"):
                    torch.cuda._sleep(20000)
    rec = profiling.recorded()
    profiling.reset()
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    doc = json.loads((tmp_path / "trace.json").read_text())
    base = doc["baseTimeNanoseconds"]
    ops = [(e["name"], float(e["ts"]) * 1e-6, (float(e["ts"]) + float(e.get("dur", 0))) * 1e-6)
           for e in doc["traceEvents"] if e.get("ph") == "X"
           and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    corr = bench.anchor_corrections(rec.anchors, base, ops)
    # the replay's start and end; a profile can lose its first records
    assert len(rec.anchors) == 2 and len(corr) >= 1
    spans = [s for s in bench.on_trace_clock(rec.spans, base, corr) if s.name == "sleep"]
    starts = sorted(float(e["ts"]) * 1e-6 for e in doc["traceEvents"] if e.get("cat") == "kernel")
    assert len(starts) == len(spans) == 32
    for i, (k, s) in enumerate(zip(starts, spans)):
        assert k >= s.start - 50e-6, (i, (k - s.start) * 1e6)
        if i % 2:
            assert k <= s.end + 2e-3, (i, (k - s.end) * 1e6)


# ---- the map-sharded layer under NCCL at world size 1: the ring's K4
# (`return_best`) and K5 passes against the single-device sweep, the
# sharded insert against the single-device map, and the CLI's refusal of
# more ranks than cards.
def test_ring_normal_equations_world_one_match_vgicp_iteration(cuda, tmp_path):
    """At world size 1 the ring is one K4 sweep with `return_best` and one
    K5 step on its payload (the exchange is the identity): the sums of
    `vgicp_iteration` on the same target within 1e-4 of their largest
    entry (the frozen step re-derives d2 from the payload), wsum equal; a
    sharded insert holds the single-device map's voxel content."""
    import torch.distributed as dist

    from icp4dradar_tpu_torch.mapping import voxel_map_create, voxel_map_insert
    from icp4dradar_tpu_torch.ops import vgicp_fused
    from icp4dradar_tpu_torch.parallel import (
        make_mesh,
        ring_vgicp_normal_equations,
        sharded_map_create,
        sharded_map_insert,
    )

    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        mesh = make_mesh()
        T, src, sm, scov, tgt, tcov, tmask, cnt = _vgicp_case(
            np.random.default_rng(11), 1, 2048, 4096, 4096, cuda)
        k4, k5 = vgicp_fused.VGICP_SWEEP_LAUNCHES, vgicp_fused.VGICP_FROZEN_LAUNCHES
        ring = ring_vgicp_normal_equations(T[0], src[0], sm[0], scov[0], tgt, tcov, tmask,
                                           mesh)
        torch.cuda.synchronize()
        assert vgicp_fused.VGICP_SWEEP_LAUNCHES == k4 + 1
        assert vgicp_fused.VGICP_FROZEN_LAUNCHES == k5 + 1
        single = vgicp_iteration(T[0], src[0], sm[0], scov[0], tgt, tcov, tmask)
        for a, b in zip(ring, single):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4 * float(b.abs().max()) + 1e-3)
        assert float(ring[3]) == float(single[3]) > 0
        pts = torch.from_numpy(np.random.default_rng(3).uniform(-20, 20, (3000, 3))
                               .astype(np.float32)).to(cuda)
        got = sharded_map_insert(sharded_map_create(mesh, capacity=1 << 14), mesh, pts).gather()
        ref = voxel_map_insert(voxel_map_create(1 << 14, device=cuda), pts)

        def content(m):
            occ = m.occupied.cpu().numpy() > 0.5
            return dict(zip(map(tuple, m.keys.cpu().numpy()[occ]),
                            zip(map(tuple, np.round(m.points.cpu().numpy()[occ], 5)),
                                m.stat_n.cpu().numpy()[occ])))

        assert content(got) == content(ref)
    finally:
        dist.destroy_process_group()


def test_cli_distributed_refuses_more_ranks_than_cards(cuda, capsys):
    """`--distributed N --device cuda` with fewer than N cards is a usage
    error: never fewer ranks, never gloo."""
    from icp4dradar_tpu_torch.models import run_odometry

    n = torch.cuda.device_count() + 1
    with pytest.raises(SystemExit) as e:
        run_odometry.main(["--mode", "scan_to_map", "--synthetic", "8", "--distributed", str(n),
                           "--device", "cuda", "--out", "unused"])
    assert e.value.code == 2
    assert f"--distributed {n} --device cuda needs {n} CUDA devices" in capsys.readouterr().err


# ---- the damped GN step (csrc/gn_step.cu) against its plain version: the
# same float32 operations in the same order, each small product's sum in the
# order torch.sum takes it, so T and dlt are equal bit for bit, and a held
# frame keeps its T.
gn_step_mod = importlib.import_module("icp4dradar_tpu_torch.ops.gn_step")
GN_LM = 1e-6
GN_KINDS = ("active", "inactive", "nonfinite", "taylor", "one_rad")


def _gn_frames(n, device, seed=0):
    """n frames, frame f of kind GN_KINDS[f % 5]: T, H (SPD, a sweep's
    scale), g = -(H + lm I) xi for a chosen xi (theta^2 = 2.9e-9 for
    'taylor', theta = 1 rad for 'one_rad'), non-finite H for 'nonfinite',
    inactive for 'inactive' -> ((T, H, g, active), kinds)."""
    rng = np.random.default_rng(seed)
    T = se3_exp(torch.from_numpy(rng.normal(0, [2.0, 2.0, 0.2, 0.1, 0.1, 1.0], (n, 6))
                                 .astype(np.float32)))
    J = rng.normal(0, 1, (n, 64, 6)) * [1, 1, 1, 8, 8, 8]
    H = np.einsum("nki,nkj->nij", J, J) * 20.0
    xi = rng.normal(0, [0.05, 0.05, 0.02, 0.01, 0.01, 0.02], (n, 6))
    kind = np.arange(n) % len(GN_KINDS)
    xi[kind == 3, 3:] = [3e-5, -2e-5, 4e-5]
    xi[kind == 4, 3:] = np.array([1.0, -2.0, 2.0]) / 3.0
    g = -np.einsum("nij,nj->ni", H + GN_LM * np.eye(6), xi)
    H = torch.from_numpy(H.astype(np.float32))
    H[torch.from_numpy(kind == 2)] = float("nan")
    args = (T, H, torch.from_numpy(g.astype(np.float32)), torch.from_numpy(kind != 1))
    return tuple(x.to(device) for x in args), torch.from_numpy(kind).to(device)


@pytest.mark.parametrize("n", [1, 16, 128, 1000])
def test_gn_step_kernel_matches_plain(cuda, n):
    (T, H, g, active), kind = _gn_frames(n, cuda, seed=n)
    for mask in (active, None):
        before = gn_step_mod.GN_STEP_LAUNCHES
        Tk, dk = gn_step_mod.gn_step(T, H, g, GN_LM, mask)
        torch.cuda.synchronize()
        assert gn_step_mod.GN_STEP_LAUNCHES == before + 1
        Tp, dp = gn_step_mod.gn_step_plain(T, H, g, GN_LM, mask)
        assert torch.equal(Tk, Tp) and torch.equal(dk, dp)
        held = (kind == 2) | ((kind == 1) & (mask is not None))
        assert torch.equal(Tk[held], T[held]) and not dk[held].any()
        assert bool(dk[~held].gt(0).all())


def test_gn_step_kernel_rows_keep_their_bits_and_nothing_syncs(cuda):
    """Row 0 has the same bits at every batch size; two launches on the
    same inputs give the same bits; a call neither waits for the device
    nor copies from the host, and launches once."""
    (T, H, g, active), _ = _gn_frames(1000, cuda, seed=7)
    one = gn_step_mod.gn_step(T[:1], H[:1], g[:1], GN_LM, active[:1])
    for n in (16, 128, 1000):
        got = gn_step_mod.gn_step(T[:n], H[:n], g[:n], GN_LM, active[:n])
        assert all(torch.equal(a[:1], b) for a, b in zip(got, one))
    before = gn_step_mod.GN_STEP_LAUNCHES
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        a = gn_step_mod.gn_step(T, H, g, GN_LM, active)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert gn_step_mod.GN_STEP_LAUNCHES == before + 1
    b = gn_step_mod.gn_step(T, H, g, GN_LM, active)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    # strided views (the frozen step's rows of 45) launch as they are
    rows = torch.cat([H.reshape(-1, 36), g, torch.zeros(1000, 3, device=cuda)], dim=-1)
    c = gn_step_mod.gn_step(T, rows[:, :36].unflatten(-1, (6, 6)), rows[:, 36:42], GN_LM, active)
    assert all(torch.equal(x, y) for x, y in zip(a, c))


def test_gn_step_launches_equal_the_gn_sweeps(cuda):
    """In one `vgicp_align_block` run the GN steps launch once a K4 sweep;
    with inner steps `vgicp_align_streams` once a sweep or K5 step."""
    from icp4dradar_tpu_torch.config import GicpConfig
    from icp4dradar_tpu_torch.registration import vgicp as reg

    S, B, N, P = 2, 4, 512, 3000
    rng = np.random.default_rng(11)
    world = rng.uniform(-20, 20, (S, P, 3)).astype(np.float32)
    world[..., 2] *= 0.1
    tcov = np.zeros((S, P, 6), np.float32)
    tcov[..., :3] = np.abs(rng.normal(0.02, 0.005, (S, P, 3)))
    pick = rng.integers(0, P, (S, B, N))
    src = np.take_along_axis(world[:, None], pick[..., None], axis=2) \
        + rng.normal(0, 0.02, (S, B, N, 3))
    src, world, tcov = (torch.from_numpy(x.astype(np.float32)).to(cuda) for x in (src, world, tcov))
    init = se3_exp(torch.tensor([[0.2, -0.1, 0.0, 0.0, 0.0, 0.01]] * (S * B))).to(cuda)
    sm, tm = torch.ones(S, B, N, device=cuda), torch.ones(S, P, device=cuda)
    scov = radar_point_covariances_packed(src)
    k4, k5, gn = (vgicp_fused.VGICP_SWEEP_LAUNCHES, vgicp_fused.VGICP_FROZEN_LAUNCHES,
                  gn_step_mod.GN_STEP_LAUNCHES)
    r, _ = reg.vgicp_align_block(src, world, tcov, sm, tm, scov, init.reshape(S, B, 4, 4),
                                 GicpConfig(max_iterations=8))
    sweeps = vgicp_fused.VGICP_SWEEP_LAUNCHES - k4
    assert sweeps > 1 and gn_step_mod.GN_STEP_LAUNCHES - gn == sweeps
    assert int(r.iterations.max()) == sweeps
    k4, gn = vgicp_fused.VGICP_SWEEP_LAUNCHES, gn_step_mod.GN_STEP_LAUNCHES
    reg.vgicp_align_streams(src[:, 0], world, tcov, sm[:, 0], tm, scov[:, 0], init[::B],
                            GicpConfig(max_iterations=8, inner_gn_steps=1))
    steps = vgicp_fused.VGICP_SWEEP_LAUNCHES - k4 + vgicp_fused.VGICP_FROZEN_LAUNCHES - k5
    assert steps > 2 and gn_step_mod.GN_STEP_LAUNCHES - gn == steps
