"""Port ICP-moments parity on the CPU: the plain version of the CUDA kernel
against the Pallas kernel run in interpret mode (as tests/test_ops.py runs
it), against the XLA first-argmin oracle on tie-free data, and on exact
ties; the batched form against separate calls; `moments_to_transform` and
batched ICP against the JAX package.

Tolerance rtol 1e-4 / atol 1e-3 on the moments (the one used for the Pallas
kernel against the XLA oracle): the selections are identical, the sums run
in another order (float64 here, f32 tree sums there)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icp4dradar_tpu.config import IcpConfig
from icp4dradar_tpu.geom import se3_exp as j_se3_exp
from icp4dradar_tpu.ops import icp_fused as jf
from icp4dradar_tpu.registration.icp import icp_point_to_point as j_icp
from icp4dradar_tpu_torch.ops import _build
from icp4dradar_tpu_torch.ops import icp_fused as pf
from icp4dradar_tpu_torch.registration import icp_point_to_point as p_icp

RTOL, ATOL = 1e-4, 1e-3


def _pair(rng, n, m, scale=5.0):
    src = (rng.normal(size=(n, 3)) * scale).astype(np.float32)
    tgt = (rng.normal(size=(m, 3)) * scale).astype(np.float32)
    sm = (rng.uniform(size=n) > 0.1).astype(np.float32)
    tm = (rng.uniform(size=m) > 0.2).astype(np.float32)
    T = np.asarray(j_se3_exp(jnp.asarray([0.1, -0.2, 0.05, 0.02, 0.0, 0.1],
                                         dtype=jnp.float32)))
    return T, src, sm, tgt, tm


def _t(*xs):
    return [torch.tensor(np.asarray(x)) for x in xs]


@pytest.mark.parametrize("tile_m", [1024, 64])
def test_plain_matches_pallas_interpret(tile_m):
    T, src, sm, tgt, tm = _pair(np.random.default_rng(42), 200, 290)
    m_pal = jf.icp_iteration_moments(*map(jnp.asarray, (T, src, sm, tgt, tm)),
                                     ts=128, interpret=True)
    m_port = pf.icp_iteration_moments_plain(*_t(T, src, sm, tgt, tm),
                                            tile_m=tile_m)
    np.testing.assert_allclose(m_port.numpy(), np.asarray(m_pal), rtol=RTOL, atol=ATOL)


def test_plain_matches_xla_oracle_tie_free():
    T, src, sm, tgt, tm = _pair(np.random.default_rng(7), 333, 517, scale=10.0)
    m_xla = jf.icp_iteration_moments_xla(*map(jnp.asarray, (T, src, sm, tgt, tm)))
    m_port = pf.icp_iteration_moments(*_t(T, src, sm, tgt, tm))
    np.testing.assert_allclose(m_port.numpy(), np.asarray(m_xla), rtol=RTOL, atol=ATOL)


def _moments_both(T, src, sm, tgt, tm, **plain_kw):
    m_pal = np.asarray(jf.icp_iteration_moments(
        *map(jnp.asarray, (T, src, sm, tgt, tm)), interpret=True))
    m_port = pf.icp_iteration_moments_plain(*_t(T, src, sm, tgt, tm),
                                            **plain_kw).numpy()
    return m_pal, m_port


@pytest.mark.parametrize("tile_m", [1024, 1])
def test_exact_ties_average_like_pallas(tile_m):
    # t0/t1 at exactly d2 = 5.0 from the origin (in different tiles when
    # tile_m = 1, so the running tie merge is exercised); t2 far
    tgt = np.asarray([[1.0, 2.0, 0.0], [1.0, -2.0, 0.0], [50.0, 50.0, 50.0]],
                     np.float32)
    m_pal, m_port = _moments_both(np.eye(4, dtype=np.float32),
                                  np.zeros((1, 3), np.float32),
                                  np.ones(1, np.float32), tgt,
                                  np.ones(3, np.float32), tile_m=tile_m)
    np.testing.assert_allclose(m_port, m_pal, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(m_port[4:7], [1.0, 0.0, 0.0], atol=1e-6)
    np.testing.assert_allclose(m_port[16], 5.0, rtol=1e-6)


def test_four_way_ties_with_masked_rows_like_pallas():
    """Four targets at exactly d2 = 5 from source 0 (masked rows between
    them) and two from source 1, dyadic coordinates: every summation order
    gives the same mean, so the Pallas kernel and the port agree exactly."""
    tgt = np.full((300, 3), 60.0, np.float32)
    for row, v in ((1, (2, 1, 0)), (40, (1, 2, 0)), (150, (-2, 1, 0)), (290, (0, -1, 2)),
                   (100, (32, 1, 0)), (250, (31, 2, 0))):
        tgt[row] = v
    tm = np.ones(300, np.float32)
    tm[50:90] = 0.0
    src = np.asarray([[0, 0, 0], [30, 0, 0]], np.float32)
    m_pal, m_port = _moments_both(np.eye(4, dtype=np.float32), src, np.ones(2, np.float32),
                                  tgt, tm, tile_m=64)
    np.testing.assert_array_equal(m_port, m_pal)
    np.testing.assert_array_equal(m_port[4:7], [31.75, 2.25, 0.5])
    assert m_port[16] == 10.0


def test_active_mask_zeroes_inactive_pairs():
    rng = np.random.default_rng(13)
    pairs = [_pair(rng, 90, 120) for _ in range(3)]
    stacked = [torch.tensor(np.stack([p[i] for p in pairs])) for i in range(5)]
    full = pf.icp_iteration_moments(*stacked)
    active = torch.tensor([True, False, True])
    part = pf.icp_iteration_moments(*stacked, active=active)
    assert torch.equal(part[active], full[active])
    assert part[1].abs().max().item() == 0.0
    ops = pf.icp_prepare(*stacked[1:])
    assert ops.packed is None                      # the CPU keeps the caller's layout
    assert torch.equal(pf.icp_moments(stacked[0], ops, active=active), part)
    with pytest.raises(ValueError):
        pf.icp_moments(stacked[0], ops, active=torch.ones(2, dtype=torch.bool))


def test_pack_live_first_keeps_row_order():
    rng = np.random.default_rng(1)
    xyz = torch.tensor(rng.normal(size=(3, 50, 3)).astype(np.float32))
    mask = torch.tensor((rng.uniform(size=(3, 50)) > 0.4).astype(np.float32))
    mask[2] = 0.0                                   # nothing live: original order
    packed, live = pf._pack_live_first(xyz, mask, mask > 0.5)
    assert live.tolist() == [int(m.sum()) for m in mask] and live.dtype == torch.int32
    for b in range(3):
        on = mask[b] > 0.5
        order = torch.cat([torch.nonzero(on).flatten(), torch.nonzero(~on).flatten()])
        assert torch.equal(packed[b, :, :3], xyz[b, order])
        assert torch.equal(packed[b, :, 3], mask[b, order])


def _seed_icp_loop(src, tgt, sm, tm, cfg):
    """The ICP loop as it ran before frozen pairs were skipped: every pair
    swept at every iteration, frozen pairs' moments thrown away."""
    from icp4dradar_tpu_torch.geom.se3 import se3_log

    B = src.shape[0]
    T = torch.eye(4).expand(B, 4, 4).contiguous()
    iters = torch.zeros(B, dtype=torch.int32)
    delta = torch.full((B,), float("inf"))
    active = torch.ones(B, dtype=torch.bool)
    for _ in range(cfg.max_iterations):
        if not bool(active.any()):
            break
        dT, _ = pf.moments_to_transform(pf.icp_iteration_moments(
            T, src, sm, tgt, tm, cfg.max_correspondence_dist))
        T = torch.where(active[:, None, None], dT @ T, T).contiguous()
        delta = torch.where(active, torch.sum(torch.abs(se3_log(dT)), dim=-1), delta)
        iters = iters + active.to(torch.int32)
        active = (iters < cfg.max_iterations) & (delta > cfg.transformation_epsilon)
    gm = pf.icp_iteration_moments(T, src, sm, tgt, tm, cfg.max_correspondence_dist)
    return T, iters, gm


def test_icp_frozen_pair_skip_is_bit_exact():
    """Skipping converged pairs changes no bit of the CPU result: the
    transforms, iteration counts and final moments of the loop that swept
    every pair at every iteration."""
    rng = np.random.default_rng(11)
    B, n = 3, 120
    cfg = IcpConfig()
    tgt = (rng.normal(size=(B, n, 3)) * 8.0).astype(np.float32)
    xi = (rng.normal(size=(B, 6)) * [1.0, 1.0, 0.3, 0.05, 0.05, 0.1]).astype(np.float32)
    xi[2] *= 0.001                                   # converges first
    T_true = np.asarray(j_se3_exp(jnp.asarray(xi)))
    src = np.einsum("bij,bnj->bni", T_true[:, :3, :3].transpose(0, 2, 1),
                    tgt - T_true[:, None, :3, 3]).astype(np.float32)
    sm = (rng.uniform(size=(B, n)) > 0.1).astype(np.float32)
    tm = np.ones((B, n), np.float32)
    args = _t(src, tgt, sm, tm)
    res = p_icp(*args, cfg=cfg)
    T, iters, gm = _seed_icp_loop(args[0], args[1], args[2], args[3], cfg)
    assert len(set(res.iterations.tolist())) > 1
    assert torch.equal(res.transform, T) and torch.equal(res.iterations, iters)
    assert torch.equal(res.fitness, gm[:, 17] / torch.clamp(gm[:, 18], min=1e-9))


def test_duplicated_target_rows_like_pallas():
    src = np.asarray([[0.2, -0.1, 0.3]], np.float32)
    t_near = np.asarray([0.5, 0.0, 0.2], np.float32)
    tgt1 = np.stack([t_near, [9.0, 9.0, 9.0]]).astype(np.float32)
    tgt2 = np.stack([t_near, t_near, [9.0, 9.0, 9.0]]).astype(np.float32)
    eye, one = np.eye(4, dtype=np.float32), np.ones(1, np.float32)
    pal1, port1 = _moments_both(eye, src, one, tgt1, np.ones(2, np.float32))
    pal2, port2 = _moments_both(eye, src, one, tgt2, np.ones(3, np.float32))
    np.testing.assert_allclose(port2, port1, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(port2, pal2, rtol=1e-6, atol=1e-7)


def test_batched_equals_separate_calls():
    rng = np.random.default_rng(3)
    pairs = [_pair(rng, 150, 180) for _ in range(4)]
    stacked = [torch.tensor(np.stack([p[i] for p in pairs])) for i in range(5)]
    stacked[2][1] = 0.0            # a pair with no valid source point
    stacked[4][2] = 0.0            # a pair with no valid target point
    batched = pf.icp_iteration_moments(*stacked)
    # a small budget forces one pair per chunk and 32-target tiles
    chunked = pf.icp_iteration_moments_plain(*stacked, tile_m=32,
                                             max_tile_elems=150 * 32)
    assert batched.shape == (4, pf.NUM_MOMENTS)
    for b in range(4):
        single = pf.icp_iteration_moments(*(x[b] for x in stacked))
        torch.testing.assert_close(batched[b], single, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(chunked[b], single, rtol=1e-6, atol=1e-6)
    assert batched[1].abs().max().item() == 0.0
    assert batched[2, 0].item() == 0.0           # nothing inside the gate


def test_moments_to_transform_matches_jax():
    rng = np.random.default_rng(5)
    moms = []
    for _ in range(6):
        T, src, sm, tgt, tm = _pair(rng, 120, 160)
        moms.append(np.asarray(jf.icp_iteration_moments_xla(
            *map(jnp.asarray, (T, src, sm, tgt, tm)))))
    moms.append(np.zeros(19, np.float32))         # degenerate: sw < 1
    moms = np.stack(moms)
    dT, mean = pf.moments_to_transform(torch.tensor(moms))
    for b in range(len(moms)):
        jdT, jmean = jf.moments_to_transform(jnp.asarray(moms[b]))
        np.testing.assert_allclose(dT[b].numpy(), np.asarray(jdT), atol=1e-5)
        np.testing.assert_allclose(mean[b].item(), float(jmean), rtol=1e-5)
    np.testing.assert_array_equal(dT[-1].numpy(), np.eye(4, dtype=np.float32))
    assert mean[-1].item() == 0.0


def test_batched_icp_matches_jax_per_pair():
    """Pairs converge after different iteration counts; the port's frozen
    lanes must reproduce each pair's own JAX result (XLA oracle on the CPU,
    tie-free data)."""
    rng = np.random.default_rng(11)
    B, n = 3, 160
    cfg = IcpConfig()
    tgt = (rng.normal(size=(B, n, 3)) * 8.0).astype(np.float32)
    xi = (rng.normal(size=(B, 6)) * [1.0, 1.0, 0.3, 0.05, 0.05, 0.1]).astype(np.float32)
    xi[0] *= 2.0                                    # far: many iterations
    xi[2] *= 0.001                                  # nearly aligned already
    T_true = np.asarray(j_se3_exp(jnp.asarray(xi)))
    src = np.einsum("bij,bnj->bni", T_true[:, :3, :3].transpose(0, 2, 1),
                    tgt - T_true[:, None, :3, 3]).astype(np.float32)
    src += rng.normal(0, 0.01, src.shape).astype(np.float32)
    sm = (rng.uniform(size=(B, n)) > 0.1).astype(np.float32)
    tm = np.ones((B, n), np.float32)
    res = p_icp(*_t(src, tgt, sm, tm), cfg=cfg)
    jres = jax.vmap(lambda s, t, a, b: j_icp(s, t, a, b, cfg=cfg))(
        *map(jnp.asarray, (src, tgt, sm, tm)))
    np.testing.assert_allclose(res.transform.numpy(), np.asarray(jres.transform),
                               atol=1e-4)
    np.testing.assert_array_equal(res.iterations.numpy(), np.asarray(jres.iterations))
    np.testing.assert_array_equal(res.converged.numpy(), np.asarray(jres.converged))
    # the XLA oracle forms d2 as |p|^2 - 2 p.q + |q|^2: at |p|^2 ~ 200 m^2
    # that carries ~1e-5 m^2 of f32 cancellation, the port's exact form not
    np.testing.assert_allclose(res.fitness.numpy(), np.asarray(jres.fitness),
                               rtol=1e-4, atol=2e-5)
    np.testing.assert_allclose(res.inlier_fraction.numpy(),
                               np.asarray(jres.inlier_fraction), atol=1e-6)
    assert len(set(res.iterations.tolist())) > 1     # lanes froze at different steps
    one = p_icp(*_t(src[0], tgt[0], sm[0], tm[0]), cfg=cfg)
    torch.testing.assert_close(one.transform, res.transform[0], rtol=0, atol=1e-6)


def test_cpu_path_never_builds_or_counts():
    before = pf.ICP_MOMENTS_LAUNCHES
    T, src, sm, tgt, tm = _pair(np.random.default_rng(0), 20, 30)
    pf.icp_iteration_moments(*_t(T, src, sm, tgt, tm))
    assert pf.ICP_MOMENTS_LAUNCHES == before
    assert _build._LIB is None
    with pytest.raises(ValueError):
        pf.icp_iteration_moments(*_t(T, src, sm, tgt, tm[:10]))


def test_gate_matches_tpu_kernel():
    assert pf.correspondence_gate(1e8) == float(np.float32(1e16))
    assert pf.correspondence_gate(2.0) == 4.0
    assert pf.correspondence_gate(1e20) == float(np.float32(5e29))
