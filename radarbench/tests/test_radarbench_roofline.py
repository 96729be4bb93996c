"""The frozen roofline counts against hand counts and against the port's
bound models they were copied from."""

import pytest

from radarbench import roofline as rf


def test_k1_launch_counts_by_hand():
    # 3 pairs of 4 x 4 points, all live; iterations 2, 1, 0
    its, live = [2, 1, 0], [4, 4, 4]
    ops = 9 * 16 * (2 + 1 + 3)            # launches 0 (2 pairs), 1 (1 pair), fitness (3 pairs)
    nbytes = [4.0 * (16 * p + 4 * p * 4 + 4 * p * 4 + 19 * p) for p in (2, 1, 3)]
    want = sum(max(9 * 16 * p / 67e12, b / 3.35e12) for p, b in zip((2, 1, 3), nbytes))
    got = rf.icp_launches_bound_s(its, live, live, 4, 4)
    assert got == pytest.approx(want)
    assert ops == 9 * 16 * 6


def test_k4_launch_counts_by_hand():
    # 2 streams, 3 frames: frame 0 alone (per-frame), frames 1-2 a block
    its = [[1, 3, 2], [1, 1, 4]]
    live = [[0, 100, 100], [0, 50, 50]]
    groups = [slice(0, 1), slice(1, 3)]
    n = 8
    b0 = rf.vgicp_sweep_bound_s(1, n, [0, 0])
    b1 = rf.vgicp_sweep_bound_s(2, n, [100, 50])
    assert rf.vgicp_launches_bound_s(its, live, n, groups) == pytest.approx(1 * b0 + 4 * b1)
    ops = 9 * 2 * n * 150 + 300 * 4 * n
    nbytes = 4.0 * (16 * 4 + 10 * 4 * n + 10 * 150 + 2 + 30 * 4)
    assert b1 == pytest.approx(max(ops / 67e12, nbytes / 3.35e12))


def test_same_counts_as_the_port_models():
    from icp4dradar_tpu_torch.utils import roofline as port

    for args in [(1024, 4096, 4096, 1024 * 4096 * 4096), (7, 2048, 2048, 5e6)]:
        assert rf.icp_moments_bound_s(*args) * 1e3 == pytest.approx(port.icp_moments_bound(*args)
                                                                      .bound()[0])
    for args in [(8, 4096, [3000] * 16), (1, 4096, [0, 12, 5000])]:
        assert rf.vgicp_sweep_bound_s(*args) * 1e3 == pytest.approx(port.vgicp_sweep_bound(*args)
                                                                      .bound()[0])
