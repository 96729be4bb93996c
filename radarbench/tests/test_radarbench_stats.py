"""The benchmark's arithmetic on synthetic timelines."""

import pytest

from radarbench import stats


def test_rate_counts_whole_replays_completed_in_the_window():
    # replays of 100 scans completing at 2, 4, 6 and 11 s; the window closes at 10 s
    assert stats.rate(100, 0.0, [2.0, 4.0, 6.0, 11.0], 10.0) == pytest.approx(300 / 6.0)
    assert stats.rate(100, 0.0, [12.0], 10.0) is None


def test_spread_uses_python_quartiles():
    v = [10.0, 11.0, 12.0, 13.0, 14.0, 15.0]
    q1, med, q3 = 10.75, 12.5, 14.25             # statistics.quantiles(v, n=4), exclusive
    assert stats.spread(v) == pytest.approx((q3 - q1) / med)


def test_union_and_idle_share_of_a_timeline():
    ops = [("a", 0.0, 1.0), ("b", 0.5, 2.0), ("c", 3.0, 3.5), ("a", 5.0, 6.0)]
    busy = stats.union_length((s, e) for _, s, e in ops)
    assert busy == pytest.approx(3.5)
    gaps = stats.idle_gaps(ops)
    assert gaps == [["before_a", pytest.approx(1.5)], ["before_c", pytest.approx(1.0)]]
    assert stats.top_ops(ops)[0] == ["a", pytest.approx(2.0)]


def test_track_rpe_against_a_hand_count():
    import torch

    from radarbench import compare, synth

    gt = synth.trajectory(synth.SequenceParams(), 5, 0.3, "cpu")[None]
    assert compare.track_rpe(gt, gt) == pytest.approx(0.0, abs=1e-6)
    est = gt.clone()
    est[0, 2:, :3, 3] += torch.tensor([0.3, 0.4, 0.0])   # a 0.5 m jump between frames 1 and 2
    # one of the four frame-to-frame motions is 0.5 m off: sqrt(0.25 / 4)
    assert compare.track_rpe(est, gt) == pytest.approx(0.25, rel=1e-5)
    est[0, 3, 0, 3] = float("nan")
    assert compare.track_rpe(est, gt) == float("inf")
