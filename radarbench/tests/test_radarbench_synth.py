"""The generator: the same seed gives the same inputs, a stream's scans do
not depend on how many streams are drawn, seeds past 32 bits work, and the
sensors fill their rows as the configurations say."""

import torch

from radarbench import synth


def test_same_seed_same_inputs_and_stream_independence():
    p = synth.SequenceParams(max_points=128, num_landmarks=800)
    a = synth.make_streams(p, 3, 5, 2**33 + 5, "cpu")
    b = synth.make_streams(p, 3, 5, 2**33 + 5, "cpu")
    one = synth.make_streams(p, 1, 5, 2**33 + 5, "cpu")
    c = synth.make_streams(p, 3, 5, 2**33 + 6, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.__dict__.values(), b.__dict__.values()))
    assert all(torch.equal(x[:1], y) for x, y in zip(a.__dict__.values(), one.__dict__.values()))
    assert not torch.equal(a.xyz, c.xyz)


def test_live_rows_first_and_sensor_fill():
    dense = synth.make_streams(synth.SequenceParams(max_points=512, num_landmarks=6000), 1, 4,
                               1, "cpu")
    assert bool((dense.mask == 1).all())           # a dense scene fills every row
    p = synth.SequenceParams(max_points=512, num_landmarks=6000, max_range=150.0,
                             vendor_profile="oculii")
    oc = synth.make_streams(p, 1, 4, 1, "cpu")
    live = oc.mask.sum(-1)
    assert bool((live > 0.2 * 512).all() and (live < 0.5 * 512).all())
    m = oc.mask[0, 0]
    n = int(m.sum())
    assert bool((m[:n] == 1).all() and (m[n:] == 0).all())     # live rows first
    assert bool((oc.xyz[0, 0, n:] == 0).all())
    r = oc.xyz[0, 0, :n].norm(dim=-1)
    assert float(r.max()) < 150.0


def test_ground_truth_motion():
    p = synth.SequenceParams()
    T = synth.trajectory(p, 10, 0.3, "cpu").double()
    d = torch.linalg.inv(T[3]) @ T[4]
    assert torch.allclose(d[:3, 3], torch.tensor([1.0, 0.0, 0.0], dtype=torch.float64), atol=1e-5)
    assert abs(float(torch.atan2(d[1, 0], d[0, 0])) - 0.02) < 1e-5
