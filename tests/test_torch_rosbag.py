"""The port's ROS1 bag layer (`icp4dradar_tpu_torch.io.rosbag`,
`synthetic_bag`, `bag_dataset`, `native/bagio.cpp`) on the CPU against the
JAX package's, on the same synthetic sequences (8 frames, at most 256
points): the written bags byte for byte (`none`, `bz2`, and `lz4` where the
system liblz4 loads), the port's reader on JAX's bags against JAX's reader
(topics, stamps, columns, IMU samples, odometry poses), the native record
walk against the Python walk, the topic filter, the errors on a file that
is not a bag and on a corrupt bag, and `RadarBagDataset` against JAX's
(frames, GT alignment, IMU batches) for three vendor formats.

Tolerances: everything read from a bag is exact (the same bytes decode to
the same float32 values); the odometry poses go through each package's
float32 quaternion-to-matrix and agree to 1e-6.
"""

import os

import numpy as np
import pytest
import torch

from icp4dradar_tpu.io import RadarBagDataset as JaxBagDataset
from icp4dradar_tpu.io import RosbagReader as JaxReader
from icp4dradar_tpu.io import SyntheticSequence as JaxSequence
from icp4dradar_tpu.io import write_synthetic_bag as jax_write_bag
from icp4dradar_tpu_torch.io import (
    RadarBagDataset, RosbagReader, RosbagWriter, SyntheticSequence, lz4f,
    write_synthetic_bag,
)
from icp4dradar_tpu_torch.io.scan import stack_scans
from tests._torch_threads import one_torch_thread  # noqa: F401

F, N = 8, 256
TOPICS = dict(topic_radar="/radar", topic_gt="/gt", topic_imu="/imu")


def _seqs(seed=3, **kw):
    args = dict(num_frames=F, max_points=N, num_landmarks=2000, seed=seed, **kw)
    return JaxSequence(**args), SyntheticSequence(**args)


def _bags(tmp_path, fmt="coloradar", compression="none", **kw):
    """(JAX's bag, the port's bag) of one sequence."""
    if compression == "lz4" and not lz4f.available():
        pytest.skip("the system liblz4 does not load here")
    js, ps = _seqs(**kw)
    a, b = os.fspath(tmp_path / f"jax_{fmt}.bag"), os.fspath(tmp_path / f"port_{fmt}.bag")
    jax_write_bag(a, js, fmt=fmt, compression=compression, **TOPICS)
    write_synthetic_bag(b, ps, fmt=fmt, compression=compression, **TOPICS)
    return a, b


@pytest.mark.parametrize("compression", ["none", "bz2", "lz4"])
def test_bag_bytes_equal_jax(tmp_path, compression):
    a, b = _bags(tmp_path, compression=compression)
    data = open(b, "rb").read()
    assert data.startswith(b"#ROSBAG V2.0\n") and len(data) > 4096
    assert data == open(a, "rb").read()


def _messages(reader, topics=None):
    return list(reader.read_messages(topics))


def _assert_same_messages(port, jax_):
    assert [(t, bt) for t, _, bt in port] == [(t, bt) for t, _, bt in jax_]
    for (topic, p, _), (_, j, _) in zip(port, jax_):
        assert type(p).__name__ == type(j).__name__ and p.stamp == j.stamp
        if topic == "/radar":
            assert list(p.columns) == list(j.columns) and p.frame_id == j.frame_id
            for k in p.columns:
                assert p.columns[k].dtype == np.float32
                np.testing.assert_array_equal(p.columns[k], j.columns[k])
        elif topic == "/imu":
            for f in ("angular_velocity", "linear_acceleration", "orientation"):
                np.testing.assert_array_equal(getattr(p, f), getattr(j, f))
        else:
            np.testing.assert_array_equal(p.position, j.position)
            np.testing.assert_array_equal(p.orientation, j.orientation)
            assert (p.frame_id, p.child_frame_id) == (j.frame_id, j.child_frame_id)
            np.testing.assert_allclose(p.pose_matrix(), j.pose_matrix(), atol=1e-6)


@pytest.mark.parametrize("compression", ["none", "bz2", "lz4"])
def test_reader_on_jax_bag_matches_jax_reader(tmp_path, compression):
    a, _ = _bags(tmp_path, compression=compression)
    reader = RosbagReader(a)
    port = _messages(reader)
    assert not reader.native_used        # the default walk; the native one is held to it below
    jax_ = _messages(JaxReader(a))
    assert len(port) == 3 * F
    assert [t for t, _, _ in port[:3]] == ["/radar", "/gt", "/imu"]   # write order
    _assert_same_messages(port, jax_)
    assert {c.topic: c.msg_type for c in reader.connections.values()} == {
        "/radar": "sensor_msgs/PointCloud2", "/gt": "nav_msgs/Odometry",
        "/imu": "sensor_msgs/Imu"}


@pytest.mark.parametrize("compression", ["none", "bz2", "lz4"])
def test_native_walk_equals_python_walk(tmp_path, compression):
    _, b = _bags(tmp_path, compression=compression)
    native, python = RosbagReader(b, use_native=True), RosbagReader(b)
    n, p = _messages(native), _messages(python)
    assert native.native_used and not python.native_used
    _assert_same_messages(n, p)


@pytest.mark.parametrize("use_native", [False, True])
def test_topic_filter(tmp_path, use_native):
    _, b = _bags(tmp_path)
    every = [(t, bt) for t, _, bt in _messages(RosbagReader(b, use_native=use_native))]
    for topics in (["/radar"], ["/gt", "/imu"], ["/nothing"]):
        msgs = [(t, bt) for t, _, bt in _messages(RosbagReader(b, use_native=use_native),
                                                   topics)]
        assert msgs == [m for m in every if m[0] in topics]
        assert len(msgs) == F * len(set(topics) - {"/nothing"})


def test_not_a_bag_and_corrupt_bag_raise(tmp_path):
    p = tmp_path / "x.bag"
    p.write_bytes(b"hello world\n" + b"\x00" * 64)
    for use_native in (True, False):
        with pytest.raises(ValueError, match="not a ROS1 v2.0 bag"):
            _messages(RosbagReader(os.fspath(p), use_native=use_native))
    with pytest.raises(ValueError, match="not a ROS1"):
        _messages(JaxReader(os.fspath(p)))
    # a record length past the end of the file: the native indexer refuses
    # the whole bag instead of reading a prefix of it
    bad = tmp_path / "bad.bag"
    bad.write_bytes(b"#ROSBAG V2.0\n" + b"\xff\xff\xff\xf0garbagegarbage")
    with pytest.raises(ValueError, match="corrupt ROS1 bag"):
        _messages(RosbagReader(os.fspath(bad), use_native=True))
    # a truncated copy of a good bag: its chunk runs past the end
    _, b = _bags(tmp_path)
    data = open(b, "rb").read()
    cut = tmp_path / "cut.bag"
    cut.write_bytes(data[: len(data) // 2])
    with pytest.raises(ValueError, match="corrupt ROS1 bag"):
        _messages(RosbagReader(os.fspath(cut), use_native=True))


def test_unsupported_compression_takes_the_python_walk(tmp_path):
    """A chunk compression the native streamer declines is decided before
    any message is read: the Python walk runs and raises its own error."""
    w = RosbagWriter(os.fspath(tmp_path / "z.bag"))
    w.add_imu("/imu", 1000.0, [0, 0, 1], [0, 0, -9.81])
    w.close()
    data = open(w.path, "rb").read().replace(b"compression=none", b"compression=zstd")
    (tmp_path / "z.bag").write_bytes(data)
    reader = RosbagReader(w.path, use_native=True)
    with pytest.raises(ValueError, match="unsupported chunk compression: zstd"):
        _messages(reader)
    assert not reader.native_used


@pytest.mark.parametrize("fmt", ["coloradar", "oculii", "rio"])
def test_bag_dataset_matches_jax(tmp_path, fmt):
    a, _ = _bags(tmp_path, fmt=fmt, compression="bz2")
    port = RadarBagDataset(a, max_points=N, use_native=True, **TOPICS)
    jax_ = JaxBagDataset(a, max_points=N, **TOPICS)
    assert port.native_used and len(port) == len(jax_) == F
    for p, j in zip(port, jax_):
        assert p.stamp == j.stamp and p.gt_stamp == j.gt_stamp
        for f in ("xyz", "doppler", "intensity", "mask", "time"):
            np.testing.assert_array_equal(getattr(p.scan, f).numpy(),
                                          np.asarray(getattr(j.scan, f)), err_msg=f)
        np.testing.assert_allclose(p.gt_pose, j.gt_pose, atol=1e-6)
        assert [s.stamp for s in p.imu] == [s.stamp for s in j.imu]
        for s, t in zip(p.imu, j.imu):
            np.testing.assert_array_equal(s.angular_velocity, t.angular_velocity)
    # the IMU sample of frame k (stamped k + 0.005) lands in frame k + 1
    assert [len(f.imu) for f in port] == [0] + [1] * (F - 1)
    np.testing.assert_allclose(port.gt_poses(), jax_.gt_poses(), atol=1e-6)
    stacked = port.stacked_scans()
    ref = stack_scans([f.scan for f in port])
    for f in ("xyz", "doppler", "intensity", "mask", "time"):
        assert torch.equal(getattr(stacked, f), getattr(ref, f))
    assert stacked.xyz.shape == (F, N, 3) and stacked.device.type == "cpu"


def test_bag_dataset_gt_gate_and_missing_topics(tmp_path):
    """A GT message further than 0.1 s from every radar stamp is not
    aligned (the frame reuses the previous pose); without GT and IMU
    topics the frames carry neither."""
    _, ps = _seqs()
    scans = [ps.scan(k).to_numpy_valid() for k in range(3)]
    path = os.fspath(tmp_path / "port.bag")
    w = RosbagWriter(path)
    for k, rec in enumerate(scans):
        w.add_pointcloud2("/radar", 10.0 + k, {
            "x": rec[:, 0], "y": rec[:, 1], "z": rec[:, 2], "intensity": rec[:, 3],
            "doppler": rec[:, 4], "range": np.linalg.norm(rec[:, :3], axis=-1)})
    w.add_odometry("/gt", 10.05, [1.0, 2.0, 3.0], [0.0, 0.0, 0.0, 1.0])
    w.add_odometry("/gt", 11.5, [9.0, 9.0, 9.0], [0.0, 0.0, 0.0, 1.0])
    w.close()
    port = RadarBagDataset(path, "/radar", "/gt", max_points=N)
    jax_ = JaxBagDataset(path, "/radar", "/gt", max_points=N)
    assert [f.gt_stamp for f in port] == [f.gt_stamp for f in jax_] == [10.05, None, None]
    np.testing.assert_array_equal(port.gt_poses()[:, :3, 3], [[1, 2, 3]] * 3)
    np.testing.assert_array_equal(port.gt_poses(), jax_.gt_poses())
    bare = RadarBagDataset(path, "/radar", max_points=N)
    assert bare.gt_poses() is None and all(not f.imu for f in bare)
