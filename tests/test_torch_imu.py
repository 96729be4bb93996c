"""The port's IMU rotation prior (`icp4dradar_tpu_torch.preprocess.imu`)
against the JAX package's: `integrate_gyro` on random gyro windows and
`imu_prior_deltas` on the frames of a synthetic bag, within 1e-6 (each
package's float32 so3_exp, chained on the host); the identity for an empty
window; and the reference fault both copy, shown in both: with one gyro
sample a frame, each prior carries half the frame's yaw."""

import os

import numpy as np
import pytest

from icp4dradar_tpu.io import RadarBagDataset as JaxBagDataset
from icp4dradar_tpu.io import SyntheticSequence as JaxSequence
from icp4dradar_tpu.io import write_synthetic_bag as jax_write_bag
from icp4dradar_tpu.io.rosbag import ImuSample as JaxImuSample
from icp4dradar_tpu.preprocess import imu_prior_deltas as jax_prior_deltas
from icp4dradar_tpu.preprocess import integrate_gyro as jax_integrate
from icp4dradar_tpu_torch.io import ImuSample, RadarBagDataset
from icp4dradar_tpu_torch.preprocess import imu_prior_deltas, integrate_gyro
from tests._torch_threads import one_torch_thread  # noqa: F401


def _samples(rng, n, t0, t1):
    stamps = np.sort(rng.uniform(t0 - 0.05, t1 + 0.05, n))
    gyro = rng.normal(0, 1.5, (n, 3)).astype(np.float32)
    z = np.zeros(3, np.float32)
    q = np.asarray([0, 0, 0, 1], np.float32)
    return ([ImuSample(float(s), g, z, q) for s, g in zip(stamps, gyro)],
            [JaxImuSample(float(s), g, z, q) for s, g in zip(stamps, gyro)])


@pytest.mark.parametrize("n", [1, 2, 10, 40])
def test_integrate_gyro_matches_jax(n):
    rng = np.random.default_rng(n)
    port, jax_ = _samples(rng, n, 5.0, 5.1)
    R = integrate_gyro(port, 5.0, 5.1)
    assert R.dtype == np.float32 and R.shape == (3, 3)
    np.testing.assert_allclose(R, jax_integrate(jax_, 5.0, 5.1), atol=1e-6, rtol=0)
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-5)


def test_empty_window_is_identity():
    rng = np.random.default_rng(0)
    port, jax_ = _samples(rng, 5, 7.0, 7.1)       # every stamp outside [1, 2]
    for R in (integrate_gyro(port, 1.0, 2.0), integrate_gyro([], 1.0, 2.0),
              jax_integrate(jax_, 1.0, 2.0)):
        np.testing.assert_array_equal(R, np.eye(3, dtype=np.float32))


@pytest.fixture(scope="module")
def bag_frames(tmp_path_factory):
    """A 10-frame synthetic bag (turn rate 0.05 rad a frame), read by each
    package's dataset."""
    path = os.fspath(tmp_path_factory.mktemp("imu") / "turn.bag")
    seq = JaxSequence(num_frames=10, max_points=64, num_landmarks=1000, turn_rate=0.05,
                      seed=1)
    jax_write_bag(path, seq)
    kw = dict(topic_radar="/radar", topic_gt="/gt", topic_imu="/imu", max_points=64)
    return RadarBagDataset(path, **kw).frames, JaxBagDataset(path, **kw).frames


def test_imu_prior_deltas_match_jax(bag_frames):
    port, jax_ = bag_frames
    P = imu_prior_deltas(port)
    assert P.dtype == np.float32 and P.shape == (10, 4, 4)
    np.testing.assert_allclose(P, jax_prior_deltas(jax_), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(P[0], np.eye(4))
    np.testing.assert_array_equal(P[:, :3, 3], 0.0)       # rotation only


def test_half_yaw_fault_in_both_packages(bag_frames):
    """The reference fault (ROADMAP queue 3): with one gyro sample inside
    each window, the midpoint weights sum to half the window, so every
    prior carries exactly half the frame's 0.05 rad yaw, in both
    packages."""
    for P in (imu_prior_deltas(bag_frames[0]), jax_prior_deltas(bag_frames[1])):
        yaw = np.arctan2(P[1:, 1, 0], P[1:, 0, 0])
        np.testing.assert_allclose(yaw, 0.025, atol=1e-6)
