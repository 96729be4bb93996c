"""IMU rotation prior (PyTorch port of `icp4dradar_tpu/preprocess/imu.py`):
the explicit extension point the reference stubs out.

The reference queues IMU messages and discards them unprocessed
(src/radar_odometry.cpp:359-362). Here gyro samples between consecutive
scan timestamps integrate into an SO(3) delta that seeds registration
(`prior_deltas` on run_scan_to_map / run_scan_to_map_blocked).

The JAX package's weights are copied as they are: sample i of the window
weighs 0.5 * (times[i+2] - times[i]) over [t0, s_1, ..., s_n, t1], which
sums to 0.5 * (t1 + s_n - s_1 - t0), short of t1 - t0; with one sample a
window the prior carries half the window's rotation.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from icp4dradar_tpu_torch.geom.so3 import so3_exp
from icp4dradar_tpu_torch.io.rosbag import ImuSample


def integrate_gyro(
    samples: Sequence[ImuSample],
    t0: float,
    t1: float,
) -> np.ndarray:
    """Integrate body angular velocity over [t0, t1] -> (3,3) float32 delta
    rotation. Midpoint weights over the samples inside the window (see the
    module docstring); identity when no samples fall inside."""
    inside = [s for s in samples if t0 <= s.stamp <= t1]
    if not inside:
        return np.eye(3, dtype=np.float32)
    R = np.eye(3, dtype=np.float32)
    times = [t0] + [s.stamp for s in inside] + [t1]
    for i, s in enumerate(inside):
        dt = 0.5 * (times[i + 2] - times[i])  # midpoint weighting
        w = torch.from_numpy(np.asarray(s.angular_velocity * dt, dtype=np.float32))
        R = R @ so3_exp(w).numpy()
    return R


def imu_prior_deltas(
    frames,  # Sequence[BagFrame]
) -> np.ndarray:
    """(F, 4, 4) per-frame prior delta poses from each frame's IMU batch
    (rotation-only; translation is left to the Doppler prior)."""
    F = len(frames)
    out = np.tile(np.eye(4, dtype=np.float32), (F, 1, 1))
    for k in range(1, F):
        t0 = frames[k - 1].stamp
        t1 = frames[k].stamp
        out[k, :3, :3] = integrate_gyro(frames[k].imu, t0, t1)
    return out
