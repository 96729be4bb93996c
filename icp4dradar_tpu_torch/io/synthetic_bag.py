"""Synthesize a reference-style ROS1 bag from a SyntheticSequence (PyTorch
port of `icp4dradar_tpu/io/synthetic_bag.py`; for the same sequence it
writes the JAX package's bytes).

The reference's entire validation path is replaying a recorded bag of radar
PointCloud2 + IMU + lidar-GT odometry topics (launch/radar_odometry.launch:
6-9, reader src/radar_odometry.cpp:244-308). This writer fabricates a bag
with the same STRUCTURE (schema field names per vendor, IMU + GT topics,
lz4/bz2 chunk compression) from a synthetic sequence, so the complete
bag->CLI->trajectory stack can be driven and evaluated end to end.
"""

from __future__ import annotations

import numpy as np
import torch

from icp4dradar_tpu_torch.geom.so3 import matrix_to_quat
from icp4dradar_tpu_torch.io.rosbag import RosbagWriter


def write_synthetic_bag(path, seq, topic_radar="/radar", topic_gt="/gt",
                        topic_imu="/imu", fmt="coloradar", hz=10.0,
                        compression="none") -> str:
    """Write `seq` (SyntheticSequence) as a ROS1 bag.

    fmt: "coloradar" (intensity/doppler/range fields,
    src/radar_odometry.cpp:527-552), "oculii" (Doppler/Range/Power/Alpha/
    Beta, :502-525), or "rio" (snr_db/noise_db/v_doppler_mps, :461-483).
    compression: "none" | "bz2" | "lz4" chunk compression (rosbag record
    default for real recordings is lz4)."""
    w = RosbagWriter(path)
    quats = matrix_to_quat(torch.from_numpy(np.ascontiguousarray(seq.poses[:, :3, :3]))).numpy()
    for k in range(len(seq)):
        t = 1000.0 + k / hz
        rec = seq.scan(k).to_numpy_valid()  # (M,5) x y z intensity doppler
        rng = np.linalg.norm(rec[:, :3], axis=-1)
        if fmt == "coloradar":
            cols = {
                "x": rec[:, 0], "y": rec[:, 1], "z": rec[:, 2],
                "intensity": rec[:, 3], "doppler": rec[:, 4],
                "range": rng,
            }
        elif fmt == "oculii":
            cols = {
                "x": rec[:, 0], "y": rec[:, 1], "z": rec[:, 2],
                "Power": rec[:, 3], "Doppler": rec[:, 4],
                "Range": rng,
                "Alpha": np.zeros(len(rec), np.float32),
                "Beta": np.zeros(len(rec), np.float32),
            }
        elif fmt == "rio":
            cols = {
                "x": rec[:, 0], "y": rec[:, 1], "z": rec[:, 2],
                "snr_db": rec[:, 3],
                "noise_db": np.zeros(len(rec), np.float32),
                "v_doppler_mps": rec[:, 4],
            }
        else:
            raise ValueError(f"unknown bag format {fmt!r}")
        w.add_pointcloud2(topic_radar, t, cols)
        w.add_odometry(topic_gt, t + 0.01, seq.poses[k][:3, 3], quats[k])
        # body-frame yaw rate between consecutive GT poses (the real IMU's
        # gyro signal, which the reference queues, src/radar_odometry.cpp:
        # 359-362, and --imu-prior consumes)
        if k + 1 < len(seq):
            dT = np.linalg.inv(seq.poses[k]) @ seq.poses[k + 1]
            yaw_rate = float(np.arctan2(dT[1, 0], dT[0, 0])) * hz
        else:
            yaw_rate = 0.0
        w.add_imu(topic_imu, t + 0.005, [0.0, 0.0, yaw_rate],
                  [0.0, 0.0, -9.81])
    w.close(compression=compression)
    return path
