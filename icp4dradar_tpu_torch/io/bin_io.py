""".bin radar frame IO — 5 float32s per point: (x, y, z, intensity, v_doppler).

Mirrors the reference's on-disk format and reader semantics
(`read_radar_data`, src/iterative_closest_point.cpp:64-82: whole-file float32
stream; missing file -> empty buffer) and its frame naming scheme
`data/radar_pointcloud_<k>.bin` (:303-317). A numpy-only copy of
`icp4dradar_tpu/io/bin_io.py`, so the port reads datasets without jax.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

FLOATS_PER_POINT = 5


def frame_path(dataset_folder: str, order: int) -> str:
    """Frame k path, matching src/iterative_closest_point.cpp:303-304."""
    return os.path.join(dataset_folder, "data", f"radar_pointcloud_{order}.bin")


def read_radar_bin(path: str) -> np.ndarray:
    """Read one frame -> (N, 5) float32 [x y z intensity v_doppler].

    Missing file returns an empty (0, 5) array (reference behavior
    src/iterative_closest_point.cpp:77-81). Trailing partial records are
    dropped.
    """
    if not os.path.exists(path):
        return np.zeros((0, FLOATS_PER_POINT), dtype=np.float32)
    raw = np.fromfile(path, dtype=np.float32)
    n = raw.size // FLOATS_PER_POINT
    return raw[: n * FLOATS_PER_POINT].reshape(n, FLOATS_PER_POINT)


def write_radar_bin(path: str, points: np.ndarray) -> None:
    """Write (N, 5) float32 records; creates parent dirs (no `sudo mkdir`
    side effects — deliberately dropped, SURVEY.md §7)."""
    points = np.asarray(points, dtype=np.float32)
    if points.ndim != 2 or points.shape[1] != FLOATS_PER_POINT:
        raise ValueError(f"expected (N, {FLOATS_PER_POINT}) array, got {points.shape}")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    points.tofile(path)


def read_radar_feature_points(path: str) -> np.ndarray:
    """Read a whitespace text file of 3-column feature points -> (N, 3).

    Parity with the reference's `read_radar_featurePoint`
    (src/radar_odometry.cpp:177-203: line-counted space-separated floats);
    missing file returns an empty array like its empty-buffer branch.
    """
    if not os.path.exists(path):
        return np.zeros((0, 3), dtype=np.float32)
    out = np.loadtxt(path, dtype=np.float32, ndmin=2)
    return out[:, :3] if out.size else np.zeros((0, 3), dtype=np.float32)


def count_frames(dataset_folder: str) -> int:
    """Number of consecutive frames starting at 0 (the reference stops at the
    first missing next-frame, src/iterative_closest_point.cpp:711-720)."""
    order = 0
    while os.path.exists(frame_path(dataset_folder, order)):
        order += 1
    return order
