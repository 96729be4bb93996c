"""Trajectory / result file IO, format-compatible with the reference.

A numpy-only copy of the writers in `icp4dradar_tpu/utils/trajectory.py`
(same formats, same number formatting):
- velocity.txt: per-frame "Vx Vy Vz" (src/iterative_closest_point.cpp:757-765)
- icp.txt: 12-number KITTI-style rows
  "R00 R01 R02 Tx R10 R11 R12 Ty R20 R21 R22 Tz" (:768-812)
- output_result.csv: header + 20 columns per frame
  "time, T(4x4 row-major 16), score, A, b" (:188-191, :701-707)
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

_CSV_HEADER = (
    "#time(s),Rtrans00,Rtrans01,Rtrans02,Rtrans03,Rtrans10,Rtrans11,Rtrans12,"
    "Rtrans13,Rtrans20,Rtrans21,Rtrans22,Rtrans23,Rtrans00,Rtrans00,Rtrans00,"
    "Rtrans00,score,A,b"
)


def _ensure_dir(path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)


def write_velocity_txt(path: str, velocities: np.ndarray, gap: int = 1) -> None:
    """(F, 3) ego velocities -> 'Vx Vy Vz' rows (every `gap`-th frame,
    matching RESULT_GAP, src/iterative_closest_point.cpp:33,759)."""
    _ensure_dir(path)
    v = np.asarray(velocities, dtype=np.float64)
    with open(path, "w") as f:
        for i in range(0, len(v), gap):
            f.write(f"{v[i,0]:.15g} {v[i,1]:.15g} {v[i,2]:.15g}\n")


def write_rt_txt(path: str, poses: np.ndarray, gap: int = 1) -> None:
    """(F, 4, 4) transforms -> 12-number rows (icp.txt layout,
    src/iterative_closest_point.cpp:778-789)."""
    _ensure_dir(path)
    T = np.asarray(poses, dtype=np.float64)
    with open(path, "w") as f:
        for i in range(0, len(T), gap):
            R, t = T[i, :3, :3], T[i, :3, 3]
            row = [R[0, 0], R[0, 1], R[0, 2], t[0],
                   R[1, 0], R[1, 1], R[1, 2], t[1],
                   R[2, 0], R[2, 1], R[2, 2], t[2]]
            f.write(" ".join(f"{x:.15g}" for x in row) + "\n")


def write_result_csv(
    path: str,
    transforms: np.ndarray,
    scores: np.ndarray,
    A: np.ndarray,
    b: np.ndarray,
    times: Optional[np.ndarray] = None,
) -> None:
    """Per-frame CSV record (replay fixture), 20 columns incl. header row."""
    _ensure_dir(path)
    T = np.asarray(transforms, dtype=np.float64)
    n = len(T)
    if times is None:
        times = np.arange(n, dtype=np.float64)
    with open(path, "w") as f:
        f.write(_CSV_HEADER + "\n")
        for i in range(n):
            flat = T[i].reshape(-1)
            vals = [times[i], *flat, scores[i], A[i], b[i]]
            f.write(",".join(f"{x:f}" for x in vals) + "\n")


def read_result_csv(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Replay reader -> (times, transforms (F,4,4), scores, A, b)."""
    rows = []
    with open(path) as f:
        f.readline()
        for line in f:
            line = line.strip()
            if line:
                rows.append([float(x) for x in line.split(",")])
    arr = np.asarray(rows, dtype=np.float64)
    times = arr[:, 0]
    T = arr[:, 1:17].reshape(-1, 4, 4)
    return times, T, arr[:, 17], arr[:, 18], arr[:, 19]
