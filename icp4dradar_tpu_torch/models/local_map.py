"""Local-map window ICP refinement (PyTorch port of
`icp4dradar_tpu/models/local_map.py`; the reference's USE_LOCAL_MAP
feature, src/iterative_closest_point.cpp:637-684): consecutive 15-scan
windows of world-frame points are ICP-aligned (current window onto the
previous one) and the corrections logged to icp_map.txt (:793-812).

A post-processing pass over a pipeline's outputs: the windows are built on
the host in numpy, exactly as the JAX package builds them, and all W-1
window pairs register in one batched ICP, so that each ICP iteration is one
launch of the ICP-moments kernel over every pair (`ops/icp_fused.py`).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from icp4dradar_tpu_torch.config import IcpConfig
from icp4dradar_tpu_torch.registration.icp import icp_point_to_point


def build_windows(
    scans_xyz: np.ndarray,
    scans_mask: np.ndarray,
    poses: np.ndarray,
    window: int = 15,
    points_per_window: int = 4096,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Accumulate world-frame clouds per window of `window` frames.

    Returns (windows (W, points_per_window, 3), masks (W, points_per_window)).
    Oversized windows are uniformly subsampled to the fixed budget (numpy's
    `default_rng(seed).choice`, the JAX package's draws)."""
    F = scans_xyz.shape[0]
    rng = np.random.default_rng(seed)
    out_pts, out_msk = [], []
    for start in range(0, F - window + 1, window):
        pts = []
        for k in range(start, start + window):
            m = scans_mask[k] > 0.5
            pts.append(scans_xyz[k][m] @ poses[k][:3, :3].T + poses[k][:3, 3])
        cloud = np.concatenate(pts, 0).astype(np.float32)
        if len(cloud) > points_per_window:
            cloud = cloud[rng.choice(len(cloud), points_per_window, replace=False)]
        buf = np.zeros((points_per_window, 3), np.float32)
        msk = np.zeros(points_per_window, np.float32)
        buf[: len(cloud)] = cloud
        msk[: len(cloud)] = 1.0
        out_pts.append(buf)
        out_msk.append(msk)
    return np.stack(out_pts), np.stack(out_msk)


def local_map_refinement(
    scans_xyz: np.ndarray,
    scans_mask: np.ndarray,
    poses: np.ndarray,
    window: int = 15,
    points_per_window: int = 4096,
    cfg: IcpConfig = IcpConfig(),
    device="cuda",
) -> np.ndarray:
    """ICP of each window onto its predecessor -> (W-1, 4, 4) numpy
    corrections (the reference's icp2 transforms): the W-1 pairs in one
    batched `icp_point_to_point` on `device`."""
    if scans_xyz.shape[0] < 2 * window:
        return np.zeros((0, 4, 4), np.float32)
    wins, masks = build_windows(scans_xyz, scans_mask, poses, window, points_per_window)
    if len(wins) < 2:
        return np.zeros((0, 4, 4), np.float32)
    src, tgt, src_m, tgt_m = (torch.from_numpy(np.ascontiguousarray(x)).to(device)
                              for x in (wins[1:], wins[:-1], masks[1:], masks[:-1]))
    res = icp_point_to_point(src, tgt, src_m, tgt_m, cfg=cfg)
    return res.transform.cpu().numpy()
