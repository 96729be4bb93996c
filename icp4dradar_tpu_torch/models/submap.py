"""Keyframe-local submap assembly (host-side output stage; a numpy copy of
`icp4dradar_tpu/models/submap.py`).

Reference behavior (src/iterative_closest_point.cpp:577-633): accumulate
world-frame scans; every `scans_per_submap`=20 frames re-express the
accumulated cloud in the previous keyframe's local frame via T^-1
(`pointAssociateToSubMap`, :54-62) and emit it; then reset. A visualization
and export concern, so it runs on host numpy over the pipeline's outputs.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


class SubmapAccumulator:
    """Feed (world_pose, scan_xyz, mask) per frame; emits keyframe-local
    submaps every `scans_per_submap` frames."""

    def __init__(self, scans_per_submap: int = 20):
        self.scans_per_submap = scans_per_submap
        self._points: List[np.ndarray] = []
        self._count = 0
        self._keyframe_T = np.eye(4, dtype=np.float32)  # SubMap_Odom_result[-2]
        self._next_keyframe_T = np.eye(4, dtype=np.float32)
        self.submaps: List[np.ndarray] = []

    def add_frame(
        self, world_T: np.ndarray, xyz: np.ndarray, mask: Optional[np.ndarray] = None
    ) -> Optional[np.ndarray]:
        """Returns the emitted keyframe-local submap when the window closes,
        else None."""
        pts = np.asarray(xyz, dtype=np.float32)
        if mask is not None:
            pts = pts[np.asarray(mask) > 0.5]
        world = pts @ np.asarray(world_T)[:3, :3].T + np.asarray(world_T)[:3, 3]
        self._points.append(world)
        self._count += 1
        self._next_keyframe_T = np.asarray(world_T, dtype=np.float32)
        if self._count < self.scans_per_submap:
            return None
        cloud = np.concatenate(self._points, axis=0)
        # re-express in the window-opening keyframe's frame via T^-1 (:609)
        Tinv = np.linalg.inv(self._keyframe_T)
        local = cloud @ Tinv[:3, :3].T + Tinv[:3, 3]
        self.submaps.append(local)
        self._points = []
        self._count = 0
        self._keyframe_T = self._next_keyframe_T
        return local
