"""Rosbag-backed radar sequence dataset (PyTorch port of
`icp4dradar_tpu/io/bag_dataset.py`).

The ingestion front of the `radar_odometry` node (src/radar_odometry.cpp:
244-308): replays a bag's radar PointCloud2 / IMU / lidar-GT Odometry topics
in time order, normalizes radar clouds through the multi-vendor adapter
(pcl2msgToPcl equivalent, io/formats.py), and pairs each radar scan with the
nearest GT pose within the reference's 0.1 s alignment gate (:378-380).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Tuple

import numpy as np

from icp4dradar_tpu_torch.io.formats import adapt_point_records
from icp4dradar_tpu_torch.io.rosbag import ImuSample, OdomSample, RosbagReader
from icp4dradar_tpu_torch.io.scan import RadarScan, stack_scans

GT_TIME_GATE_S = 0.1  # ref: time_diff < 0.1 (src/radar_odometry.cpp:380)


@dataclass
class BagFrame:
    scan: RadarScan                           # on the CPU
    stamp: float
    gt_pose: Optional[np.ndarray] = None      # (4,4) or None
    gt_stamp: Optional[float] = None
    imu: List[ImuSample] = field(default_factory=list)


class RadarBagDataset:
    """Loads a whole bag eagerly into padded CPU RadarScans + aligned GT
    poses. Parameters mirror the reference's launch params (bag_path + three
    topic names, launch/radar_odometry.launch:5-10). `use_native`: read
    the bag through the native streamer (`RosbagReader`); `native_used`:
    it was."""

    def __init__(
        self,
        bag_path: str,
        topic_radar: str,
        topic_gt: Optional[str] = None,
        topic_imu: Optional[str] = None,
        max_points: int = 4096,
        use_native: bool = False,
    ):
        self.max_points = max_points
        topics = [t for t in (topic_radar, topic_gt, topic_imu) if t]
        reader = RosbagReader(bag_path, use_native=use_native)

        radar_msgs: List[Tuple[float, RadarScan]] = []
        gt_msgs: List[OdomSample] = []
        imu_msgs: List[ImuSample] = []
        for topic, msg, _bag_time in reader.read_messages(topics):
            if topic == topic_radar:
                f = adapt_point_records(msg.columns)
                scan = RadarScan.from_arrays(
                    f.xyz, f.doppler, f.intensity,
                    max_points=max_points, time=msg.stamp,
                )
                radar_msgs.append((msg.stamp, scan))
            elif topic == topic_gt:
                gt_msgs.append(msg)
            elif topic == topic_imu:
                imu_msgs.append(msg)
        self.native_used = reader.native_used

        self.frames: List[BagFrame] = []
        gt_times = np.asarray([g.stamp for g in gt_msgs]) if gt_msgs else None
        imu_idx = 0
        for stamp, scan in radar_msgs:
            frame = BagFrame(scan=scan, stamp=stamp)
            if gt_times is not None and len(gt_times):
                k = int(np.argmin(np.abs(gt_times - stamp)))
                if abs(gt_times[k] - stamp) < GT_TIME_GATE_S:
                    frame.gt_pose = gt_msgs[k].pose_matrix()
                    frame.gt_stamp = gt_msgs[k].stamp
            while imu_idx < len(imu_msgs) and imu_msgs[imu_idx].stamp <= stamp:
                frame.imu.append(imu_msgs[imu_idx])
                imu_idx += 1
            self.frames.append(frame)

    def __len__(self) -> int:
        return len(self.frames)

    def __getitem__(self, k: int) -> BagFrame:
        return self.frames[k]

    def __iter__(self) -> Iterator[BagFrame]:
        return iter(self.frames)

    def stacked_scans(self, device=None) -> RadarScan:
        """(F, ...) scans, stacked on the CPU and moved to `device` in one
        copy a field."""
        return stack_scans([f.scan for f in self.frames]).to(device)

    def gt_poses(self) -> Optional[np.ndarray]:
        """(F,4,4) GT poses where aligned; frames lacking GT reuse the
        previous pose (first frame falls back to identity)."""
        if not any(f.gt_pose is not None for f in self.frames):
            return None
        out = []
        last = np.eye(4, dtype=np.float32)
        for f in self.frames:
            if f.gt_pose is not None:
                last = f.gt_pose
            out.append(last)
        return np.stack(out)
