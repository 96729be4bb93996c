"""Sequence datasets: .bin frame directories and a synthetic generator
(PyTorch port of `icp4dradar_tpu/io/dataset.py`).

`SyntheticSequence` draws exactly the numpy arrays the JAX package's does
for the same arguments (same generator, same draw order); only the container
it returns is the port's `RadarScan`. `BinSequenceDataset` is the numpy read
path; the native C++ prefetching loader is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

from icp4dradar_tpu_torch.io.bin_io import count_frames, frame_path, read_radar_bin
from icp4dradar_tpu_torch.io.scan import RadarScan


class BinSequenceDataset:
    """Directory of `data/radar_pointcloud_<k>.bin` frames -> RadarScan
    stream (reference frame loop, src/iterative_closest_point.cpp:263-321)."""

    def __init__(self, dataset_folder: str, max_points: int = 4096):
        self.folder = dataset_folder
        self.max_points = max_points
        self.num_frames = count_frames(dataset_folder)

    def __len__(self) -> int:
        return self.num_frames

    def raw_frame(self, order: int) -> np.ndarray:
        return read_radar_bin(frame_path(self.folder, order))

    def __getitem__(self, order: int) -> RadarScan:
        rec = self.raw_frame(order)
        return RadarScan.from_arrays(
            rec[:, :3], rec[:, 4], rec[:, 3], max_points=self.max_points,
            time=float(order),
        )

    def __iter__(self) -> Iterator[RadarScan]:
        for k in range(self.num_frames):
            yield self[k]


@dataclass(frozen=True)
class VendorProfile:
    """Vendor-realistic degradation model for SyntheticSequence (see the JAX
    package's `io/dataset.py` for the parameter sources)."""

    azimuth_fov_deg: float      # half-angle
    elevation_fov_deg: float    # half-angle
    max_range: float
    dropout0: float             # dropout probability at r = 0
    dropout1: float             # extra dropout at r = rmax
    ghost_fraction: float       # multipath duplicates
    sigma_range: float          # radial noise [m]
    sigma_angle_deg: float      # bearing noise [deg]


VENDOR_PROFILES = {
    "rio": VendorProfile(60.0, 10.0, 100.0, 0.05, 0.30, 0.02, 0.15, 0.5),
    "ti_mmwave": VendorProfile(60.0, 15.0, 30.0, 0.15, 0.45, 0.05, 0.10, 1.0),
    "oculii": VendorProfile(55.0, 22.0, 150.0, 0.05, 0.25, 0.08, 0.20, 0.25),
    "coloradar": VendorProfile(70.0, 20.0, 50.0, 0.10, 0.35, 0.04, 0.12, 0.7),
}


def _apply_vendor_profile(pts, doppler, intensity, prof: VendorProfile, rng):
    """Degrade an ideal sensor-frame scan per the vendor model. Returns new
    (pts, doppler, intensity) host arrays (length changes)."""
    r = np.maximum(np.linalg.norm(pts, axis=-1), 1e-6)
    az = np.degrees(np.arctan2(pts[:, 1], pts[:, 0]))
    el = np.degrees(np.arcsin(np.clip(pts[:, 2] / r, -1.0, 1.0)))
    keep = (np.abs(az) < prof.azimuth_fov_deg) \
        & (np.abs(el) < prof.elevation_fov_deg) & (r < prof.max_range)
    p_drop = prof.dropout0 + prof.dropout1 * (r / prof.max_range) ** 2
    keep &= rng.uniform(size=r.shape) > p_drop
    pts, doppler, intensity, r = pts[keep], doppler[keep], intensity[keep], r[keep]

    d = pts / r[:, None]
    pts = pts + d * rng.normal(0.0, prof.sigma_range, r.shape)[:, None]
    ang = np.radians(prof.sigma_angle_deg)
    tangential = rng.normal(0.0, ang, (r.shape[0], 3)) * r[:, None]
    pts = pts + tangential - d * np.sum(tangential * d, axis=-1)[:, None]

    n_ghost = int(r.shape[0] * prof.ghost_fraction)
    if n_ghost > 0:
        gi = rng.choice(r.shape[0], n_ghost, replace=False)
        scale = rng.uniform(1.4, 1.9, n_ghost)
        gpts = pts[gi] * scale[:, None]
        gdop = doppler[gi] * scale + rng.normal(0.0, 0.3, n_ghost)
        gint = intensity[gi] * rng.uniform(0.3, 0.7, n_ghost)
        gkeep = np.linalg.norm(gpts, axis=-1) < prof.max_range
        pts = np.concatenate([pts, gpts[gkeep]])
        doppler = np.concatenate([doppler, gdop[gkeep]])
        intensity = np.concatenate([intensity, gint[gkeep]])
    return pts, doppler, intensity


@dataclass
class SyntheticSequence:
    """Simulated 4D-radar sequence over a smooth trajectory with exact GT.

    Static landmarks (volumetric scatter plus planar structure) and a
    fraction of dynamic points with off-model Doppler. Each scan holds the
    landmarks within `max_range` of the sensor, in the sensor frame, with
    Doppler v_r = d_i . v_ego (src/iterative_closest_point.cpp:412-429) and
    Gaussian noise.
    """

    num_frames: int = 100
    max_points: int = 2048
    num_landmarks: int = 20000
    world_extent: float = 120.0
    max_range: float = 80.0
    speed: float = 2.0                 # m / frame
    turn_rate: float = 0.02            # rad / frame
    pos_noise: float = 0.02
    doppler_noise: float = 0.05
    dynamic_fraction: float = 0.1
    dynamic_doppler: float = 3.0
    seed: int = 0
    vendor_profile: Optional[str] = None
    turn_schedule: Optional[np.ndarray] = None

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        n_plane = self.num_landmarks // 2
        n_scatter = self.num_landmarks - n_plane
        scatter = rng.uniform(-self.world_extent, self.world_extent, size=(n_scatter, 3))
        scatter[:, 2] = rng.uniform(-3.0, 8.0, size=n_scatter)
        ground = np.stack(
            [
                rng.uniform(-self.world_extent, self.world_extent, n_plane // 2),
                rng.uniform(-self.world_extent, self.world_extent, n_plane // 2),
                rng.normal(0.0, 0.02, n_plane // 2) - 1.5,
            ],
            axis=-1,
        )
        walls = []
        n_wall = n_plane - n_plane // 2
        for i in range(4):
            k = n_wall // 4 if i < 3 else n_wall - 3 * (n_wall // 4)
            a = rng.uniform(-self.world_extent, self.world_extent, k)
            z = rng.uniform(-1.0, 6.0, k)
            spacing = max(40.0, self.world_extent / 3.0)
            c = rng.normal(0.0, 0.05, k) + (i - 1.5) * spacing
            if i % 2 == 0:
                walls.append(np.stack([a, c, z], axis=-1))
            else:
                walls.append(np.stack([c, a, z], axis=-1))
        self.landmarks = np.concatenate(
            [scatter, ground] + walls, axis=0
        ).astype(np.float32)
        self._rng = rng
        self.poses = self._make_poses()   # (F, 4, 4) world <- sensor

    def _make_poses(self) -> np.ndarray:
        poses = np.zeros((self.num_frames, 4, 4), dtype=np.float32)
        T = np.eye(4, dtype=np.float32)
        for k in range(self.num_frames):
            poses[k] = T
            yaw = (float(self.turn_schedule[k])
                   if self.turn_schedule is not None else self.turn_rate)
            c, s = np.cos(yaw), np.sin(yaw)
            dR = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], dtype=np.float32)
            dT = np.eye(4, dtype=np.float32)
            dT[:3, :3] = dR
            dT[:3, 3] = [self.speed, 0.0, 0.0]   # forward along body x
            T = T @ dT
        return poses

    def ego_velocity(self, k: int) -> np.ndarray:
        """Body-frame velocity at frame k (per-frame units)."""
        if k + 1 < self.num_frames:
            dT = np.linalg.inv(self.poses[k]) @ self.poses[k + 1]
        else:
            dT = np.linalg.inv(self.poses[k - 1]) @ self.poses[k]
        return dT[:3, 3].astype(np.float32)

    def scan(self, k: int, device=None) -> RadarScan:
        T = self.poses[k]
        Rinv = T[:3, :3].T
        local = (self.landmarks - T[:3, 3]) @ Rinv.T
        r = np.linalg.norm(local, axis=-1)
        sel = np.flatnonzero((r < self.max_range) & (r > 0.5))
        self._rng = np.random.default_rng(self.seed * 100003 + k)
        if sel.size > self.max_points:
            sel = self._rng.choice(sel, self.max_points, replace=False)
        pts = local[sel] + self._rng.normal(0.0, self.pos_noise, (sel.size, 3))
        rr = np.maximum(np.linalg.norm(pts, axis=-1), 1e-6)
        d = pts / rr[:, None]
        v_ego = self.ego_velocity(k)
        doppler = d @ v_ego + self._rng.normal(0.0, self.doppler_noise, sel.size)
        n_dyn = int(sel.size * self.dynamic_fraction)
        dyn_idx = self._rng.choice(sel.size, n_dyn, replace=False)
        doppler[dyn_idx] += np.abs(
            self._rng.normal(self.dynamic_doppler, 1.0, n_dyn)
        )
        intensity = self._rng.uniform(5.0, 30.0, sel.size)
        if self.vendor_profile is not None:
            vrng = np.random.default_rng(self.seed * 31337 + k + 7)
            pts, doppler, intensity = _apply_vendor_profile(
                pts, doppler, intensity,
                VENDOR_PROFILES[self.vendor_profile], vrng)
        return RadarScan.from_arrays(
            pts.astype(np.float32),
            doppler.astype(np.float32),
            intensity.astype(np.float32),
            max_points=self.max_points,
            time=float(k),
            device=device,
        )

    def __len__(self) -> int:
        return self.num_frames

    def __iter__(self) -> Iterator[RadarScan]:
        for k in range(self.num_frames):
            yield self.scan(k)
