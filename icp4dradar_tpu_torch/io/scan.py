"""RadarScan: the fixed-shape, masked scan container every stage consumes
(PyTorch port of `icp4dradar_tpu/io/scan.py`).

The reference carries per-point structs (`RadarPoint_Info2`,
include/userdefine.h:21-29) with derived range/azimuth/elevation computed in
the parse loop (src/iterative_closest_point.cpp:373-384). Here a scan is a
padded struct of tensors with a validity mask instead of dynamic sizes. Every
field may carry leading batch dimensions: a stacked sequence is a RadarScan
whose tensors lead with the frame axis (F, ...).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch


@dataclass(frozen=True)
class RadarScan:
    """One padded radar scan (or a stack of them).

    xyz:       (..., N, 3) point positions [m]
    doppler:   (..., N)    radial Doppler velocity v_r [m/s]
    intensity: (..., N)    SNR / power / RCS [vendor units]
    mask:      (..., N)    1.0 for valid points, 0.0 for padding
    time:      (...)       scan timestamp [s] (0 if unknown)
    """

    xyz: torch.Tensor
    doppler: torch.Tensor
    intensity: torch.Tensor
    mask: torch.Tensor
    time: torch.Tensor

    # ---------------- derived spherical quantities ----------------
    @property
    def device(self) -> torch.device:
        return self.xyz.device

    @property
    def range(self) -> torch.Tensor:
        """(..., N) range r = |p| (ref src/iterative_closest_point.cpp:378)."""
        return torch.linalg.vector_norm(self.xyz, dim=-1)

    @property
    def azimuth(self) -> torch.Tensor:
        """(..., N) azimuth alpha = atan2(y, x) in RADIANS (ref :382)."""
        return torch.atan2(self.xyz[..., 1], self.xyz[..., 0])

    @property
    def elevation(self) -> torch.Tensor:
        """(..., N) elevation beta = asin(z / r) in RADIANS (ref :383)."""
        r = torch.clamp(self.range, min=1e-9)
        return torch.arcsin(torch.clamp(self.xyz[..., 2] / r, -1.0, 1.0))

    @property
    def direction(self) -> torch.Tensor:
        """(..., N, 3) unit direction cosines — the ego-velocity design
        matrix rows (ref :418-420)."""
        r = torch.clamp(self.range, min=1e-9)
        return self.xyz / r[..., None]

    # ---------------- constructors ----------------
    @classmethod
    def from_arrays(
        cls,
        xyz: np.ndarray,
        doppler: Optional[np.ndarray] = None,
        intensity: Optional[np.ndarray] = None,
        max_points: int = 4096,
        time: float = 0.0,
        device=None,
    ) -> "RadarScan":
        """Pad/truncate variable-length host arrays into the fixed budget."""
        xyz = np.asarray(xyz, dtype=np.float32).reshape(-1, 3)
        n = min(xyz.shape[0], max_points)
        if doppler is None:
            doppler = np.zeros(xyz.shape[0], dtype=np.float32)
        if intensity is None:
            intensity = np.zeros(xyz.shape[0], dtype=np.float32)
        out_xyz = np.zeros((max_points, 3), dtype=np.float32)
        out_dop = np.zeros((max_points,), dtype=np.float32)
        out_int = np.zeros((max_points,), dtype=np.float32)
        out_msk = np.zeros((max_points,), dtype=np.float32)
        out_xyz[:n] = xyz[:n]
        out_dop[:n] = np.asarray(doppler, dtype=np.float32).reshape(-1)[:n]
        out_int[:n] = np.asarray(intensity, dtype=np.float32).reshape(-1)[:n]
        out_msk[:n] = 1.0
        return cls(
            xyz=torch.from_numpy(out_xyz).to(device),
            doppler=torch.from_numpy(out_dop).to(device),
            intensity=torch.from_numpy(out_int).to(device),
            mask=torch.from_numpy(out_msk).to(device),
            time=torch.tensor(time, dtype=torch.float32, device=device),
        )

    def replace(self, **fields) -> "RadarScan":
        return dataclasses.replace(self, **fields)

    def with_mask(self, mask: torch.Tensor) -> "RadarScan":
        """Return a scan whose validity mask is ANDed with `mask`."""
        return self.replace(mask=self.mask * mask.to(self.mask.dtype))

    def to(self, device) -> "RadarScan":
        return RadarScan(**{f.name: getattr(self, f.name).to(device)
                            for f in dataclasses.fields(self)})

    def __getitem__(self, idx) -> "RadarScan":
        """Index the leading (frame) axis of a stacked scan."""
        return RadarScan(**{f.name: getattr(self, f.name)[idx]
                            for f in dataclasses.fields(self)})


def stack_scans(scans: Sequence[RadarScan]) -> RadarScan:
    """Stack equally-padded scans into a leading frame axis."""
    return RadarScan(**{
        f.name: torch.stack([getattr(s, f.name) for s in scans], dim=0)
        for f in dataclasses.fields(RadarScan)
    })
