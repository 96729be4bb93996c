"""Multi-vendor radar point-record adapter (a numpy-only copy of
`icp4dradar_tpu/io/formats.py`).

Re-implements the reference's `pcl2msgToPcl` field-name sniffing
(src/radar_odometry.cpp:461-572) without ROS: a record batch is a dict of
named float columns; the adapter detects which vendor schema it matches and
normalizes to the canonical (x, y, z, intensity, doppler, range) columns.

Supported schemas (ref registrations src/radar_odometry.cpp:43-77, structs
include/userdefine.h:78-122):
- "rio":       x y z snr_db noise_db v_doppler_mps        (range := |p|)
- "ti_mmwave": x y z intensity velocity                   (axis swap x=-y_raw, y=x_raw)
- "oculii":    x y z Doppler Range Power Alpha Beta
- "coloradar": x y z intensity range doppler
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np


@dataclass
class RadarFields:
    """Canonical normalized columns, all (N,) float32 except xyz (N,3)."""

    xyz: np.ndarray
    intensity: np.ndarray   # snr_db / Power / intensity
    doppler: np.ndarray     # v_doppler_mps / velocity / Doppler / doppler
    range: np.ndarray
    noise_db: np.ndarray    # -1 where the vendor doesn't provide it (ref :509)


_SCHEMAS = {
    "rio": {"x", "y", "z", "snr_db", "noise_db", "v_doppler_mps"},
    "ti_mmwave": {"x", "y", "z", "intensity", "velocity"},
    "oculii": {"x", "y", "z", "Doppler", "Range", "Power", "Alpha", "Beta"},
    "coloradar": {"x", "y", "z", "intensity", "range", "doppler"},
}


def detect_format(fields) -> Optional[str]:
    """Field-name sniffing in the reference's priority order
    (src/radar_odometry.cpp:474-564: rio, ti_mmwave, oculii, coloradar)."""
    names = set(fields)
    for schema in ("rio", "ti_mmwave", "oculii", "coloradar"):
        if _SCHEMAS[schema] <= names:
            return schema
    return None


def adapt_point_records(columns: Dict[str, np.ndarray]) -> RadarFields:
    """Normalize a vendor record batch to canonical columns.

    Raises ValueError on unsupported schemas (ref error branch :566-571).
    """
    schema = detect_format(columns.keys())
    if schema is None:
        raise ValueError(
            "unsupported point cloud with fields: " + ", ".join(sorted(columns))
        )
    f32 = lambda k: np.asarray(columns[k], dtype=np.float32).reshape(-1)
    if schema == "rio":
        xyz = np.stack([f32("x"), f32("y"), f32("z")], axis=-1)
        rng = np.linalg.norm(xyz, axis=-1)  # ref fixes range from |p| (:485)
        return RadarFields(xyz, f32("snr_db"), f32("v_doppler_mps"), rng, f32("noise_db"))
    if schema == "ti_mmwave":
        # ref axis swap: x = -y_raw, y = x_raw (:504-505)
        xyz = np.stack([-f32("y"), f32("x"), f32("z")], axis=-1)
        rng = np.linalg.norm(xyz, axis=-1)
        n = xyz.shape[0]
        return RadarFields(
            xyz, f32("intensity"), f32("velocity"), rng,
            np.full(n, -1.0, dtype=np.float32),
        )
    if schema == "oculii":
        xyz = np.stack([f32("x"), f32("y"), f32("z")], axis=-1)
        n = xyz.shape[0]
        return RadarFields(
            xyz, f32("Power"), f32("Doppler"), f32("Range"),
            np.full(n, -1.0, dtype=np.float32),
        )
    # coloradar
    xyz = np.stack([f32("x"), f32("y"), f32("z")], axis=-1)
    n = xyz.shape[0]
    return RadarFields(
        xyz, f32("intensity"), f32("doppler"), f32("range"),
        np.full(n, -1.0, dtype=np.float32),
    )
