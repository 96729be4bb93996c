"""Carry state from the JAX package across as numpy.

The port never imports jax, so anything coming from `icp4dradar_tpu` (a
config, a scan, a stacked sequence) crosses as plain dicts of numpy arrays:

    cfg = config_from_dict(jax_cfg.to_dict())
    scans = scans_from_numpy({k: np.asarray(getattr(jax_scans, k))
                              for k in SCAN_FIELDS}, device="cuda")
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from icp4dradar_tpu_torch.config import PipelineConfig
from icp4dradar_tpu_torch.io.scan import RadarScan

SCAN_FIELDS = ("xyz", "doppler", "intensity", "mask", "time")


def config_from_dict(d: Mapping) -> PipelineConfig:
    """The port's PipelineConfig from `PipelineConfig.to_dict()` of either
    package."""
    return PipelineConfig.from_dict(dict(d))


def scan_from_numpy(arrays: Mapping[str, np.ndarray], device=None) -> RadarScan:
    """RadarScan from {xyz, doppler, intensity, mask, time} numpy arrays
    (float32), placed on `device`. Leading batch axes are kept, so a stacked
    (F, ...) sequence converts the same way."""
    missing = [k for k in SCAN_FIELDS if k not in arrays]
    if missing:
        raise KeyError(f"scan arrays lack fields {missing}")
    return RadarScan(**{
        k: torch.tensor(np.asarray(arrays[k], dtype=np.float32), device=device)
        for k in SCAN_FIELDS
    })


def scans_from_numpy(arrays: Mapping[str, np.ndarray], device=None) -> RadarScan:
    """Stacked (F, ...) RadarScan from stacked numpy arrays."""
    if np.ndim(arrays["xyz"]) != 3:
        raise ValueError(f"stacked xyz must be (F, N, 3), got "
                         f"{np.shape(arrays['xyz'])}")
    return scan_from_numpy(arrays, device)

