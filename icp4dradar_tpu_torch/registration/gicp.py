"""GICP result record (PyTorch port of `GicpResult` in
`icp4dradar_tpu/registration/gicp.py`). The kNN-GICP aligner itself
(`gicp.use_vgicp=False`) is not ported yet (`ROADMAP.md` queue 1 item 11)."""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class GicpResult:
    transform: torch.Tensor   # (..., 4, 4) T: src -> tgt
    converged: torch.Tensor   # (...) bool
    fitness: torch.Tensor     # (...) mean squared correspondence distance
    iterations: torch.Tensor  # (...) int32
