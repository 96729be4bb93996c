"""Batched closed-form 3x3 solves (PyTorch port of the adjugate helpers in
`icp4dradar_tpu/geom/linalg.py`), used by the LSQ ego velocity
(src/iterative_closest_point.cpp:412-429)."""

from __future__ import annotations

import torch


def inv3x3(A: torch.Tensor) -> torch.Tensor:
    """Closed-form adjugate inverse of (..., 3, 3); singular -> zeros."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    C00 = e * i - f * h
    C01 = -(d * i - f * g)
    C02 = d * h - e * g
    C10 = -(b * i - c * h)
    C11 = a * i - c * g
    C12 = -(a * h - b * g)
    C20 = b * f - c * e
    C21 = -(a * f - c * d)
    C22 = a * e - b * d
    det = a * C00 + b * C01 + c * C02
    nonsingular = torch.abs(det) > 1e-30
    inv_det = torch.where(nonsingular, 1.0 / torch.where(nonsingular, det, 1.0), 0.0)
    adjT = torch.stack([
        torch.stack([C00, C10, C20], dim=-1),
        torch.stack([C01, C11, C21], dim=-1),
        torch.stack([C02, C12, C22], dim=-1),
    ], dim=-2)
    return adjT * inv_det[..., None, None]


def solve3x3(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Closed-form solve of (..., 3, 3) @ x = (..., 3) via the adjugate."""
    return torch.einsum("...ij,...j->...i", inv3x3(A), b)
