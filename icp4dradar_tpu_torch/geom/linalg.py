"""Batched closed-form small solves (PyTorch port of the adjugate helpers in
`icp4dradar_tpu/geom/linalg.py`): 3x3 inverse and solve (LSQ and REVE ego
velocity, src/iterative_closest_point.cpp:412-429), the 6x6 SPD solve of
one Gauss-Newton step, and the 3x3 symmetric eigenvalues behind REVE's
`max_r_cond` gate (src/radar_odometry.cpp:598)."""

from __future__ import annotations

import math

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


def solve_spd6(H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve (..., 6, 6) SPD H x = (..., 6) b through the Schur complement
    of its 3x3 blocks H = [[A, B], [B^T, C]], every factor an adjugate
    inverse (the JAX package's per-iteration GN solve)."""
    A, B, C = H[..., :3, :3], H[..., :3, 3:], H[..., 3:, 3:]
    b1, b2 = b[..., :3], b[..., 3:]
    Ainv = inv3x3(A)
    BtAinv = B.transpose(-1, -2) @ Ainv
    S = C - BtAinv @ B
    x2 = torch.einsum("...ij,...j->...i", inv3x3(S),
                      b2 - torch.einsum("...ij,...j->...i", BtAinv, b1))
    x1 = torch.einsum("...ij,...j->...i", Ainv,
                      b1 - torch.einsum("...ij,...j->...i", B, x2))
    return torch.cat([x1, x2], dim=-1)


def _det3x3(A: torch.Tensor) -> torch.Tensor:
    return (A[..., 0, 0] * (A[..., 1, 1] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 1])
            - A[..., 0, 1] * (A[..., 1, 0] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 0])
            + A[..., 0, 2] * (A[..., 1, 0] * A[..., 2, 1] - A[..., 1, 1] * A[..., 2, 0]))


def sym3x3_eigvals(A: torch.Tensor) -> torch.Tensor:
    """Closed-form eigenvalues of symmetric (..., 3, 3), ascending
    (trigonometric form, Smith 1961)."""
    q = (A[..., 0, 0] + A[..., 1, 1] + A[..., 2, 2]) / 3.0
    B = A - q[..., None, None] * torch.eye(3, dtype=A.dtype, device=A.device)
    p2 = torch.sum(B * B, dim=(-2, -1)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=1e-30))
    r = torch.clamp(_det3x3(B) / (2.0 * p ** 3), -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    e1 = q + 2.0 * p * torch.cos(phi)
    e3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e2 = 3.0 * q - e1 - e3
    near_diag = p2 < 1e-28
    return torch.where(near_diag[..., None], torch.stack([q, q, q], dim=-1),
                       torch.stack([e3, e2, e1], dim=-1))


def condition_number(A: torch.Tensor) -> torch.Tensor:
    """2-norm condition estimate of symmetric (..., D, D) via eigenvalues."""
    ev = sym3x3_eigvals(A) if A.shape[-1] == 3 else torch.linalg.eigvalsh(A)
    return torch.abs(ev[..., -1]) / torch.clamp(torch.abs(ev[..., 0]), min=1e-20)
