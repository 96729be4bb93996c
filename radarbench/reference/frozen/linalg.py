"""Frozen copy of `icp4dradar_tpu_torch/geom/linalg.py` at commit
03a0450, part of the benchmark's reference: its plain PyTorch paths only
(the CUDA dispatch removed; what no reference path calls left out).

Batched closed-form small solves (PyTorch port of the adjugate helpers in
`icp4dradar_tpu/geom/linalg.py`): 3x3 inverse and solve (LSQ and REVE ego
velocity, src/iterative_closest_point.cpp:412-429), the 6x6 SPD solve of
one Gauss-Newton step (closed form for VGICP, Cholesky for kNN GICP), the
3x3 symmetric eigenvalues behind REVE's `max_r_cond` gate
(src/radar_odometry.cpp:598) and the extreme eigenvectors behind GICP's
plane-regularised covariances; the float32 fused multiply-add and square
root, each rounded once, on any device; small products and a sum whose
rounding does not depend on the batch (`small_matmul`, `small_matvec`,
`pairwise_sum`); and the broadcast of shapes (`broadcast_shape`)."""

from __future__ import annotations

import math

import torch


def broadcast_shape(*shapes) -> torch.Size:
    """The shape that `shapes` broadcast to, by `torch.broadcast_shapes`'
    rule. torch's own goes through `torch._refs`, whose first call in a
    process imports sympy (hundreds of modules, seconds where no
    bytecode is cached); this is plain Python."""
    ndim = max((len(s) for s in shapes), default=0)
    out = [1] * ndim
    for s in shapes:
        for i, d in enumerate(s, ndim - len(s)):
            if d != 1:
                if out[i] not in (1, d):
                    raise RuntimeError(f"shapes {shapes} do not broadcast")
                out[i] = d
    return torch.Size(out)


def small_matmul(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A @ B for small factors ((..., m, k) @ (..., k, n), k of a few),
    rounding alike at every batch size, so that a stream's numbers do not
    depend on the streams computed beside it. On the card the products are
    summed over k along the innermost axis (cuBLAS picks its kernel, and with
    it the rounding, by the batch count); on the CPU it is the product
    itself (its small-matrix kernel rounds each matrix alone)."""
    if A.device.type != "cuda":
        return A @ B
    return torch.sum(A[..., :, None, :] * B.transpose(-1, -2)[..., None, :, :], dim=-1)


def small_matvec(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(..., m, k) A times (..., k) x, with `small_matmul`'s property."""
    if A.device.type != "cuda":
        return torch.einsum("...ij,...j->...i", A, x)
    return torch.sum(A * x[..., None, :], dim=-1)


def pairwise_sum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Sum over `dim` by halving (zero-padded to a power of two): elementwise
    adds in an order fixed by the length of `dim` alone, so that a row's sum
    rounds alike whatever the other dimensions hold (one frame or a batch of
    them) and on every device, as a library reduction or matrix product
    need not."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    p = 1 << max(n - 1, 0).bit_length()
    if p != n:
        x = torch.nn.functional.pad(x, (0, p - n))
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


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
    return small_matvec(inv3x3(A), b)


def solve_spd6(H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve (..., 6, 6) SPD H x = (..., 6) b through the Schur complement
    of its 3x3 blocks H = [[A, B], [B^T, C]], every factor an adjugate
    inverse (the JAX package's per-iteration GN solve)."""
    A, B, C = H[..., :3, :3], H[..., :3, 3:], H[..., 3:, 3:]
    b1, b2 = b[..., :3], b[..., 3:]
    Ainv = inv3x3(A)
    BtAinv = small_matmul(B.transpose(-1, -2), Ainv)
    S = C - small_matmul(BtAinv, B)
    x2 = small_matvec(inv3x3(S), b2 - small_matvec(BtAinv, b1))
    x1 = small_matvec(Ainv, b1 - small_matvec(B, x2))
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
