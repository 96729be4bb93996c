"""Frozen copy of `icp4dradar_tpu_torch/geom/kabsch.py` at commit
03a0450, part of the benchmark's reference: its plain PyTorch paths only
(the CUDA dispatch removed; what no reference path calls left out).

Weighted rigid alignment by Horn's quaternion method (PyTorch port of
`icp4dradar_tpu/geom/kabsch.py`, quat method).

The closed-form inner solver of the ICP front end (replacing PCL's SVD
transform estimation, src/iterative_closest_point.cpp:508-521): the rotation
is the dominant eigenvector of the 4x4 Davenport matrix, found by shifted
power iteration. Horn never returns a reflection, and the iteration batches
over any number of leading dimensions.
"""

from __future__ import annotations


import torch

from .so3 import quat_to_matrix


def _rotation_from_cross_covariance(H: torch.Tensor, iters: int = 50) -> torch.Tensor:
    """Horn's method: optimal R from H = sum w p q^T via the dominant
    eigenvector (unit quaternion, wxyz) of the symmetric 4x4 Davenport
    matrix, by shifted power iteration with the JAX code's schedule: a full
    normalisation at k % 8 == 7 and at the last step, a max-abs rescale
    otherwise, from the same fixed start vector."""
    Sxx, Sxy, Sxz = H[..., 0, 0], H[..., 0, 1], H[..., 0, 2]
    Syx, Syy, Syz = H[..., 1, 0], H[..., 1, 1], H[..., 1, 2]
    Szx, Szy, Szz = H[..., 2, 0], H[..., 2, 1], H[..., 2, 2]
    N = torch.stack([
        torch.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], -1),
        torch.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], -1),
        torch.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy], -1),
        torch.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz], -1),
    ], dim=-2)                                           # (...,4,4)
    # shift so the max eigenvalue of N dominates in magnitude
    shift = torch.sqrt(torch.sum(N * N, dim=(-1, -2), keepdim=True)) + 1e-12
    M = N + shift * torch.eye(4, dtype=H.dtype, device=H.device)
    # fixed non-axis-aligned start vector avoids orthogonal-start stalls
    v = torch.tensor([0.577, 0.211, 0.317, 0.722], dtype=H.dtype,
                     device=H.device).expand(H.shape[:-2] + (4,))
    for k in range(iters):
        v = (M @ v[..., None])[..., 0]
        if k % 8 == 7 or k == iters - 1:
            scale = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
        else:
            scale = torch.amax(torch.abs(v), dim=-1, keepdim=True)
        v = v / torch.clamp(scale, min=1e-20)
    qw, qx, qy, qz = v.unbind(-1)
    return quat_to_matrix(torch.stack([qx, qy, qz, qw], dim=-1))


