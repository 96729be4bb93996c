"""Pose-graph residual functions (PyTorch port of
`icp4dradar_tpu/graph/factors.py`).

Each mirrors one of the reference's dormant Ceres autodiff functors
(include/radarFactor.hpp) as a pure function of an SE(3) pose and a
factor's payload, batched over leading dimensions (one factor, or all
factors of a type at once); the solver takes their Jacobians with
`torch.func.jacfwd`, as the JAX package takes its per-factor functions'
with `jax.jacfwd`:

- point_to_line_residual       <- RadarEdgeFactor       (:11-54,  dim 3)
- point_to_plane_residual      <- LidarPlaneFactor      (:56-103, dim 1)
- point_to_plane_norm_residual <- LidarPlaneNormFactor  (:105-137, dim 1)
- point_to_point_residual      <- LidarDistanceFactor   (:140-171, dim 3)
- relative_pose_residual       — SE(3) between-factor (no reference
  counterpart; the back end needs it for odometry chains and loop closures)

Pose convention: T = (..., 4, 4) maps body -> world. The `s` motion-interpolation
slerp of the first two reference factors (:27-29) is the `interp` argument.
Products are sums of elementwise products or `geom.linalg.small_matmul`,
which round alike at every factor count.
"""

from __future__ import annotations

import torch

from icp4dradar_tpu_torch.geom.linalg import small_matmul
from icp4dradar_tpu_torch.geom.se3 import se3_from_rt, se3_inverse, se3_log
from icp4dradar_tpu_torch.geom.so3 import (
    matrix_to_quat,
    quat_identity,
    quat_slerp,
    quat_to_matrix,
)


def _apply(T: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """R p + t for T (..., 4, 4) and points p (..., 3)."""
    return torch.sum(T[..., :3, :3] * p[..., None, :], dim=-1) + T[..., :3, 3]


def _interp_pose(T: torch.Tensor, s) -> torch.Tensor:
    """Slerp-interpolated fraction `s` (a scalar, or one per pose) of
    transform T (ref :26-29: slerp of the quaternion, linear scaling of the
    translation)."""
    s = torch.as_tensor(s, dtype=T.dtype, device=T.device)
    if s.dim():
        s = s[..., None]
    q = matrix_to_quat(T[..., :3, :3])
    q_s = quat_slerp(quat_identity(T.dtype, T.device), q, s)
    return se3_from_rt(quat_to_matrix(q_s), s * T[..., :3, 3])


def point_to_line_residual(
    T: torch.Tensor,
    curr_point: torch.Tensor,
    line_a: torch.Tensor,
    line_b: torch.Tensor,
    interp=1.0,
) -> torch.Tensor:
    """(..., 3) point-to-line: |(lp-a) x (lp-b)| / |a-b| per component
    (RadarEdgeFactor::operator(), :34-39)."""
    lp = _apply(_interp_pose(T, interp), curr_point)
    nu = torch.linalg.cross(lp - line_a, lp - line_b)
    de = torch.linalg.vector_norm(line_a - line_b, dim=-1, keepdim=True)
    return nu / torch.clamp(de, min=1e-9)


def point_to_plane_residual(
    T: torch.Tensor,
    curr_point: torch.Tensor,
    plane_j: torch.Tensor,
    plane_l: torch.Tensor,
    plane_m: torch.Tensor,
    interp=1.0,
) -> torch.Tensor:
    """(..., 1) signed distance to the plane through j, l, m
    (LidarPlaneFactor::operator(), :63-87)."""
    n = torch.linalg.cross(plane_j - plane_l, plane_j - plane_m)
    n = n / torch.clamp(torch.linalg.vector_norm(n, dim=-1, keepdim=True), min=1e-9)
    lp = _apply(_interp_pose(T, interp), curr_point)
    return torch.sum((lp - plane_j) * n, dim=-1, keepdim=True)


def point_to_plane_norm_residual(
    T: torch.Tensor,
    curr_point: torch.Tensor,
    plane_unit_norm: torch.Tensor,
    negative_oa_dot_norm: torch.Tensor,
) -> torch.Tensor:
    """(..., 1) n . (T p) + d (LidarPlaneNormFactor::operator(), :113-123)."""
    pw = _apply(T, curr_point)
    return (torch.sum(plane_unit_norm * pw, dim=-1) + negative_oa_dot_norm)[..., None]


def point_to_point_residual(
    T: torch.Tensor,
    curr_point: torch.Tensor,
    closed_point: torch.Tensor,
) -> torch.Tensor:
    """(..., 3) T p - q (LidarDistanceFactor::operator(), :147-159)."""
    return _apply(T, curr_point) - closed_point


def relative_pose_residual(
    T_i: torch.Tensor,
    T_j: torch.Tensor,
    T_meas: torch.Tensor,
) -> torch.Tensor:
    """(..., 6) between-factor: log(T_meas^-1 (T_i^-1 T_j)); T_meas is the
    measured i->j transform (an ICP result)."""
    err = small_matmul(se3_inverse(T_meas), small_matmul(se3_inverse(T_i), T_j))
    return se3_log(err)
