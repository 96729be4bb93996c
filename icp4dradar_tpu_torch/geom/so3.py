"""SO(3): quaternions, rotation matrices, exp/log maps (PyTorch port of
`icp4dradar_tpu/geom/so3.py`).

Quaternions use xyzw layout, matching the reference's Eigen/Ceres parameter
blocks `para_q[4] = {0,0,0,1}` (src/radar_odometry.cpp:80).

All functions batch over leading dimensions. `torch.where` evaluates both
branches, so each Taylor fallback near a singular angle feeds the unused
branch a safe operand (the JAX code's guards, kept one for one): a NaN there
would otherwise poison gradients and finite-value checks.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True),
                           min=_EPS)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """(...,4) xyzw -> (...,3,3)."""
    q = quat_normalize(q)
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def so3_hat(w: torch.Tensor) -> torch.Tensor:
    """(...,3) -> (...,3,3) skew-symmetric."""
    wx, wy, wz = w.unbind(-1)
    zero = torch.zeros_like(wx)
    m = torch.stack([zero, -wz, wy, wz, zero, -wx, -wy, wx, zero], dim=-1)
    return m.reshape(w.shape[:-1] + (3, 3))


def _eye3_like(K: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=K.dtype, device=K.device).expand(K.shape)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (...,3) axis-angle -> (...,3,3). Taylor branch below
    theta^2 = 1e-8, with the sqrt guarded as in the JAX code."""
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)
    small = theta2 < 1e-8
    theta = torch.sqrt(torch.where(small, 1.0, theta2))
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / torch.where(small, 1.0, theta2))
    K = so3_hat(w)
    return _eye3_like(K) + a[..., None] * K + b[..., None] * (K @ K)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """(...,3,3) -> (...,3) axis-angle on the principal branch |w| <= pi.

    theta = atan2(|skew|/2, (tr-1)/2); near pi the axis comes from the
    diagonal with signs resolved off the dominant component (as in the JAX
    code, `so3.py:154-208`)."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    skew = torch.stack(
        [R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
         R[..., 1, 0] - R[..., 0, 1]],
        dim=-1,
    )  # = 2 sin(theta) * axis
    s2 = torch.sum(skew * skew, dim=-1)
    tiny = s2 < 1e-16
    sin_theta = torch.where(tiny, 0.0, 0.5 * torch.sqrt(torch.where(tiny, 1.0, s2)))
    theta = torch.atan2(sin_theta, cos_theta)

    small = sin_theta < 1e-6
    near_pi = cos_theta < -0.999
    scale = torch.where(
        small,
        0.5 + theta * theta / 12.0,
        theta / torch.where(small, 1.0, 2.0 * sin_theta),
    )
    w_generic = scale[..., None] * skew
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis2 = torch.clamp(
        (diag - cos_theta[..., None]) / (1.0 - cos_theta[..., None] + _EPS), min=0.0
    )
    axis = torch.sqrt(axis2)
    sxy = R[..., 0, 1] + R[..., 1, 0]
    sxz = R[..., 0, 2] + R[..., 2, 0]
    syz = R[..., 1, 2] + R[..., 2, 1]
    dominant = torch.argmax(axis2, dim=-1)
    ax, ay, az = axis.unbind(-1)
    one = torch.ones_like(ax)
    sgn_xy = torch.sign(sxy + _EPS)
    sgn_xz = torch.sign(sxz + _EPS)
    sgn_yz = torch.sign(syz + _EPS)
    sx = torch.where(dominant == 0, one,
                     torch.where(dominant == 1, sgn_xy, sgn_xz))
    sy = torch.where(dominant == 1, one,
                     torch.where(dominant == 0, sgn_xy, sgn_yz))
    sz = torch.where(dominant == 2, one,
                     torch.where(dominant == 0, sgn_xz, sgn_yz))
    axis_signed = torch.stack([ax * sx, ay * sy, az * sz], dim=-1)
    flip = torch.sum(axis_signed * skew, dim=-1, keepdim=True) < 0.0
    axis_signed = torch.where(flip, -axis_signed, axis_signed)
    w_pi = theta[..., None] * axis_signed
    return torch.where(near_pi[..., None], w_pi, w_generic)
