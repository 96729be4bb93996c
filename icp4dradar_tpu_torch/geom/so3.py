"""SO(3): quaternions, rotation matrices, exp/log maps, projection onto
SO(3) and roll/pitch/yaw (PyTorch port of `icp4dradar_tpu/geom/so3.py`).

Quaternions use xyzw layout, matching the reference's Eigen/Ceres parameter
blocks `para_q[4] = {0,0,0,1}` (src/radar_odometry.cpp:80).

All functions batch over leading dimensions. `torch.where` evaluates both
branches, so each Taylor fallback near a singular angle feeds the unused
branch a safe operand (the JAX code's guards, kept one for one): a NaN there
would otherwise poison gradients and finite-value checks.
"""

from __future__ import annotations

import math

import torch

from icp4dradar_tpu_torch.geom.linalg import fma_f32, small_matmul, sqrt_f32

_EPS = 1e-8


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True),
                           min=_EPS)


def quat_identity(dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=dtype, device=device)


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return q * torch.tensor([-1.0, -1.0, -1.0, 1.0], dtype=q.dtype, device=q.device)


def quat_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a*b, xyzw layout."""
    ax, ay, az, aw = a.unbind(-1)
    bx, by, bz, bw = b.unbind(-1)
    return torch.stack(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz,
        ],
        dim=-1,
    )


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v (...,3) by quaternions q (...,4)."""
    qv, qw = q[..., :3], q[..., 3:4]
    qv, v = torch.broadcast_tensors(qv, v)
    t = 2.0 * torch.linalg.cross(qv, v)
    return v + qw * t + torch.linalg.cross(qv, t)


def quat_slerp(a: torch.Tensor, b: torch.Tensor, s) -> torch.Tensor:
    """Spherical interpolation a->b at fraction s (Eigen's slerp, used by the
    motion-interpolated factors, include/radarFactor.hpp:28). As in the JAX
    code, the angle's argument is clipped below 1 - 1e-8 and the Taylor
    weights (1 - s, s) take over where sin(theta) < 1e-5, so that the
    untaken branch's NaN never reaches a value or a tangent."""
    s = torch.as_tensor(s, dtype=a.dtype, device=a.device)
    dot = torch.sum(a * b, dim=-1, keepdim=True)
    b = torch.where(dot < 0, -b, b)
    dot = torch.clamp(torch.abs(dot), -1.0, 1.0)
    theta = torch.arccos(torch.clamp(dot, 0.0, 1.0 - _EPS))
    sin_theta = torch.sin(theta)
    small = sin_theta < 1e-5
    den = torch.where(small, torch.ones_like(sin_theta), sin_theta)
    w_a = torch.where(small, 1.0 - s, torch.sin((1.0 - s) * theta) / den)
    w_b = torch.where(small, s, torch.sin(s * theta) / den)
    return quat_normalize(w_a * a + w_b * b)


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


def matrix_to_quat(m: torch.Tensor) -> torch.Tensor:
    """(...,3,3) -> (...,4) xyzw, by the JAX package's branch-free
    Shepperd-style selection: the four candidate solutions, one per
    dominant component, and the one whose score (trace, m00, m11, m22) is
    largest, the first on ties. In float32 it gives the JAX package's CPU
    bits (`write_tum`'s text depends on them): square roots correctly
    rounded, and the norm's squares summed in order with fused
    multiply-adds, as XLA reduces them."""
    f32 = m.dtype == torch.float32
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22,
                      1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], dim=-1)
    qw = torch.clamp(qw, min=_EPS)
    qw = (sqrt_f32(qw) if f32 else torch.sqrt(qw)) * 0.5
    w_, x_, y_, z_ = qw.unbind(-1)
    cand = torch.stack(
        [
            torch.stack([(m21 - m12) / (4 * w_), (m02 - m20) / (4 * w_),
                         (m10 - m01) / (4 * w_), w_], dim=-1),
            torch.stack([x_, (m01 + m10) / (4 * x_), (m02 + m20) / (4 * x_),
                         (m21 - m12) / (4 * x_)], dim=-1),
            torch.stack([(m01 + m10) / (4 * y_), y_, (m12 + m21) / (4 * y_),
                         (m02 - m20) / (4 * y_)], dim=-1),
            torch.stack([(m02 + m20) / (4 * z_), (m12 + m21) / (4 * z_), z_,
                         (m10 - m01) / (4 * z_)], dim=-1),
        ],
        dim=-2,
    )  # (...,4,4) candidates x xyzw
    idx = torch.argmax(torch.stack([tr, m00, m11, m22], dim=-1), dim=-1)
    q = torch.gather(cand, -2, idx[..., None, None].expand(idx.shape + (1, 4)))[..., 0, :]
    if not f32:
        return quat_normalize(q)
    x, y, z, w = q.unbind(-1)
    norm = sqrt_f32(fma_f32(w, w, fma_f32(z, z, fma_f32(y, y, x * x))))
    return q / torch.clamp(norm, min=_EPS)[..., None]


def so3_hat(w: torch.Tensor) -> torch.Tensor:
    """(...,3) -> (...,3,3) skew-symmetric."""
    wx, wy, wz = w.unbind(-1)
    zero = torch.zeros_like(wx)
    m = torch.stack([zero, -wz, wy, wz, zero, -wx, -wy, wx, zero], dim=-1)
    return m.reshape(w.shape[:-1] + (3, 3))


def so3_vee(m: torch.Tensor) -> torch.Tensor:
    return torch.stack([m[..., 2, 1], m[..., 0, 2], m[..., 1, 0]], dim=-1)


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
    return _eye3_like(K) + a[..., None] * K + b[..., None] * small_matmul(K, K)


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
    # the constants as tensors of s2's dtype: under torch.func a Python
    # scalar beside a 0-dim operand gives a float64 tangent
    zero, one = torch.zeros_like(s2), torch.ones_like(s2)
    sin_theta = torch.where(tiny, zero, 0.5 * torch.sqrt(torch.where(tiny, one, s2)))
    theta = torch.atan2(sin_theta, cos_theta)

    small = sin_theta < 1e-6
    near_pi = cos_theta < -0.999
    scale = torch.where(
        small,
        0.5 + theta * theta / 12.0,
        theta / torch.where(small, one, 2.0 * sin_theta),
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


def so3_project(R: torch.Tensor, iters: int = 2) -> torch.Tensor:
    """Project a near-rotation (...,3,3) onto SO(3) by the Newton polar
    iteration R <- R (3I - R^T R)/2. Needed wherever an extracted rotation
    is re-multiplied into a pose chain frame after frame: without it the
    constant-velocity rotation prior drove the chain to NaN within 10
    frames in the JAX package."""
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    for _ in range(iters):
        R = small_matmul(R, 1.5 * eye - 0.5 * small_matmul(R.transpose(-1, -2), R))
    return R


def matrix_to_rpy(R: torch.Tensor) -> torch.Tensor:
    """(...,3,3) -> (roll, pitch, yaw) in DEGREES, the reference's `R2rpy`
    (src/radar_odometry.cpp:120-135) that feeds the sector-search
    heading."""
    n, o, a = R[..., :, 0], R[..., :, 1], R[..., :, 2]
    y = torch.atan2(n[..., 1], n[..., 0])
    p = torch.atan2(-n[..., 2], n[..., 0] * torch.cos(y) + n[..., 1] * torch.sin(y))
    r = torch.atan2(a[..., 0] * torch.sin(y) - a[..., 1] * torch.cos(y),
                    -o[..., 0] * torch.sin(y) + o[..., 1] * torch.cos(y))
    return torch.stack([r, p, y], dim=-1) / math.pi * 180.0
