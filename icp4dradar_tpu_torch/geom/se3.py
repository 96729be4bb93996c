"""SE(3) rigid transforms as (...,4,4) homogeneous matrices + exp/log maps
(PyTorch port of `icp4dradar_tpu/geom/se3.py`).

Covers the reference's right-composition scan-to-scan accumulation
`currOdom = currOdom * T_icp` (src/iterative_closest_point.cpp:552) and the
twist used for the ICP convergence test.
"""

from __future__ import annotations

import torch

from icp4dradar_tpu_torch.geom.linalg import broadcast_shape, small_matmul
from icp4dradar_tpu_torch.geom.so3 import _eye3_like, so3_exp, so3_hat, so3_log
from icp4dradar_tpu_torch.utils.profiling import count


def se3_identity(dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.eye(4, dtype=dtype, device=device)


def se3_from_rt(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(...,3,3),(...,3) -> (...,4,4)."""
    batch = broadcast_shape(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., :, None]], dim=-1)
    count("host_syncs")            # a copy from the host: on a card, it waits for the stream
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype,
                          device=R.device).expand(batch + (4,))[..., None, :]
    return torch.cat([top, bottom], dim=-2)


def se3_rotation(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, :3]


def se3_translation(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, 3]


def se3_compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return small_matmul(a, b)


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    Rt = T[..., :3, :3].transpose(-1, -2)
    return se3_from_rt(Rt, -small_matmul(Rt, T[..., :3, 3:4])[..., 0])


def se3_apply(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (...,4,4) to points (...,N,3)."""
    return small_matmul(pts, T[..., :3, :3].transpose(-1, -2)) + T[..., None, :3, 3]


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """Twist (...,6) [v, w] -> (...,4,4). Same Taylor window as the JAX
    code: theta^2 < 1e-8."""
    v = xi[..., :3]
    w = xi[..., 3:]
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)
    small = theta2 < 1e-8
    theta = torch.sqrt(torch.where(small, 1.0, theta2))
    R = so3_exp(w)
    K = so3_hat(w)
    # Left Jacobian V = I + (1-cos)/t^2 K + (t - sin t)/t^3 K^2
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / torch.where(small, 1.0, theta2))
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta))
                    / torch.where(small, 1.0, theta2 * theta))
    V = _eye3_like(K) + b[..., None] * K + c[..., None] * small_matmul(K, K)
    return se3_from_rt(R, small_matmul(V, v[..., None])[..., 0])


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """(...,4,4) -> twist (...,6) [v, w]. Taylor window theta^2 < 1e-4: below
    it the closed form cancels catastrophically in f32."""
    t = T[..., :3, 3]
    w = so3_log(T[..., :3, :3])
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)
    small = theta2 < 1e-4
    theta = torch.sqrt(torch.where(small, 1.0, theta2))
    K = so3_hat(w)
    # V^{-1} = I - K/2 + cot_term * K^2,
    # cot_term = (1 - (t/2) cot(t/2)) / t^2  ->  1/12 + t^2/720 near 0.
    half = 0.5 * theta
    cot_half = torch.cos(half) / torch.where(small, 1.0, torch.sin(half))
    cot_term = torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half * cot_half) / torch.where(small, 1.0, theta2),
    )
    Vinv = _eye3_like(K) - 0.5 * K + cot_term[..., None] * small_matmul(K, K)
    v = small_matmul(Vinv, t[..., None])[..., 0]
    return torch.cat([v, w], dim=-1)
