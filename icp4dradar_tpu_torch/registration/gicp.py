"""GICP: distribution-to-distribution registration with plane-regularised
per-point covariances and a Gauss-Newton SE(3) solve (PyTorch port of
`icp4dradar_tpu/registration/gicp.py`).

Behavioural spec: `fast_gicp::FastGICPSingleThread` as the reference uses
it for scan-to-submap alignment (src/radar_odometry.cpp:399-411):
covariances from k=5 nearest neighbours (:404), eigenvalues regularised
to (1, 1, eps), the Mahalanobis cost r^T (C_b + R C_a R^T)^-1 r, one
correspondence per point gated by MAX_SEARCH_RADIUS (:35). A registration
packs its target rows once (`ops/knn.py::nn_prepare`: live rows first,
with their original indices and the live count on the device), and every
GN iteration, and the fitness search after the last, runs the masked 1-NN
search over them (`nn_search`: one launch of the CUDA kernel
`csrc/nn_search.cu` on the card, no host sync). It sweeps the live rows
only; a source with no live row below d2 = 1e30 re-scans every row with
the masked rows' penalty, so the result is the all-rows search's. The JAX
package's `lax.while_loop` is a Python loop here with one host sync per
iteration.
On CUDA the 3x3 inverses and the 6x6 Cholesky use the `_ex` forms, which
keep their failure flags on the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from icp4dradar_tpu_torch.config import GicpConfig
from icp4dradar_tpu_torch.geom.linalg import solve_psd, sym3x3_smallest_eigvec
from icp4dradar_tpu_torch.geom.se3 import se3_apply, se3_exp
from icp4dradar_tpu_torch.geom.so3 import so3_hat
from icp4dradar_tpu_torch.ops.knn import knn, nn_prepare, nn_search


@dataclass(frozen=True)
class GicpResult:
    transform: torch.Tensor   # (..., 4, 4) T: src -> tgt
    converged: torch.Tensor   # (...) bool
    fitness: torch.Tensor     # (...) mean squared correspondence distance
    iterations: torch.Tensor  # (...) int32


def covariances_from_neighbors(
    queries: torch.Tensor,
    neigh: torch.Tensor,
    valid: torch.Tensor,
    cov_epsilon: float = 1e-3,
) -> torch.Tensor:
    """(N, 3, 3) plane-regularised covariances from explicit neighbourhoods:
    queries (N, 3), neigh (N, k, 3), valid (N, k) bool; invalid slots fall
    back to the query point. FastGICP's eigenvalue regularisation (1, 1,
    eps) in closed form: I - (1 - eps) n n^T, n the smallest eigenvector of
    the neighbourhood's covariance (the surface normal)."""
    neigh = torch.where(valid[..., None], neigh, queries[:, None, :])
    wk = valid.to(queries.dtype)
    nk = torch.clamp(torch.sum(wk, dim=-1, keepdim=True), min=1.0)
    mu = torch.sum(neigh * wk[..., None], dim=-2) / nk
    c = (neigh - mu[:, None, :]) * wk[..., None]
    cov = torch.einsum("nki,nkj->nij", c, c) / nk[..., None]
    n = sym3x3_smallest_eigvec(cov)
    eye = torch.eye(3, dtype=queries.dtype, device=queries.device)
    return eye - (1.0 - cov_epsilon) * n[..., :, None] * n[..., None, :]


def point_covariances(
    xyz: torch.Tensor,
    mask: torch.Tensor,
    k: int = 5,
    cov_epsilon: float = 1e-3,
) -> torch.Tensor:
    """(N, 3, 3) plane-regularised covariance per point from its k nearest
    valid points (itself included); neighbours past the mask (d2 >= 1e20)
    fall back to the point itself."""
    idx, d2 = knn(xyz, xyz, k, mask)
    return covariances_from_neighbors(xyz, xyz[idx.long()], d2 < 1e20, cov_epsilon)


def live_point_covariances(
    xyz: torch.Tensor,
    mask: torch.Tensor,
    k: int = 5,
    cov_epsilon: float = 1e-3,
) -> torch.Tensor:
    """`point_covariances` computed over the live rows (mask > 0.5) alone:
    only they are queried, and only they are searched, in their original
    order. A live row's covariance is the one `point_covariances` gives:
    `knn` forms the same expanded distances, and a stable sort over the
    live columns keeps the lower original index first among ties. With
    fewer than k live rows the missing neighbours fall back to the point
    itself, as there. A masked row gets diag(1, 1, eps) = I - (1 - eps)
    e_z e_z^T, a finite value that `gicp_align` weights by 0. Reads the
    live count on the host once (`nonzero`)."""
    live = torch.nonzero(mask > 0.5).squeeze(1)
    diag = torch.tensor([1.0, 1.0, cov_epsilon], dtype=xyz.dtype, device=xyz.device)
    cov = torch.diag(diag).expand(xyz.shape[0], 3, 3).clone()
    L = live.shape[0]
    if L == 0:
        return cov
    pts = xyz[live]
    kk = min(k, L)
    idx, d2 = knn(pts, pts, kk, torch.ones(L, dtype=xyz.dtype, device=xyz.device))
    if kk < k:  # the slots past the live rows: invalid, as d2 >= 1e20 is
        idx = torch.cat([idx, idx.new_zeros((L, k - kk))], dim=1)
        d2 = torch.cat([d2, d2.new_full((L, k - kk), float("inf"))], dim=1)
    cov[live] = covariances_from_neighbors(pts, pts[idx.long()], d2 < 1e20, cov_epsilon)
    return cov


def gicp_align(
    src_xyz: torch.Tensor,
    tgt_xyz: torch.Tensor,
    src_mask: Optional[torch.Tensor] = None,
    tgt_mask: Optional[torch.Tensor] = None,
    init_transform: Optional[torch.Tensor] = None,
    cfg: GicpConfig = GicpConfig(),
    src_cov: Optional[torch.Tensor] = None,
    tgt_cov: Optional[torch.Tensor] = None,
) -> GicpResult:
    """Align src (N, 3) onto tgt (M, 3) by distribution-to-distribution
    Gauss-Newton from init_transform (identity by default), stopping when
    sum |xi| <= cfg.transformation_epsilon or after cfg.max_iterations.
    Fitness: the mean gated squared distance after one more search at the
    final transform. Covariances not given are computed over the live rows
    (`live_point_covariances`): the masked rows' weight 0 makes the result
    that of `point_covariances`' all-rows output."""
    dt, dev = src_xyz.dtype, src_xyz.device
    if src_mask is None:
        src_mask = torch.ones(src_xyz.shape[0], dtype=dt, device=dev)
    if tgt_mask is None:
        tgt_mask = torch.ones(tgt_xyz.shape[0], dtype=dt, device=dev)
    tgt_xyz, tgt_mask = tgt_xyz.contiguous(), tgt_mask.to(dt).contiguous()
    if src_cov is None:
        src_cov = live_point_covariances(src_xyz, src_mask, cfg.k_correspondences,
                                         cfg.cov_epsilon)
    if tgt_cov is None:
        tgt_cov = live_point_covariances(tgt_xyz, tgt_mask, cfg.k_correspondences,
                                         cfg.cov_epsilon)
    T = (torch.eye(4, dtype=dt, device=dev) if init_transform is None
         else init_transform.to(dt))
    d = np.float32(cfg.max_correspondence_dist)
    max_d2 = float(d * d)                 # squared in f32, as the JAX package
    eye3 = torch.eye(3, dtype=dt, device=dev)
    eye6 = torch.eye(6, dtype=dt, device=dev)
    N = src_xyz.shape[0]
    Jv = -eye3.expand(N, 3, 3)
    tgt_ops = nn_prepare(tgt_xyz, tgt_mask)

    def gn_step(T):
        R = T[:3, :3]
        p = se3_apply(T, src_xyz)                            # (N, 3)
        idx, d2 = nn_search(p, tgt_ops)
        w = src_mask * (d2 < max_d2)
        il = idx.long()
        q, Cb = tgt_xyz[il], tgt_cov[il]
        Ca_rot = R @ src_cov @ R.T
        M, _ = torch.linalg.inv_ex(Cb + Ca_rot + cfg.cov_epsilon * eye3)
        r = q - p
        J = torch.cat([Jv, so3_hat(p)], dim=-1)              # (N, 3, 6)
        MJ = M @ J
        wJ = J * w[:, None, None]
        H = torch.einsum("nij,nik->jk", wJ, MJ)
        g = torch.einsum("nij,ni->j", wJ, torch.einsum("nij,nj->ni", M, r))
        xi = -solve_psd(H + cfg.lm_lambda * eye6, g)
        return se3_exp(xi) @ T, torch.sum(torch.abs(xi))

    eps = cfg.transformation_epsilon
    iters = 0
    delta = torch.tensor(float("inf"), dtype=dt, device=dev)
    while iters < cfg.max_iterations and bool(delta > eps):
        T, delta = gn_step(T)
        iters += 1

    _, d2_fit = nn_search(se3_apply(T, src_xyz), tgt_ops)
    gated = src_mask * (d2_fit < max_d2)
    fitness = torch.sum(d2_fit * gated) / torch.clamp(torch.sum(gated), min=1.0)
    converged = (delta <= eps) | (iters >= cfg.max_iterations)
    return GicpResult(transform=T, converged=converged, fitness=fitness,
                      iterations=torch.tensor(iters, dtype=torch.int32, device=dev))
