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

`gicp_align_streams` registers S independent streams at once (serving, as
the JAX package vmaps `gicp_align`): one K2 launch a GN iteration for every
stream, each against its own packed targets, a per-stream active mask (a
stream that has converged holds its transform, as a vmapped `while_loop`
holds it) and one host sync an iteration for all streams. `gicp_align` is
its one-stream case. Every product and sum on the path rounds alike
whatever the number of streams, so a stream registers alike, bit for bit,
alone and in a batch. The covariances and the GN step have one body on
every device: closed-form 3x3 inverses and 6x6 solve, small products
summed along their innermost axis (`_mm`, `_mv`) and pairwise sums over
the points (the geometry helpers they call, `solve_spd6`'s products and
`se3_apply`, keep their own device forms).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from icp4dradar_tpu_torch.config import GicpConfig
from icp4dradar_tpu_torch.geom.linalg import (
    inv3x3,
    pairwise_sum,
    solve_spd6,
    sym3x3_smallest_eigvec,
)
from icp4dradar_tpu_torch.geom.se3 import se3_apply, se3_exp
from icp4dradar_tpu_torch.geom.so3 import so3_hat
from icp4dradar_tpu_torch.ops.knn import knn, nn_prepare, nn_search
from icp4dradar_tpu_torch.utils.profiling import count


@dataclass(frozen=True)
class GicpResult:
    transform: torch.Tensor   # (..., 4, 4) T: src -> tgt
    converged: torch.Tensor   # (...) bool
    fitness: torch.Tensor     # (...) mean squared correspondence distance
    iterations: torch.Tensor  # (...) int32


def _mm(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A @ B for small factors, summed over k along the innermost axis on
    every device (`small_matmul`'s form on the card): a stream's products
    round alike whatever the streams beside it."""
    return torch.sum(A[..., :, None, :] * B.transpose(-1, -2)[..., None, :, :], dim=-1)


def _mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(..., m, k) A times (..., k) x, as `_mm`."""
    return torch.sum(A * x[..., None, :], dim=-1)


def covariances_from_neighbors(
    queries: torch.Tensor,
    neigh: torch.Tensor,
    valid: torch.Tensor,
    cov_epsilon: float = 1e-3,
) -> torch.Tensor:
    """(..., N, 3, 3) plane-regularised covariances from explicit
    neighbourhoods: queries (..., N, 3), neigh (..., N, k, 3), valid (...,
    N, k) bool; invalid slots fall back to the query point. FastGICP's
    eigenvalue regularisation (1, 1, eps) in closed form: I - (1 - eps) n
    n^T, n the smallest eigenvector of the neighbourhood's covariance (the
    surface normal)."""
    neigh = torch.where(valid[..., None], neigh, queries[..., None, :])
    wk = valid.to(queries.dtype)
    nk = torch.clamp(torch.sum(wk, dim=-1, keepdim=True), min=1.0)
    mu = pairwise_sum(neigh * wk[..., None], dim=-2) / nk
    c = (neigh - mu[..., None, :]) * wk[..., None]
    cov = _mm(c.transpose(-1, -2), c) / nk[..., None]
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
    `knn` forms the same distances, and a stable sort over the live columns
    keeps the lower original index first among ties. With fewer than k
    live rows the missing neighbours fall back to the point itself, as
    there. A masked row gets diag(1, 1, eps) = I - (1 - eps) e_z e_z^T, a
    finite value that `gicp_align` weights by 0.

    xyz ([S,] M, 3), mask ([S,] M): with a stream axis every stream's live
    rows are packed to the front and padded to the largest live count L
    (the padded columns masked), all streams in the same launches; a
    stream's covariances are the ones it gets alone. Reads the live counts
    on the host once (their maximum)."""
    if xyz.dim() == 2:
        return live_point_covariances(xyz[None], mask[None], k, cov_epsilon)[0]
    S, M = mask.shape
    dt, dev = xyz.dtype, xyz.device
    live = mask > 0.5
    counts = live.sum(dim=-1)
    # a copy from the host, then a read of the largest count: on a card,
    # each waits for the stream
    count("host_syncs", 2)
    diag = torch.diag(torch.tensor([1.0, 1.0, cov_epsilon], dtype=dt, device=dev))
    L = int(counts.max())
    if L == 0:
        return diag.expand(S, M, 3, 3).clone()
    # each stream's rows in a stable partition, live rows first in original
    # order (ranks by a running count, not a sort over all M rows)
    ahead = torch.cumsum(live, dim=-1)                                       # live rows <= j
    j = torch.arange(M, device=dev)
    dest = torch.where(live, ahead - 1, counts[:, None] + j - ahead)
    order = torch.empty_like(dest).scatter_(1, dest, j.expand(S, M))[:, :L]
    valid = torch.arange(L, device=dev) < counts[:, None]                    # (S, L)
    pts = torch.where(valid[..., None],
                      torch.gather(xyz, 1, order[..., None].expand(S, L, 3)), 0.0)
    kk = min(k, L)
    idx, d2 = knn(pts, pts, kk, valid.to(dt))
    if kk < k:  # the slots past the live rows: invalid, as d2 >= 1e20 is
        idx = torch.cat([idx, idx.new_zeros((S, L, k - kk))], dim=-1)
        d2 = torch.cat([d2, d2.new_full((S, L, k - kk), float("inf"))], dim=-1)
    neigh = torch.gather(pts, 1, idx.long().reshape(S, L * k, 1).expand(S, L * k, 3))
    cov = covariances_from_neighbors(pts, neigh.reshape(S, L, k, 3), d2 < 1e20, cov_epsilon)
    cov = torch.where(valid[..., None, None], cov, diag)
    # back to the rows: live rows get theirs, the padding writes the
    # masked rows' diag(1, 1, eps) onto masked rows
    rows = (order + M * torch.arange(S, device=dev)[:, None]).reshape(-1)
    out = diag.expand(S * M, 3, 3).clone()
    return out.index_copy(0, rows, cov.reshape(S * L, 3, 3)).reshape(S, M, 3, 3)


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
    that of `point_covariances`' all-rows output. One stream of
    `gicp_align_streams`, so a stream registers alike alone and in a
    batch."""
    dt, dev = src_xyz.dtype, src_xyz.device
    if src_mask is None:
        src_mask = torch.ones(src_xyz.shape[0], dtype=dt, device=dev)
    if tgt_mask is None:
        tgt_mask = torch.ones(tgt_xyz.shape[0], dtype=dt, device=dev)
    r = gicp_align_streams(
        src_xyz[None], tgt_xyz[None], src_mask[None], tgt_mask[None],
        None if init_transform is None else init_transform[None], cfg,
        None if src_cov is None else src_cov[None], None if tgt_cov is None else tgt_cov[None])
    return GicpResult(transform=r.transform[0], converged=r.converged[0],
                      fitness=r.fitness[0], iterations=r.iterations[0])


def gicp_align_streams(
    src_xyz: torch.Tensor,
    tgt_xyz: torch.Tensor,
    src_mask: torch.Tensor,
    tgt_mask: torch.Tensor,
    init_transforms: Optional[torch.Tensor] = None,
    cfg: GicpConfig = GicpConfig(),
    src_cov: Optional[torch.Tensor] = None,
    tgt_cov: Optional[torch.Tensor] = None,
) -> GicpResult:
    """`gicp_align` over S independent streams at once (serving): stream s
    aligns src_xyz[s] (N, 3) onto its own targets tgt_xyz[s] (M, 3). Every
    GN iteration is one 1-NN search over all streams (one K2 launch on the
    card), batched small products and one 6x6 solve a stream.
    Each stream keeps its own active mask, as a vmapped `lax.while_loop`
    does: a stream that has converged holds its transform, update size and
    iteration count, and the loop ends when no stream is active or at the
    iteration cap; one host sync an iteration for all streams. The fitness
    search after the last iteration is one more launch for all streams.

    src_xyz (S,N,3), tgt_xyz (S,M,3), src_mask (S,N), tgt_mask (S,M),
    init_transforms (S,4,4) (identity by default), src_cov (S,N,3,3) and
    tgt_cov (S,M,3,3) (computed over the live rows when None) ->
    GicpResult with a leading (S,) axis."""
    S, N = src_xyz.shape[:2]
    M = tgt_xyz.shape[1]
    dt, dev = src_xyz.dtype, src_xyz.device
    tgt_xyz, tgt_mask = tgt_xyz.contiguous(), tgt_mask.to(dt).contiguous()
    if src_cov is None:
        src_cov = live_point_covariances(src_xyz, src_mask, cfg.k_correspondences,
                                         cfg.cov_epsilon)
    if tgt_cov is None:
        tgt_cov = live_point_covariances(tgt_xyz, tgt_mask, cfg.k_correspondences,
                                         cfg.cov_epsilon)
    T = (torch.eye(4, dtype=dt, device=dev).repeat(S, 1, 1) if init_transforms is None
         else init_transforms.to(dt))
    d = np.float32(cfg.max_correspondence_dist)
    max_d2 = float(d * d)                 # squared in f32, as the JAX package
    eye3 = torch.eye(3, dtype=dt, device=dev)
    eye6 = torch.eye(6, dtype=dt, device=dev)
    Jv = -eye3.expand(S, N, 3, 3)
    tgt_ops = nn_prepare(tgt_xyz, tgt_mask)
    tgt_cov9 = tgt_cov.reshape(S, M, 9)

    def gn_step(T):
        R = T[:, None, :3, :3]
        p = se3_apply(T, src_xyz)                            # (S, N, 3)
        idx, d2 = nn_search(p, tgt_ops)
        w = src_mask * (d2 < max_d2)
        il = idx.long()[..., None]
        q = torch.gather(tgt_xyz, 1, il.expand(S, N, 3))
        Cb = torch.gather(tgt_cov9, 1, il.expand(S, N, 9)).reshape(S, N, 3, 3)
        J = torch.cat([Jv, so3_hat(p)], dim=-1)              # (S, N, 3, 6)
        Ca_rot = _mm(_mm(R, src_cov), R.transpose(-1, -2))
        Minv = inv3x3(Cb + Ca_rot + cfg.cov_epsilon * eye3)
        wJt = (J * w[..., None, None]).transpose(-1, -2)
        H = pairwise_sum(_mm(wJt, _mm(Minv, J)), dim=1)
        g = pairwise_sum(_mv(wJt, _mv(Minv, q - p)), dim=1)
        xi = -solve_spd6(H + cfg.lm_lambda * eye6, g)
        return _mm(se3_exp(xi), T), torch.sum(torch.abs(xi), dim=-1)

    eps = cfg.transformation_epsilon
    it = 0
    delta = torch.full((S,), float("inf"), dtype=dt, device=dev)
    iters = torch.zeros(S, dtype=torch.int32, device=dev)
    while it < cfg.max_iterations:
        active = delta > eps
        count("host_syncs")
        if not bool(active.any()):                           # the iteration's host sync
            break
        T_new, dlt = gn_step(T)
        T = torch.where(active[:, None, None], T_new, T)     # converged streams hold
        delta = torch.where(active, dlt, delta)
        iters = iters + active.to(torch.int32)
        it += 1

    _, d2_fit = nn_search(se3_apply(T, src_xyz), tgt_ops)
    gated = src_mask * (d2_fit < max_d2)
    fitness = pairwise_sum(d2_fit * gated) / torch.clamp(pairwise_sum(gated), min=1.0)
    converged = (delta <= eps) | (iters >= cfg.max_iterations)
    return GicpResult(transform=T, converged=converged, fitness=fitness, iterations=iters)
