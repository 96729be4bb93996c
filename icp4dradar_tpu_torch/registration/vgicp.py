"""VGICP: scan-to-map registration against the voxel distribution map
(PyTorch port of `icp4dradar_tpu/registration/vgicp.py`).

Per-voxel Gaussians come from the map's incremental statistics, scan
covariances from the radar measurement model, and each Gauss-Newton
iteration is one fused sweep (`ops/vgicp_fused.py`, the CUDA kernel
`csrc/vgicp_sweep.cu` on the card) over operands packed once per
registration (`vgicp_prepare`), not once per sweep. Behavioral lineage:
FastGICP distribution-to-distribution cost (src/radar_odometry.cpp:399-411)
with the covariance estimation moved from query time to map-build time.

The JAX package's `lax.while_loop` over GN iterations is a Python loop here:
its condition costs one host sync per iteration, the only one (the sweep
and frozen calls copy nothing from the host). With `gicp.inner_gn_steps
> 0` each GN body is one sweep followed by that many sweep-free steps on
the payload the sweep matched (`vgicp_frozen`, the CUDA kernel
`vgicp_frozen_launch` on the card), as the JAX package runs on the TPU; its
CPU path ignores the knob, the port honours it on every device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from icp4dradar_tpu_torch.config import GicpConfig
from icp4dradar_tpu_torch.geom.linalg import solve_spd6
from icp4dradar_tpu_torch.geom.se3 import se3_exp
from icp4dradar_tpu_torch.ops.vgicp_fused import (
    radar_point_covariances_packed,
    vgicp_frozen,
    vgicp_prepare,
    vgicp_sweep,
)
from icp4dradar_tpu_torch.registration.gicp import GicpResult


def _gn_update(T, H, g, cfg: GicpConfig, active=None):
    """One damped GN step T <- exp(xi) T with xi = -H^-1 g; non-finite
    steps (no correspondences) and inactive frames hold. Returns (T,
    sum |xi|)."""
    eye = torch.eye(6, dtype=T.dtype, device=T.device)
    xi = solve_spd6(H + cfg.lm_lambda * eye, -g)
    xi = torch.where(torch.isfinite(xi), xi, 0.0)
    if active is not None:
        xi = torch.where(active[..., None], xi, 0.0)   # converged frames hold
    return se3_exp(xi) @ T, torch.sum(torch.abs(xi), dim=-1)


def vgicp_align(
    src_xyz: torch.Tensor,
    tgt_mean: torch.Tensor,
    tgt_cov6: torch.Tensor,
    src_mask: Optional[torch.Tensor] = None,
    tgt_mask: Optional[torch.Tensor] = None,
    src_cov6: Optional[torch.Tensor] = None,
    init_transform: Optional[torch.Tensor] = None,
    cfg: GicpConfig = GicpConfig(),
    tgt_count: Optional[torch.Tensor] = None,
    gate_axis: Optional[torch.Tensor] = None,
) -> GicpResult:
    """Align a sensor-frame scan (N,3) onto voxel distributions (means +
    packed covariances, (P,3) / (P,6)); init_transform is the pose
    prediction, which the GN refines. `tgt_count`: live target rows when
    front-packed (the sweep skips dead tiles). `gate_axis` (2,): band-gating
    direction, passed through to the sweep."""
    dt, dev = src_xyz.dtype, src_xyz.device
    if src_mask is None:
        src_mask = torch.ones(src_xyz.shape[0], dtype=dt, device=dev)
    if tgt_mask is None:
        tgt_mask = torch.ones(tgt_mean.shape[0], dtype=dt, device=dev)
    if src_cov6 is None:
        src_cov6 = radar_point_covariances_packed(src_xyz)
    T = (torch.eye(4, dtype=dt, device=dev) if init_transform is None
         else init_transform.clone())
    # Optimize in a cloud-centered frame: world coordinates at kilometer
    # scale would cancel in f32 and condition the hat(p) coupling poorly;
    # shifting by the predicted position keeps everything at sensor range.
    center = T[:3, 3].clone()
    T[:3, 3] = 0.0
    ops = vgicp_prepare(src_xyz, src_mask, src_cov6, tgt_mean - center[None, :], tgt_cov6,
                        tgt_mask, tgt_count=tgt_count, gate_axis=gate_axis)
    kw = dict(max_correspondence_dist=cfg.max_correspondence_dist, cov_eps=cfg.cov_epsilon)

    iters = 0
    delta = torch.tensor(float("inf"), dtype=dt, device=dev)
    wsum = d2sum = torch.zeros((), dtype=dt, device=dev)
    eps = cfg.vgicp_transformation_epsilon
    inner = cfg.inner_gn_steps
    while iters < cfg.max_iterations and bool(delta > eps):
        H, g, _, wsum, d2sum, *best = vgicp_sweep(T, ops, return_best=inner > 0, **kw)
        T, delta = _gn_update(T, H, g, cfg)
        iters += 1
        # sweep-free steps on the frozen correspondences; the cap is checked
        # only at the top, so `iters` may pass max_iterations by `inner`
        for _ in range(inner):
            H, g, _, wsum, d2sum = vgicp_frozen(T, ops, best[0], **kw)
            T, dlt = _gn_update(T, H, g, cfg)
            delta = delta + dlt
            iters += 1
    # fitness from the LAST evaluation point (a frozen step's, with inner
    # steps): at convergence it matches a final re-evaluation to first
    # order, so no extra sweep is paid
    fitness = d2sum / torch.clamp(wsum, min=1.0)
    converged = (delta <= eps) | (iters >= cfg.max_iterations)
    T = T.clone()
    T[:3, 3] += center                    # back to the world frame
    return GicpResult(transform=T, converged=converged, fitness=fitness,
                      iterations=torch.tensor(iters, dtype=torch.int32, device=dev))


def vgicp_align_block(
    src_xyz: torch.Tensor,
    tgt_mean: torch.Tensor,
    tgt_cov6: torch.Tensor,
    src_mask: torch.Tensor,
    tgt_mask: torch.Tensor,
    src_cov6: torch.Tensor,
    init_transforms: torch.Tensor,
    cfg: GicpConfig = GicpConfig(),
    tgt_count: Optional[torch.Tensor] = None,
    gate_axis: Optional[torch.Tensor] = None,
) -> Tuple[GicpResult, torch.Tensor]:
    """Frame-parallel VGICP: register B frames against ONE frozen submap
    jointly; the block's operands are packed once, and every GN iteration
    is a single batched sweep (`vgicp_sweep`) plus one batched 6x6 solve.
    Each frame keeps its own active mask: a converged frame holds its
    transform and stops counting iterations, and the loop runs until no
    frame is active or the iteration cap.

    src_xyz (B,N,3), src_mask (B,N), src_cov6 (B,N,6), init_transforms
    (B,4,4) -> (GicpResult with a leading (B,) axis, matched_weight (B,)).
    A frame whose prediction drifted past the correspondence gate matches
    nothing and reports fitness 0, so callers MUST gate on matched_weight,
    not fitness alone. Blocks run no inner steps: `cfg.inner_gn_steps` is
    ignored here, as in the JAX package."""
    B, dt, dev = src_xyz.shape[0], src_xyz.dtype, src_xyz.device
    T = init_transforms.clone()
    # one shared centering for the block: all frames sit within a few
    # meters of the block-start prediction
    center = T[0, :3, 3].clone()
    T[:, :3, 3] -= center
    ops = vgicp_prepare(src_xyz, src_mask, src_cov6, tgt_mean - center[None, :], tgt_cov6,
                        tgt_mask, tgt_count=tgt_count, gate_axis=gate_axis)

    eps = cfg.vgicp_transformation_epsilon
    it = 0
    delta = torch.full((B,), float("inf"), dtype=dt, device=dev)
    iters = torch.zeros(B, dtype=torch.int32, device=dev)
    wsum = d2sum = torch.zeros(B, dtype=dt, device=dev)
    while it < cfg.max_iterations:
        active = delta > eps
        if not bool(active.any()):
            break
        H, g, _, wsum, d2sum = vgicp_sweep(
            T, ops, cfg.max_correspondence_dist, cfg.cov_epsilon, _acc_groups=B)
        T, dlt = _gn_update(T, H, g, cfg, active)
        delta = torch.where(active, dlt, torch.zeros_like(dlt))
        iters = iters + active.to(torch.int32)
        it += 1
    fitness = d2sum / torch.clamp(wsum, min=1.0)
    converged = (delta <= eps) | (it >= cfg.max_iterations)
    T = T.clone()
    T[:, :3, 3] += center
    return GicpResult(transform=T, converged=converged, fitness=fitness,
                      iterations=iters), wsum
