"""VGICP: scan-to-map registration against the voxel distribution map
(PyTorch port of `icp4dradar_tpu/registration/vgicp.py`).

Per-voxel Gaussians come from the map's incremental statistics, scan
covariances from the radar measurement model, and each Gauss-Newton
iteration is one fused sweep (`ops/vgicp_fused.py`, the CUDA kernel
`csrc/vgicp_sweep.cu` on the card) over operands packed once per
registration (`vgicp_prepare`), not once per sweep. Behavioral lineage:
FastGICP distribution-to-distribution cost (src/radar_odometry.cpp:399-411)
with the covariance estimation moved from query time to map-build time.

`vgicp_align_streams` and the stream axis of `vgicp_align_block` run S
independent streams (serving) in the same launches: one sweep a GN
iteration over every stream's frames, each against its own submap.
`vgicp_align` is its one-stream case.

The JAX package's `lax.while_loop` over GN iterations is a Python loop here:
its condition costs one host sync per iteration, the only one (the sweep,
frozen and step calls copy nothing from the host). The loop's spans:
`gn.prepare` (the operands packed, and the first read of the active
mask), then per iteration `gn.iteration` with `gn.sweep` (K4 and its
finish, and each K5 step), `gn.solve` (`gn_step`: the damped step
T <- exp(xi) T of every frame, one kernel launch on the card) and
`gn.sync` (the read that decides the next iteration, none after the cap's
last). With `gicp.inner_gn_steps
> 0` each GN body is one sweep followed by that many sweep-free steps on
the payload the sweep matched (`vgicp_frozen`, the CUDA kernel
`vgicp_frozen_launch` on the card), as the JAX package runs on the TPU; its
CPU path ignores the knob, the port honours it on every device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from icp4dradar_tpu_torch.config import GicpConfig
from icp4dradar_tpu_torch.ops.gn_step import gn_step
from icp4dradar_tpu_torch.ops.vgicp_fused import (
    radar_point_covariances_packed,
    vgicp_frozen,
    vgicp_prepare,
    vgicp_sweep,
)
from icp4dradar_tpu_torch.registration.gicp import GicpResult
from icp4dradar_tpu_torch.utils.profiling import count, drained, span


def _next_iteration(it: int, cfg: GicpConfig, delta) -> Optional[torch.Tensor]:
    """The loop's condition: below the iteration cap, the active mask
    `delta > eps` when any entry of it is set (the one host read of an
    iteration, the span `gn.sync`), else None."""
    if it >= cfg.max_iterations:
        return None
    active = delta > cfg.vgicp_transformation_epsilon
    with span("gn.sync"):
        count("host_syncs")
        go = bool(active.any())
        drained(active.device)
        return active if go else None


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
    T = (torch.eye(4, dtype=dt, device=dev) if init_transform is None else init_transform)
    # one stream of `vgicp_align_streams`: the same GN loop and the same
    # batched small products as a stream of a batch, so a stream registers
    # alike whether it is served alone or with others
    r = vgicp_align_streams(
        src_xyz[None], tgt_mean[None], tgt_cov6[None], src_mask[None], tgt_mask[None],
        src_cov6[None], T[None], cfg, tgt_count=tgt_count,
        gate_axis=None if gate_axis is None else gate_axis[None])
    return GicpResult(transform=r.transform[0], converged=r.converged[0],
                      fitness=r.fitness[0], iterations=r.iterations[0])


def vgicp_align_streams(
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
) -> GicpResult:
    """`vgicp_align` over S independent streams at once (serving): stream s
    registers its one scan against its own submap, centred on its own
    prediction, and every GN iteration is one sweep over all S streams (one
    K4 launch), then `cfg.inner_gn_steps` frozen steps (K5, one group a
    stream). Each stream keeps its own active mask, as a vmapped
    `lax.while_loop` does: a stream that has converged holds its transform,
    fitness and iteration count, and the loop ends when no stream is active
    or at the iteration cap. One host sync per iteration for all streams.

    src_xyz (S,N,3), src_mask (S,N), src_cov6 (S,N,6), targets (S,P,3) /
    (S,P,6) / (S,P), tgt_count (S,), gate_axis (S,2), init_transforms
    (S,4,4) -> GicpResult with a leading (S,) axis."""
    S, dt, dev = src_xyz.shape[0], src_xyz.dtype, src_xyz.device
    eps = cfg.vgicp_transformation_epsilon
    inner = cfg.inner_gn_steps
    with span("gn.prepare"):
        T = init_transforms.clone()
        center = T[:, :3, 3].clone()
        T[:, :3, 3] = 0.0
        ops = vgicp_prepare(src_xyz, src_mask, src_cov6, tgt_mean - center[:, None, :],
                            tgt_cov6, tgt_mask, tgt_count=tgt_count, gate_axis=gate_axis)
        kw = dict(max_correspondence_dist=cfg.max_correspondence_dist, cov_eps=cfg.cov_epsilon,
                  _acc_groups=S)
        it = 0
        delta = torch.full((S,), float("inf"), dtype=dt, device=dev)
        iters = torch.zeros(S, dtype=torch.int32, device=dev)
        wsum = d2sum = torch.zeros(S, dtype=dt, device=dev)
        go = _next_iteration(it, cfg, delta)

    def per_stream(H, g, cost, ws, ds):
        # one stream's sums come back without the (S,) axis: restore it, so
        # that every S runs the same batched products
        return H.reshape(S, 6, 6), g.reshape(S, 6), ws.reshape(S), ds.reshape(S)

    while go is not None:
        active = go
        with span("gn.iteration"):
            with span("gn.sweep"):
                H, g, cost, ws, ds, *best = vgicp_sweep(T, ops, return_best=inner > 0, **kw)
                H, g, ws, ds = per_stream(H, g, cost, ws, ds)
            with span("gn.solve"):
                T, dlt = gn_step(T, H, g, cfg.lm_lambda, active)
            for _ in range(inner):
                with span("gn.sweep"):
                    H, g, ws, ds = per_stream(*vgicp_frozen(T, ops, best[0], **kw))
                with span("gn.solve"):
                    T, d = gn_step(T, H, g, cfg.lm_lambda, active)
                    dlt = dlt + d
            # a held stream keeps the fitness of its last evaluation
            wsum, d2sum = torch.where(active, ws, wsum), torch.where(active, ds, d2sum)
            delta = torch.where(active, dlt, delta)
            iters = iters + active.to(torch.int32) * (1 + inner)
            it += 1 + inner
            go = _next_iteration(it, cfg, delta)
    fitness = d2sum / torch.clamp(wsum, min=1.0)
    converged = (delta <= eps) | (iters >= cfg.max_iterations)
    T = T.clone()
    T[:, :3, 3] += center                 # back to the world frame
    return GicpResult(transform=T, converged=converged, fitness=fitness, iterations=iters)


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
    With a stream axis (serving), src_xyz (S,B,N,3), src_mask (S,B,N),
    src_cov6 (S,B,N,6), init_transforms (S,B,4,4), one submap per stream
    (S,P,3) / (S,P,6) / (S,P), tgt_count (S,), gate_axis (S,2): every
    iteration is one sweep over all S x B frames, stream s centred at
    init_transforms[s, 0] and held, as a vmapped loop holds it, once none
    of its frames is active; results lead with (S, B).
    A frame whose prediction drifted past the correspondence gate matches
    nothing and reports fitness 0, so callers MUST gate on matched_weight,
    not fitness alone. Blocks run no inner steps: `cfg.inner_gn_steps` is
    ignored here, as in the JAX package."""
    streamed = init_transforms.dim() == 4
    lead = tuple(init_transforms.shape[:-2])            # (B,) or (S, B)
    S = lead[0] if streamed else 1
    B = lead[-1]
    dt, dev = src_xyz.dtype, src_xyz.device
    T = init_transforms.reshape(S * B, 4, 4).clone()
    # one centering per stream: a stream's frames sit within a few meters
    # of its block-start prediction
    center = init_transforms.reshape(S, B, 4, 4)[:, 0, :3, 3].clone()     # (S, 3)
    T[:, :3, 3] -= center.repeat_interleave(B, dim=0)
    N = src_xyz.shape[-2]
    eps = cfg.vgicp_transformation_epsilon
    with span("gn.prepare"):
        tgt_c = tgt_mean - (center[:, None, :] if streamed else center)
        ops = vgicp_prepare(src_xyz.reshape(S * B, N, 3), src_mask.reshape(S * B, N),
                            src_cov6.reshape(S * B, N, 6), tgt_c, tgt_cov6, tgt_mask,
                            tgt_count=tgt_count, gate_axis=gate_axis)
        it = 0
        delta = torch.full((S * B,), float("inf"), dtype=dt, device=dev)
        iters = torch.zeros(S * B, dtype=torch.int32, device=dev)
        wsum = d2sum = torch.zeros(S * B, dtype=dt, device=dev)
        go = _next_iteration(it, cfg, delta)
    while go is not None:
        active = go
        with span("gn.iteration"):
            with span("gn.sweep"):
                H, g, _, ws, ds = vgicp_sweep(
                    T, ops, cfg.max_correspondence_dist, cfg.cov_epsilon, _acc_groups=S * B)
            with span("gn.solve"):
                T, dlt = gn_step(T, H, g, cfg.lm_lambda, active)
            # a stream with no active frame holds its last evaluation
            live = active.reshape(S, B).any(dim=1).repeat_interleave(B)
            wsum, d2sum = torch.where(live, ws, wsum), torch.where(live, ds, d2sum)
            delta = torch.where(active, dlt, torch.zeros_like(dlt))
            iters = iters + active.to(torch.int32)
            it += 1
            go = _next_iteration(it, cfg, delta)
    fitness = d2sum / torch.clamp(wsum, min=1.0)
    converged = (delta <= eps) | (it >= cfg.max_iterations)
    T = T.clone()
    T[:, :3, 3] += center.repeat_interleave(B, dim=0)
    return GicpResult(transform=T.reshape(lead + (4, 4)), converged=converged.reshape(lead),
                      fitness=fitness.reshape(lead), iterations=iters.reshape(lead)), \
        wsum.reshape(lead)
