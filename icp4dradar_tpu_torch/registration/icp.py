"""Batched point-to-point ICP on the fused moments pass (PyTorch port of
`icp4dradar_tpu/registration/icp.py`).

Behavioral spec: PCL `pcl::IterativeClosestPoint` as used by the reference
(src/iterative_closest_point.cpp:508-521): default 10 iterations, best-fit
rigid update per iteration, fitness = mean squared correspondence distance
(`getFitnessScore`, :516, :520).

B frame pairs register together: the clouds are prepared once
(`icp_prepare`: packed for the kernel on the card), and each iteration is
ONE moments launch over all pairs (`ops/icp_fused.py`), with the rigid
update recovered from 19 scalars per pair by Horn's method. Pairs freeze
once converged, as the JAX package's vmapped `lax.while_loop` freezes
finished lanes: each pair keeps its own transform, step and iteration
count, so a pair's result equals the unbatched call. A frozen pair is not
swept again (the pass takes the active mask, on the device); the final
fitness pass sweeps every pair. The loop ends when no pair is active,
which costs one host sync per iteration. Its spans: `icp.prepare` (the
clouds packed, and the first read of the active mask), `icp.iteration`
per pass (one moments launch and the Horn step) with `icp.sync`, the read
that decides the next pass (none after the cap's last), and
`icp.fitness`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from icp4dradar_tpu_torch.config import IcpConfig
from icp4dradar_tpu_torch.geom.se3 import se3_log
from icp4dradar_tpu_torch.ops.icp_fused import (
    icp_moments,
    icp_prepare,
    moments_to_transform,
)
from icp4dradar_tpu_torch.utils.profiling import count, drained, span


@dataclass(frozen=True)
class IcpResult:
    transform: torch.Tensor        # (..., 4, 4) T: src -> tgt
    converged: torch.Tensor        # (...) bool (epsilon reached or cap hit)
    fitness: torch.Tensor          # (...) mean squared distance, ungated (PCL)
    gated_fitness: torch.Tensor    # (...) mean squared distance in the gate
    inlier_fraction: torch.Tensor  # (...) gated correspondences / valid points
    iterations: torch.Tensor       # (...) int32


def icp_point_to_point(
    src_xyz: torch.Tensor,
    tgt_xyz: torch.Tensor,
    src_mask: Optional[torch.Tensor] = None,
    tgt_mask: Optional[torch.Tensor] = None,
    init_transform: Optional[torch.Tensor] = None,
    cfg: IcpConfig = IcpConfig(),
) -> IcpResult:
    """Align src onto tgt for B pairs at once: src (B,N,3), tgt (B,M,3),
    masks (B,N)/(B,M), init (B,4,4); or one pair without the batch axis."""
    unbatched = src_xyz.dim() == 2
    if unbatched:
        src_xyz, tgt_xyz = src_xyz[None], tgt_xyz[None]
        src_mask = None if src_mask is None else src_mask[None]
        tgt_mask = None if tgt_mask is None else tgt_mask[None]
        init_transform = None if init_transform is None else init_transform[None]
    B, dev, dt = src_xyz.shape[0], src_xyz.device, src_xyz.dtype
    if src_mask is None:
        src_mask = torch.ones(src_xyz.shape[:2], dtype=dt, device=dev)
    if tgt_mask is None:
        tgt_mask = torch.ones(tgt_xyz.shape[:2], dtype=dt, device=dev)
    if init_transform is None:
        init_transform = torch.eye(4, dtype=dt, device=dev).expand(B, 4, 4)

    def next_pass(passes, active) -> bool:
        """Below the cap, whether any pair is active: the loop's one host
        read a pass."""
        if passes >= cfg.max_iterations:
            return False
        with span("icp.sync"):
            count("host_syncs")
            go = bool(active.any())
            drained(active.device)
            return go

    with span("icp.prepare"):
        ops = icp_prepare(src_xyz.contiguous(), src_mask.contiguous(), tgt_xyz.contiguous(),
                          tgt_mask.contiguous())
        T = init_transform.to(dt).contiguous()
        iters = torch.zeros(B, dtype=torch.int32, device=dev)
        delta = torch.full((B,), float("inf"), dtype=dt, device=dev)
        active = torch.ones(B, dtype=torch.bool, device=dev)
        go = next_pass(0, active)

    def moments(T, active=None):
        return icp_moments(T, ops, cfg.max_correspondence_dist, active)

    passes = 0
    while go:
        with span("icp.iteration"):
            # frozen pairs get zero moments (an identity step) and keep T anyway
            dT, _ = moments_to_transform(moments(T, active))
            T = torch.where(active[:, None, None], dT @ T, T).contiguous()
            delta = torch.where(active, torch.sum(torch.abs(se3_log(dT)), dim=-1),
                                delta)
            iters = iters + active.to(torch.int32)
            active = (iters < cfg.max_iterations) & (delta > cfg.transformation_epsilon)
            passes += 1
            go = next_pass(passes, active)

    with span("icp.fitness"):
        # ONE post-convergence pass yields both fitness flavors: the pass
        # emits gated moments plus the ungated [s(mask*d2), s(mask)] sums.
        gm = moments(T)
        fitness = gm[:, 17] / torch.clamp(gm[:, 18], min=1e-9)
        _, gated_fitness = moments_to_transform(gm)
        inlier_fraction = gm[:, 0] / torch.clamp(torch.sum(src_mask, dim=-1), min=1.0)
    converged = delta <= max(cfg.transformation_epsilon, 1e-12)
    # PCL reports converged=true when it ran to completion
    converged = converged | (iters >= cfg.max_iterations)
    res = IcpResult(transform=T, converged=converged, fitness=fitness,
                    gated_fitness=gated_fitness,
                    inlier_fraction=inlier_fraction, iterations=iters)
    if unbatched:
        res = IcpResult(*(getattr(res, f)[0] for f in IcpResult.__dataclass_fields__))
    return res
