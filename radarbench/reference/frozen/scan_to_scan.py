"""Frozen copy of `icp4dradar_tpu_torch/models/scan_to_scan.py` at commit
03a0450, part of the benchmark's reference: its plain PyTorch paths only
(the CUDA dispatch removed; what no reference path calls left out).

Scan-to-scan ICP odometry — the `icp4radar` pipeline (PyTorch port of
`icp4dradar_tpu/models/scan_to_scan.py`).

Reference main loop (src/iterative_closest_point.cpp:263-721): Doppler
RANSAC fit + static/dynamic split + LSQ ego velocity per scan,
point-to-point ICP current -> last, right-composed pose
`currOdom = currOdom * T_icp` (:552).

`run_scan_to_scan` runs a stacked sequence in three frame-parallel phases:
preprocessing in frame chunks, ONE batched ICP over every frame pair (one
kernel launch per iteration for all pairs), then the tracking gate, the
suspect-pair motion hold and the pose chain as log-depth scans.

Extensions beyond parity (config-gated, as in the JAX package):
`use_doppler_prior` seeds ICP with the Doppler ego-velocity translation;
`use_static_points_only` registers on static points; the tracking gate
(`_gate_relative`) replaces implausible ICP deltas by their Doppler
prediction, and pairs whose fitness marks them corrupt hold the last
accepted delta.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from .config import PipelineConfig
from .se3 import se3_from_rt
from .scan import RadarScan
from .doppler import (
    draw_uniforms,
    preprocess_frames,
)
from .icp import icp_point_to_point


@dataclass(frozen=True)
class ScanToScanOutput:
    """Per-frame record (ref output_result.csv row + velocity/icp dumps);
    stacked (F, ...) from `run_scan_to_scan`."""

    icp_transform: torch.Tensor  # (4,4) frame-to-frame
    world_T: torch.Tensor        # (4,4) pose after this frame
    velocity: torch.Tensor       # (3,) LSQ ego velocity
    fitness: torch.Tensor        # () ICP fitness score
    sine_A: torch.Tensor         # () Doppler model amplitude
    sine_b: torch.Tensor         # () Doppler model phase
    num_static: torch.Tensor     # () static point count
    converged: torch.Tensor      # () bool
    accepted: torch.Tensor       # () bool — tracking gate verdict
    iterations: torch.Tensor     # () int32 ICP iterations taken


def _gate_relative(cfg: PipelineConfig, T_icp, init_T, fitness):
    """Frame-parallel tracking gate: validate each ICP delta against its own
    prior (the Doppler prediction, or identity without one). Returns the
    deltas to compose (prior where rejected) and the accept flags; a
    pass-through when all three gates are inf (reference parity). Caveat as
    in the JAX package: without a Doppler prior, motion beyond
    max_correction_t / max_correction_rot_deg per frame is rejected."""
    t = cfg.tracking
    if not (math.isfinite(t.s2s_max_fitness)
            or math.isfinite(t.max_correction_t)
            or math.isfinite(t.max_correction_rot_deg)):
        return T_icp, torch.ones(fitness.shape, dtype=torch.bool,
                                 device=fitness.device)
    corr_t = torch.linalg.vector_norm(T_icp[..., :3, 3] - init_T[..., :3, 3],
                                      dim=-1)
    dR = init_T[..., :3, :3].transpose(-1, -2) @ T_icp[..., :3, :3]
    trace = dR[..., 0, 0] + dR[..., 1, 1] + dR[..., 2, 2]
    cos_a = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    corr_r = torch.rad2deg(torch.arccos(cos_a))
    # NOT max_fitness: s2s P2P fitness is the ungated mean d^2
    accept = ((fitness < t.s2s_max_fitness) & (corr_t < t.max_correction_t)
              & (corr_r < t.max_correction_rot_deg))
    return torch.where(accept[..., None, None], T_icp, init_T), accept


def _init_transform(velocity: torch.Tensor, use_doppler_prior: bool):
    """One frame of ego motion in the previous body frame, or identity."""
    eye = torch.eye(3, dtype=velocity.dtype, device=velocity.device)
    if use_doppler_prior:
        return se3_from_rt(eye, velocity)
    return se3_from_rt(eye, torch.zeros_like(velocity))


def _prefix_products(T: torch.Tensor) -> torch.Tensor:
    """world_T[k] = T[0] @ T[1] @ ... @ T[k] by Hillis-Steele doubling:
    ceil(log2 F) batched 4x4 products instead of F sequential ones. The
    product tree differs from XLA's associative_scan, so results agree to
    f32 round-off, not bitwise."""
    out = T
    shift = 1
    while shift < T.shape[0]:
        out = torch.cat([out[:shift], out[:-shift] @ out[shift:]])
        shift *= 2
    return out


def _hold_last_ok(T: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """held[i] = T[j] for the last j <= i with ok[j] (ok[0] must be True):
    the JAX package's last-valid associative scan, as a running max of
    indices."""
    idx = torch.arange(T.shape[0], device=T.device)
    last = torch.cummax(torch.where(ok, idx, 0), dim=0).values
    return T[last]


def _uniforms_for(scans: RadarScan, cfg: PipelineConfig, uniforms, generator):
    """The given (F, 2, H) RANSAC draws, or draws from `generator`, by
    default a generator on the scans' device seeded with `cfg.seed`."""
    if uniforms is not None:
        return uniforms
    dev = scans.device
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(cfg.seed)
    return draw_uniforms(scans.time.shape, cfg.doppler.num_hypotheses, generator, dev)


def run_scan_to_scan(
    scans: RadarScan,
    cfg: PipelineConfig = PipelineConfig(),
    uniforms: Optional[torch.Tensor] = None,
    use_doppler_prior: bool = False,
    use_static_points_only: bool = False,
    generator: Optional[torch.Generator] = None,
) -> ScanToScanOutput:
    """Run a stacked (F, ...) sequence; returns stacked per-frame outputs.

    Frame 0 pairs with itself and its delta is exactly the identity (ref
    order==0 behavior, src/iterative_closest_point.cpp:306-310).
    uniforms: (F, 2, H) RANSAC draws; when None they are drawn from
    `generator`, or from a generator on the scans' device seeded with
    `cfg.seed`."""
    dev = scans.device

    # Phase 1: per-frame preprocessing, in frame chunks.
    fits, statics, velocities = preprocess_frames(
        scans, _uniforms_for(scans, cfg, uniforms, generator), cfg.doppler)

    # Phase 2: every frame pair (k, k-1) in one batched ICP.
    def prev(x):
        return torch.cat([x[:1], x[:-1]])

    src_mask = statics if use_static_points_only else scans.mask
    tgt_mask = prev(statics) if use_static_points_only else prev(scans.mask)
    init_T = _init_transform(velocities, use_doppler_prior)
    res = icp_point_to_point(scans.xyz, prev(scans.xyz), src_mask, tgt_mask,
                             init_transform=init_T, cfg=cfg.icp)
    T_rel, accepted = _gate_relative(cfg, res.transform, init_T, res.fitness)
    # frame 0 pairs with itself: exactly identity, so a prior-seeded ICP
    # residual cannot shift the trajectory's anchor
    T_rel = T_rel.clone()
    T_rel[0] = torch.eye(4, dtype=T_rel.dtype, device=dev)

    # Suspect-pair containment (TrackingConfig.s2s_suspect_fitness): a
    # corrupt pair takes the last healthy ACCEPTED delta (motion hold).
    suspect_gate = float(cfg.tracking.s2s_suspect_fitness)
    if math.isfinite(suspect_gate):
        suspect = res.fitness > suspect_gate
        ok = accepted & ~suspect
        ok[0] = True                                   # identity seed
        T_rel = torch.where(suspect[:, None, None], _hold_last_ok(T_rel, ok),
                            T_rel)
        accepted = accepted & ~suspect

    # Phase 3: pose accumulation T_k = T_0 ... T_k as a prefix product.
    world_T = _prefix_products(T_rel)

    return ScanToScanOutput(
        icp_transform=T_rel, world_T=world_T, velocity=velocities,
        fitness=res.fitness, sine_A=fits.A, sine_b=fits.b,
        num_static=torch.sum(statics, dim=-1), converged=res.converged,
        accepted=accepted, iterations=res.iterations,
    )


