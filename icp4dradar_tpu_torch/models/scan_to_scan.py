"""Scan-to-scan ICP odometry — the `icp4radar` pipeline (PyTorch port of
`icp4dradar_tpu/models/scan_to_scan.py`).

Reference main loop (src/iterative_closest_point.cpp:263-721): Doppler
RANSAC fit + static/dynamic split + LSQ ego velocity per scan,
point-to-point ICP current -> last, right-composed pose
`currOdom = currOdom * T_icp` (:552).

`run_scan_to_scan` runs a stacked sequence in three frame-parallel phases:
preprocessing in frame chunks, ONE batched ICP over every frame pair (one
kernel launch per iteration for all pairs), then the tracking gate, the
suspect-pair motion hold and the pose chain as log-depth scans. A call
is the span `s2s.replay`, its phases `s2s.preprocess`, `s2s.icp`,
`s2s.gate` and `s2s.chain` (`utils/profiling.py`).

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
from typing import Optional, Tuple

import torch

from icp4dradar_tpu_torch.config import PipelineConfig
from icp4dradar_tpu_torch.geom.se3 import se3_from_rt
from icp4dradar_tpu_torch.io.scan import RadarScan
from icp4dradar_tpu_torch.preprocess.doppler import (
    draw_uniforms,
    fit_sine_ransac,
    lsq_ego_velocity,
    preprocess_frames,
    static_dynamic_split,
)
from icp4dradar_tpu_torch.registration.icp import icp_point_to_point
from icp4dradar_tpu_torch.utils.profiling import count, span


@dataclass(frozen=True)
class ScanToScanState:
    world_T: torch.Tensor     # (4,4) accumulated odometry (ref currOdom)
    frame: int
    last_delta: torch.Tensor  # (4,4) last ACCEPTED frame delta (motion hold)


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


def scan_to_scan_init(dtype=torch.float32, device="cuda") -> ScanToScanState:
    eye = torch.eye(4, dtype=dtype, device=device)
    return ScanToScanState(world_T=eye, frame=0, last_delta=eye)


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


def scan_to_scan_step(
    state: ScanToScanState,
    scan_curr: RadarScan,
    scan_prev: RadarScan,
    cfg: PipelineConfig = PipelineConfig(),
    use_doppler_prior: bool = False,
    use_static_points_only: bool = False,
    uniforms: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[ScanToScanState, ScanToScanOutput]:
    """One odometry step: preprocess both scans + ICP(current -> last) +
    pose compose. uniforms: (2, 2, H) RANSAC draws for [current, previous],
    or drawn from `generator` (one of the two is required)."""
    if uniforms is None:
        uniforms = draw_uniforms((2,), cfg.doppler.num_hypotheses, generator,
                                 scan_curr.device)
    fit_c = fit_sine_ransac(scan_curr, cfg.doppler, uniforms[0])
    static_c, _ = static_dynamic_split(scan_curr, fit_c, cfg.doppler)
    velocity, _ = lsq_ego_velocity(scan_curr, static_c)
    fit_p = fit_sine_ransac(scan_prev, cfg.doppler, uniforms[1])
    static_p, _ = static_dynamic_split(scan_prev, fit_p, cfg.doppler)

    src_mask = static_c if use_static_points_only else scan_curr.mask
    tgt_mask = static_p if use_static_points_only else scan_prev.mask
    init_T = _init_transform(velocity, use_doppler_prior)
    res = icp_point_to_point(scan_curr.xyz, scan_prev.xyz, src_mask, tgt_mask,
                             init_transform=init_T, cfg=cfg.icp)
    T_rel, accepted = _gate_relative(cfg, res.transform, init_T, res.fitness)
    # suspect-pair containment: hold the last ACCEPTED delta
    suspect_gate = float(cfg.tracking.s2s_suspect_fitness)
    if math.isfinite(suspect_gate):
        suspect = res.fitness > suspect_gate
        T_rel = torch.where(suspect, state.last_delta, T_rel)
        accepted = accepted & ~suspect
    last_delta = torch.where(accepted, T_rel, state.last_delta)
    world_T = state.world_T @ T_rel             # right-compose (ref :552)
    new_state = ScanToScanState(world_T=world_T, frame=state.frame + 1,
                                last_delta=last_delta)
    out = ScanToScanOutput(
        icp_transform=T_rel, world_T=world_T, velocity=velocity,
        fitness=res.fitness, sine_A=fit_c.A, sine_b=fit_c.b,
        num_static=torch.sum(static_c, dim=-1), converged=res.converged,
        accepted=accepted, iterations=res.iterations,
    )
    return new_state, out


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
    with span("s2s.replay", anchor=True):
        return _run_scan_to_scan(scans, cfg, uniforms, use_doppler_prior,
                                 use_static_points_only, generator)


def _run_scan_to_scan(scans, cfg, uniforms, use_doppler_prior, use_static_points_only,
                      generator):
    dev = scans.device

    # Phase 1: per-frame preprocessing, in frame chunks.
    with span("s2s.preprocess"):
        fits, statics, velocities = preprocess_frames(
            scans, _uniforms_for(scans, cfg, uniforms, generator), cfg.doppler)

    # Phase 2: every frame pair (k, k-1) in one batched ICP.
    def prev(x):
        return torch.cat([x[:1], x[:-1]])

    with span("s2s.icp"):
        src_mask = statics if use_static_points_only else scans.mask
        tgt_mask = prev(statics) if use_static_points_only else prev(scans.mask)
        init_T = _init_transform(velocities, use_doppler_prior)
        res = icp_point_to_point(scans.xyz, prev(scans.xyz), src_mask, tgt_mask,
                                 init_transform=init_T, cfg=cfg.icp)
    with span("s2s.gate"):
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
            count("host_syncs")             # the scalar is copied from the host
            ok[0] = True                                   # identity seed
            T_rel = torch.where(suspect[:, None, None], _hold_last_ok(T_rel, ok),
                                T_rel)
            accepted = accepted & ~suspect

    # Phase 3: pose accumulation T_k = T_0 ... T_k as a prefix product.
    with span("s2s.chain"):
        world_T = _prefix_products(T_rel)

    return ScanToScanOutput(
        icp_transform=T_rel, world_T=world_T, velocity=velocities,
        fitness=res.fitness, sine_A=fits.A, sine_b=fits.b,
        num_static=torch.sum(statics, dim=-1), converged=res.converged,
        accepted=accepted, iterations=res.iterations,
    )


def run_scan_to_scan_replay(
    scans: RadarScan,
    icp_transforms,
    cfg: PipelineConfig = PipelineConfig(),
    uniforms: Optional[torch.Tensor] = None,
    recorded_fitness=None,
    generator: Optional[torch.Generator] = None,
) -> ScanToScanOutput:
    """Re-drive the pipeline from RECORDED frame-to-frame transforms,
    skipping registration — the reference's USE_ICP_RESULT record/replay
    harness (src/iterative_closest_point.cpp:192-206, 523-540: per-frame
    4x4 + score read back from output_result.csv, ICP `align` bypassed,
    everything downstream re-runs).

    Preprocessing (Doppler fit / static split / LSQ velocity) still runs,
    on the same draws as `run_scan_to_scan` (`uniforms`, else `generator`,
    else a generator seeded with cfg.seed), so velocity.txt regenerates
    bit for bit; the transforms compose through the same prefix product
    BLINDLY (no tracking gate: replay reproduces the recorded trajectory,
    gated or not). No ICP runs.

    `icp_transforms`: (F,4,4) relative transforms (read_result_csv order).
    `recorded_fitness`: optional (F,) recorded scores to carry through."""
    F = scans.xyz.shape[0]
    dt, dev = scans.xyz.dtype, scans.device
    fits, statics, velocities = preprocess_frames(
        scans, _uniforms_for(scans, cfg, uniforms, generator), cfg.doppler)
    T_rel = torch.as_tensor(icp_transforms, dtype=dt).to(dev)
    fitness = (torch.zeros(F, dtype=dt, device=dev) if recorded_fitness is None
               else torch.as_tensor(recorded_fitness, dtype=dt).to(dev))
    true_f = torch.ones(F, dtype=torch.bool, device=dev)
    return ScanToScanOutput(
        icp_transform=T_rel, world_T=_prefix_products(T_rel), velocity=velocities,
        fitness=fitness, sine_A=fits.A, sine_b=fits.b,
        num_static=torch.sum(statics, dim=-1), converged=true_f, accepted=true_f,
        iterations=torch.zeros(F, dtype=torch.int32, device=dev),
    )
