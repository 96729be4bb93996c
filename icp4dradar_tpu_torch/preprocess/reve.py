"""REVE-style radar ego-velocity estimation with inlier extraction (PyTorch
port of `icp4dradar_tpu/preprocess/reve.py`).

Rebuild of the external `reve::RadarEgoVelocityEstimator` the reference
depends on (configured src/radar_odometry.cpp:574-611, invoked :328):
quality gates -> zero-velocity detection -> batched 3-point RANSAC -> masked
LSQ refit with sigma/conditioning gates. Every function batches over
leading (frame) axes; the returned inlier mask is the filtered scan handed
to scan-to-map registration (src/radar_odometry.cpp:328-342).

RANSAC draws. The JAX package draws `jax.random.uniform(key, (3H,))` per
scan (`reve.py:76`), H = 4 * ransac_iterations; torch cannot reproduce
those bits, so the draws are an explicit `uniforms` tensor (..., 3H): parity
tests pass JAX's own draws, production draws them from a seeded
`torch.Generator` (`draw_reve_uniforms`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from icp4dradar_tpu_torch.config import ReveConfig
from icp4dradar_tpu_torch.geom.linalg import (
    condition_number,
    inv3x3,
    pairwise_sum,
    small_matmul,
)
from icp4dradar_tpu_torch.io.scan import RadarScan
from icp4dradar_tpu_torch.utils.profiling import count


@dataclass(frozen=True)
class EgoVelocityEstimate:
    velocity: torch.Tensor       # (..., 3) body-frame ego velocity
    sigma: torch.Tensor          # (..., 3) per-axis std estimate
    inlier_mask: torch.Tensor    # (..., N) {0,1}: the filtered scan
    valid: torch.Tensor          # (...) bool: gates passed
    zero_velocity: torch.Tensor  # (...) bool: zero-velocity branch taken


def reve_hypotheses(cfg: ReveConfig) -> int:
    """H, the fixed RANSAC batch: 4 x the trial-formula count
    (`reve.py:74`); the draws are (..., 3H)."""
    return cfg.ransac_iterations * 4


def draw_reve_uniforms(batch_shape, cfg: ReveConfig, generator: torch.Generator,
                       device=None) -> torch.Tensor:
    """(*batch_shape, 3H) uniforms in [0, 1) from an explicit generator."""
    if generator is None:
        raise ValueError("REVE draws need `uniforms` or a seeded torch.Generator")
    return torch.rand(tuple(batch_shape) + (3 * reve_hypotheses(cfg),),
                      generator=generator, device=device, dtype=torch.float32)


def _quality_gates(scan: RadarScan, cfg: ReveConfig) -> torch.Tensor:
    """Per-point admission gates (ref config :576-583)."""
    deg = math.pi / 180.0
    rng = scan.range
    z = scan.xyz[..., 2]
    return ((scan.mask > 0.5) & (rng > cfg.min_dist) & (rng < cfg.max_dist)
            & (scan.intensity > cfg.min_db)
            & (torch.abs(scan.azimuth) < cfg.azimuth_thresh_deg * deg)
            & (torch.abs(scan.elevation) < cfg.elevation_thresh_deg * deg)
            & (z > cfg.filter_min_z) & (z < cfg.filter_max_z))


def _masked_median_abs(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median of |x| over masked entries: the (n // 2)-th of the sorted
    values with +inf pads, inf when nothing is masked in."""
    vals = torch.sort(torch.where(mask, torch.abs(x), math.inf), dim=-1).values
    n = torch.sum(mask, dim=-1)
    idx = torch.clamp(n // 2, 0, x.shape[-1] - 1)
    med = torch.gather(vals, -1, idx[..., None])[..., 0]
    return torch.where(n > 0, med, math.inf)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def estimate_ego_velocity(
    scan: RadarScan,
    uniforms: torch.Tensor,
    cfg: ReveConfig = ReveConfig(),
) -> EgoVelocityEstimate:
    """Estimate 3-DoF ego velocity and extract the inlier (static) scan.
    scan: (..., N) fields; uniforms: (..., 3H) RANSAC draws."""
    gated = _quality_gates(scan, cfg)
    gated_f = gated.to(scan.mask.dtype)
    d = scan.direction                                   # (..., N, 3)
    vr = scan.doppler * cfg.doppler_velocity_correction_factor
    N = vr.shape[-1]
    batch = vr.shape[:-1]

    # ---- zero-velocity detection (ref thresh_zero_velocity=0.05) ----
    is_zero = _masked_median_abs(vr, gated) < cfg.thresh_zero_velocity

    # ---- batched 3-point RANSAC: inverse-CDF picks, Cramer solves ----
    H = reve_hypotheses(cfg)
    if uniforms.shape != batch + (3 * H,):
        raise ValueError(f"uniforms has shape {tuple(uniforms.shape)}, "
                         f"expected {tuple(batch) + (3 * H,)}")
    c = torch.cumsum(gated.to(torch.float32), dim=-1)
    u = uniforms * c[..., -1:]
    # number of cumsum entries <= u (JAX counts them with an (3H, N) compare)
    picks = torch.clamp(torch.searchsorted(c.contiguous(), u.contiguous(),
                                           right=True), 0, N - 1)
    payload = torch.cat([d, vr[..., None]], dim=-1)      # (..., N, 4)
    payload = torch.gather(payload, -2, picks[..., None].expand(batch + (3 * H, 4)))
    D = payload[..., :3].reshape(batch + (H, 3, 3))
    y = payload[..., 3].reshape(batch + (H, 3))
    r0, r1, r2 = D[..., 0, :], D[..., 1, :], D[..., 2, :]
    cross12 = _cross(r1, r2)
    det = torch.sum(r0 * cross12, dim=-1)
    ok_det = torch.abs(det) > 1e-12
    inv_det = torch.where(ok_det, 1.0 / torch.where(ok_det, det, 1.0), 0.0)
    v_hyp = (y[..., 0:1] * cross12 + y[..., 1:2] * _cross(r2, r0)
             + y[..., 2:3] * _cross(r0, r1)) * inv_det[..., None]   # (..., H, 3)
    v_hyp = torch.nan_to_num(v_hyp, nan=0.0, posinf=0.0, neginf=0.0)
    resid = torch.abs(small_matmul(d, v_hyp.transpose(-1, -2)) - vr[..., None])  # (..., N, H)
    inl = (resid < cfg.inlier_thresh) & gated[..., None]
    del resid
    counts = torch.sum(inl, dim=-2)                       # (..., H)
    # torch.argmax, like jnp.argmax, returns the first maximum
    best = torch.argmax(counts, dim=-1)
    inlier_mask = torch.gather(inl, -1, best[..., None, None].expand(batch + (N, 1)))[..., 0]

    # ---- LSQ refit on inliers ----
    w = inlier_mask.to(scan.mask.dtype)
    K = d * w[..., None]
    eye = torch.eye(3, dtype=K.dtype, device=K.device)
    # K^T K and K^T v over the N points as pairwise sums of elementwise
    # products, and K v elementwise: a matrix product's rounding may depend
    # on the batch (its kernel's choice), so a frame's estimate would
    # depend on the frames estimated beside it
    sums = pairwise_sum(torch.cat([(K[..., :, None] * K[..., None, :]).flatten(-2),
                                   K * (vr * w)[..., None]], dim=-1), dim=-2)
    KtK = sums[..., :9].unflatten(-1, (3, 3)) + 1e-9 * eye
    KtK_inv = inv3x3(KtK)
    v_fit = small_matmul(KtK_inv, sums[..., 9:, None])[..., 0]
    r = (d[..., 0] * v_fit[..., 0, None] + d[..., 1] * v_fit[..., 1, None]
         + d[..., 2] * v_fit[..., 2, None] - vr) * w
    n_in = torch.clamp(torch.sum(w, dim=-1), min=1.0)
    s2 = pairwise_sum(r * r) / torch.clamp(n_in - 3.0, min=1.0)
    cov = s2[..., None, None] * KtK_inv
    sigma = torch.sqrt(torch.clamp(torch.diagonal(cov, dim1=-2, dim2=-1), min=0.0))

    # ---- acceptance gates (ref max_sigma_*, max_r_cond, outlier pct) ----
    n_gated = torch.clamp(torch.sum(gated_f, dim=-1), min=1.0)
    outlier_pct = 1.0 - n_in / n_gated
    # two copies from the host below: on a card, each waits for the stream
    count("host_syncs", 2)
    max_sigma = torch.tensor([cfg.max_sigma_x, cfg.max_sigma_y, cfg.max_sigma_z],
                             dtype=sigma.dtype, device=sigma.device)
    ok = (torch.all(sigma < max_sigma, dim=-1)
          & (condition_number(KtK) < cfg.max_r_cond) & (n_in >= 3)
          & (outlier_pct <= cfg.allowed_outlier_percentage))

    # ---- zero-velocity branch overrides ----
    sigma_zero = torch.tensor(
        [cfg.sigma_zero_velocity_x, cfg.sigma_zero_velocity_y,
         cfg.sigma_zero_velocity_z], dtype=sigma.dtype, device=sigma.device)
    velocity = torch.where(is_zero[..., None], 0.0, v_fit)
    sigma = torch.where(is_zero[..., None], sigma_zero, sigma)
    # zero-velocity scans keep all low-Doppler gated points as inliers
    zero_inliers = gated & (torch.abs(vr) < cfg.thresh_zero_velocity * 2.0)
    inlier_mask = torch.where(is_zero[..., None], zero_inliers, inlier_mask)
    return EgoVelocityEstimate(
        velocity=velocity, sigma=sigma,
        inlier_mask=inlier_mask.to(scan.mask.dtype),
        valid=is_zero | ok, zero_velocity=is_zero,
    )
