"""Doppler sine-model RANSAC, static/dynamic split, LSQ ego-velocity
(PyTorch port of `icp4dradar_tpu/preprocess/doppler.py`).

Rebuild of the reference's scan preprocessing
(src/iterative_closest_point.cpp:85-128 `fitSineRansac`, :391-407 split,
:410-431 LSQ): a fixed batch of H 2-point hypotheses is formed and scored in
one (H, N) broadcast. Every function batches over leading (frame) axes.

Model (ref :84): v_r * cos(beta) = A * cos(alpha + b).

RANSAC draws. The JAX package draws `jax.random.uniform` per frame and
inverts a validity cumsum (`doppler.py:36-48`); torch cannot reproduce those
bits. So the hypothesis draws are an explicit `uniforms` tensor of shape
(..., 2, H): parity tests pass JAX's own draws, and production draws them
from a seeded `torch.Generator`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from icp4dradar_tpu_torch.config import DopplerRansacConfig
from icp4dradar_tpu_torch.geom.linalg import solve3x3
from icp4dradar_tpu_torch.io.scan import RadarScan
from icp4dradar_tpu_torch.utils.profiling import span

# Frames preprocessed together by `preprocess_frames`. The hypothesis
# scoring tile is (frames, H, N) f32 and several such temporaries coexist in
# eager torch: at H = 256, N = 2048 one tile of 128 frames is 268 MB, where
# the whole 1024-frame sequence would be 2.1 GB per temporary.
FRAME_CHUNK = 128


@dataclass(frozen=True)
class SineFit:
    """Best-fit Doppler sine model (leading axes as the scan's)."""

    A: torch.Tensor        # amplitude
    b: torch.Tensor        # phase [rad]
    inliers: torch.Tensor  # best inlier count
    valid: torch.Tensor    # bool — enough valid points to fit


def draw_uniforms(batch_shape, num_hypotheses: int, generator: torch.Generator,
                  device=None) -> torch.Tensor:
    """(*batch_shape, 2, H) uniforms in [0, 1) for the two hypothesis points,
    from an explicit generator (never torch's global one)."""
    if generator is None:
        raise ValueError("RANSAC draws need `uniforms` or a seeded torch.Generator")
    return torch.rand(tuple(batch_shape) + (2, num_hypotheses),
                      generator=generator, device=device, dtype=torch.float32)


def _sample_valid_indices(mask: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """(..., H) indices of valid slots by inverse CDF: for each uniform, the
    number of cumsum entries <= u * n_valid (JAX `doppler.py:45-48`), found
    by a binary search instead of an (H, N) compare."""
    c = torch.cumsum((mask > 0.5).to(torch.float32), dim=-1)
    x = u * c[..., -1:]
    idx = torch.searchsorted(c.contiguous(), x.contiguous(), right=True)
    return torch.clamp(idx, 0, mask.shape[-1] - 1)


def _nonzero(x: torch.Tensor) -> torch.Tensor:
    """x, with |x| < 1e-12 replaced by +1e-12 (JAX's division guards)."""
    return torch.where(torch.abs(x) < 1e-12, 1e-12, x)


def sine_residuals(scan: RadarScan, A, b) -> torch.Tensor:
    """delta_j = v_j cos(beta_j) - A cos(alpha_j + b)  (ref :114, :394)."""
    return (scan.doppler * torch.cos(scan.elevation)
            - A[..., None] * torch.cos(scan.azimuth + b[..., None]))


def fit_sine_ransac(
    scan: RadarScan,
    cfg: DopplerRansacConfig = DopplerRansacConfig(),
    uniforms: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> SineFit:
    """Batched 2-point RANSAC fit of v_r cos(beta) = A cos(alpha + b), then
    `cfg.refine_iters` IRLS polish rounds on the inlier set.

    uniforms: (..., 2, H) draws for the two hypothesis points; drawn from
    `generator` when None (one of the two is required)."""
    H = cfg.num_hypotheses
    mask = scan.mask
    if uniforms is None:
        uniforms = draw_uniforms(mask.shape[:-1], H, generator, mask.device)
    i1 = _sample_valid_indices(mask, uniforms[..., 0, :])
    i2 = _sample_valid_indices(mask, uniforms[..., 1, :])

    alpha = scan.azimuth
    vr_ce = scan.doppler * torch.cos(scan.elevation)  # v_r cos(beta)
    ca = torch.cos(alpha)
    sa = torch.sin(alpha)

    def take(x, i):
        return torch.gather(x, -1, i)

    y1, y2 = take(vr_ce, i1), take(vr_ce, i2)
    k = y1 / _nonzero(y2)
    denom = take(sa, i1) - k * take(sa, i2)
    b = torch.atan((take(ca, i1) - k * take(ca, i2)) / _nonzero(denom))
    A = y1 / _nonzero(torch.cos(take(alpha, i1) + b))

    # Score all H hypotheses against all N points in one broadcast:
    # A cos(a+b) = (A cos b) cos a - (A sin b) sin a.
    u = A * torch.cos(b)
    w_c = A * torch.sin(b)
    delta = vr_ce[..., None, :] - (u[..., :, None] * ca[..., None, :]
                                   - w_c[..., :, None] * sa[..., None, :])
    score = torch.sum((torch.abs(delta) < cfg.inlier_sigma) * mask[..., None, :],
                      dim=-1)
    del delta
    finite = torch.isfinite(A) & torch.isfinite(b)
    score = torch.where(finite, score, -1.0)
    # integer scores tie often: torch.argmax, like jnp.argmax, takes the
    # first maximum
    best = torch.argmax(score, dim=-1, keepdim=True)
    A_best = take(A, best)[..., 0]
    b_best = take(b, best)[..., 0]

    for _ in range(cfg.refine_iters):
        # A cos(a+b) = u cos a + w sin a is linear in (u, w): refit on the
        # current inlier set with a closed-form 2x2 solve
        inl = torch.abs(vr_ce - A_best[..., None]
                        * torch.cos(alpha + b_best[..., None])) < cfg.inlier_sigma
        w_m = inl * mask
        x0 = torch.cos(alpha) * w_m
        x1 = torch.sin(alpha) * w_m
        y = vr_ce * w_m
        g00 = torch.sum(x0 * x0, dim=-1) + 1e-9
        g01 = torch.sum(x0 * x1, dim=-1)
        g11 = torch.sum(x1 * x1, dim=-1) + 1e-9
        xy0 = torch.sum(x0 * y, dim=-1)
        xy1 = torch.sum(x1 * y, dim=-1)
        det = g00 * g11 - g01 * g01
        ok = torch.abs(det) > 1e-30
        inv_det = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
        uw0 = inv_det * (g11 * xy0 - g01 * xy1)
        uw1 = inv_det * (g00 * xy1 - g01 * xy0)
        A_best = torch.sqrt(uw0 ** 2 + uw1 ** 2)
        b_best = torch.atan2(-uw1, uw0)

    inliers = torch.sum(
        (torch.abs(vr_ce - A_best[..., None] * torch.cos(alpha + b_best[..., None]))
         < cfg.inlier_sigma) * mask, dim=-1)
    return SineFit(A=A_best, b=b_best, inliers=inliers,
                   valid=torch.sum(mask, dim=-1) >= 2)


def static_dynamic_split(
    scan: RadarScan,
    fit: SineFit,
    cfg: DopplerRansacConfig = DopplerRansacConfig(),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(static_mask, dynamic_mask), both (..., N) in {0,1} and AND'd with
    validity. The reference's split is one-sided: delta > 0.2 -> dynamic
    (src/iterative_closest_point.cpp:394-403); `two_sided_split` rejects
    |delta| > thresh instead."""
    delta = sine_residuals(scan, fit.A, fit.b)
    if cfg.two_sided_split:
        dynamic = torch.abs(delta) > cfg.static_threshold
    else:
        dynamic = delta > cfg.static_threshold
    valid = scan.mask > 0.5
    dynamic = dynamic & valid
    static = (~dynamic) & valid
    return static.to(scan.mask.dtype), dynamic.to(scan.mask.dtype)


def lsq_ego_velocity(
    scan: RadarScan, static_mask: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """3-DoF ego velocity V = (K^T K)^-1 K^T v_r over static points; K rows
    are the unit point directions (ref :412-429). Returns (V (..., 3),
    KtK (..., 3, 3))."""
    K = scan.direction * static_mask[..., None]
    vr = scan.doppler * static_mask
    KtK = torch.einsum("...ni,...nj->...ij", K, K) + 1e-6 * torch.eye(
        3, dtype=K.dtype, device=K.device)
    Ktv = torch.einsum("...ni,...n->...i", K, vr)
    return solve3x3(KtK, Ktv), KtK


def preprocess_scan(
    scan: RadarScan,
    cfg: DopplerRansacConfig = DopplerRansacConfig(),
    uniforms: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
):
    """Full reference preprocessing: RANSAC fit -> split -> LSQ velocity.
    Returns (fit, static_mask, dynamic_mask, velocity)."""
    fit = fit_sine_ransac(scan, cfg, uniforms, generator)
    static_mask, dynamic_mask = static_dynamic_split(scan, fit, cfg)
    velocity, _ = lsq_ego_velocity(scan, static_mask)
    return fit, static_mask, dynamic_mask, velocity


def preprocess_frames(
    scans: RadarScan,
    uniforms: torch.Tensor,
    cfg: DopplerRansacConfig = DopplerRansacConfig(),
    chunk: int = FRAME_CHUNK,
):
    """`preprocess_scan` over a stacked (F, N) sequence, `chunk` frames at a
    time. uniforms: (F, 2, H). Returns (fit, static_mask, velocity) stacked
    over F. Each chunk is a span `doppler.chunk`."""
    parts = []
    for s in range(0, scans.xyz.shape[0], chunk):
        with span("doppler.chunk"):
            fit, static, _, velocity = preprocess_scan(
                scans[s:s + chunk], cfg, uniforms[s:s + chunk])
        parts.append((fit, static, velocity))
    fits = SineFit(*(torch.cat([getattr(p[0], f) for p in parts])
                     for f in ("A", "b", "inliers", "valid")))
    return (fits, torch.cat([p[1] for p in parts]),
            torch.cat([p[2] for p in parts]))
