"""Structure factors: line/plane correspondences mined from the voxel
map's Gaussians, feeding the pose-graph back end (PyTorch port of
`icp4dradar_tpu/graph/structure_factors.py`).

The reference ships point-to-line and point-to-plane Ceres functors
(include/radarFactor.hpp:11-137) but no stage ever produces their
correspondences. Here the voxel-hash map's per-voxel Gaussian
(mapping/voxel_hash.py stat_n/stat_sum/stat_sq) classifies each cell by its
eigenvalue spectrum as a surfel (plane: lam0 << lam1), an edge (line: lam1
<< lam2) or a blob, and each keyframe point is matched to the Gaussian of
the voxel it lands in: one hash lookup per batch, no kNN. The
eigen-decompositions are the closed-form 3x3 forms (geom/linalg.py).

Factor weights are inverse residual variances: the Gaussian's own spread
along the factor's measurement direction (lam0 for a plane's normal, lam1
across a line) plus a sensor noise floor.
"""

from __future__ import annotations

from typing import Tuple

import torch

from icp4dradar_tpu_torch.config import StructureFactorConfig
from icp4dradar_tpu_torch.geom.linalg import (
    sym3x3_eigvals,
    sym3x3_largest_eigvec,
    sym3x3_smallest_eigvec,
)
from icp4dradar_tpu_torch.graph.gauss_newton import (
    LineFactors,
    PlaneFactors,
    PointFactors,
)
from icp4dradar_tpu_torch.mapping.voxel_hash import (
    VoxelHashMap,
    _voxel_coords,
    voxel_map_lookup_slots,
)


def unpack_cov(packed: torch.Tensor) -> torch.Tensor:
    """(..., 6) [xx,yy,zz,xy,xz,yz] -> (..., 3, 3) symmetric."""
    xx, yy, zz, xy, xz, yz = packed.unbind(-1)
    row0 = torch.stack([xx, xy, xz], dim=-1)
    row1 = torch.stack([xy, yy, yz], dim=-1)
    row2 = torch.stack([xz, yz, zz], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def classify_gaussians(
    cov: torch.Tensor,
    counts: torch.Tensor,
    cfg: StructureFactorConfig = StructureFactorConfig(),
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Eigen-classify (..., 3, 3) Gaussians into surfels and edges.

    Returns (is_plane, is_line, normal, direction, eigvals): normal is the
    smallest eigenvector (surfel normal), direction the largest (edge
    direction). Cells with fewer than min_voxel_points observations are
    neither (their spectrum is noise)."""
    lam = torch.clamp(sym3x3_eigvals(cov), min=0.0)          # (..., 3) ascending
    enough = counts >= cfg.min_voxel_points
    is_plane = enough & (lam[..., 0] < cfg.plane_ratio * lam[..., 1])
    is_line = enough & ~is_plane & (lam[..., 1] < cfg.line_ratio * lam[..., 2])
    normal = sym3x3_smallest_eigvec(cov)
    direction = sym3x3_largest_eigvec(cov)
    return is_plane, is_line, normal, direction, lam


def build_structure_factors(
    kf_index: torch.Tensor,
    p_body: torch.Tensor,
    p_world: torch.Tensor,
    mask: torch.Tensor,
    vmap: VoxelHashMap,
    cfg: StructureFactorConfig = StructureFactorConfig(),
) -> Tuple[PlaneFactors, LineFactors, PointFactors]:
    """Match keyframe points against map Gaussians and emit typed factors.

    kf_index (P,): keyframe id per point; p_body (P,3): the point in its
    keyframe's body frame; p_world (P,3): the same point under the current
    keyframe pose estimate (used only for the voxel association); mask
    (P,).

    Every point yields one row in EACH returned container, its class in the
    masks (fixed shapes, no compaction): plane cells -> PlaneFactors
    (normal + offset, radarFactor.hpp:105-137), edge cells -> LineFactors
    through mu +- h*dir (radarFactor.hpp:11-54), blob cells ->
    point-to-point against the Gaussian mean (radarFactor.hpp:140-171)."""
    slot, found = voxel_map_lookup_slots(vmap, _voxel_coords(p_world, vmap.voxel_size))
    slot = slot.long()
    n_raw = vmap.stat_n[slot]
    n = torch.clamp(n_raw, min=1.0)
    mu = vmap.stat_sum[slot] / n[:, None]
    ex2 = vmap.stat_sq[slot] / n[:, None]
    packed = torch.stack([
        ex2[:, 0] - mu[:, 0] * mu[:, 0],
        ex2[:, 1] - mu[:, 1] * mu[:, 1],
        ex2[:, 2] - mu[:, 2] * mu[:, 2],
        ex2[:, 3] - mu[:, 0] * mu[:, 1],
        ex2[:, 4] - mu[:, 0] * mu[:, 2],
        ex2[:, 5] - mu[:, 1] * mu[:, 2],
    ], dim=-1)
    is_plane, is_line, normal, direction, lam = classify_gaussians(
        unpack_cov(packed), n_raw, cfg)

    d2 = torch.sum((p_world - mu) ** 2, dim=-1)
    ok = (mask > 0.5) & found & (d2 < cfg.max_dist * cfg.max_dist)
    var0 = cfg.sigma0 * cfg.sigma0
    w_plane = cfg.weight_scale / (lam[..., 0] + var0)
    w_line = cfg.weight_scale / (lam[..., 1] + var0)
    w_point = cfg.weight_scale / (lam[..., 2] + var0)

    dt = p_body.dtype
    planes = PlaneFactors.build(
        kf_index, p_body, normal, -torch.sum(normal * mu, dim=-1),
        weight=w_plane, mask=(ok & is_plane).to(dt))
    h = 0.5 * vmap.voxel_size
    lines = LineFactors.build(
        kf_index, p_body, mu - h * direction, mu + h * direction,
        weight=w_line, mask=(ok & is_line).to(dt))
    points = PointFactors.build(
        kf_index, p_body, mu, weight=w_point,
        mask=(ok & ~is_plane & ~is_line).to(dt))
    return planes, lines, points
