"""The numbers that decide `correct`: gaps between what the timed path
produced and what the plain reference works out from the same inputs.
Each gap is the worst over every compared answer."""

from __future__ import annotations

import math

import torch


def translation_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest distance between the translations of two (..., 4, 4) pose
    stacks, in metres (inf if either is not finite)."""
    a, b = a.double(), b.double()
    if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
        return math.inf
    return float(torch.linalg.vector_norm(a[..., :3, 3] - b[..., :3, 3], dim=-1).max())


def rotation_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest angle of R_a^T R_b over two (..., 4, 4) pose stacks, in
    radians (inf if either is not finite)."""
    a, b = a.double(), b.double()
    if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
        return math.inf
    d = a[..., :3, :3].transpose(-1, -2) @ b[..., :3, :3]
    tr = d[..., 0, 0] + d[..., 1, 1] + d[..., 2, 2]
    # the angle from the skew part, exact near zero where acos of the
    # trace is not
    skew = torch.stack([d[..., 2, 1] - d[..., 1, 2], d[..., 0, 2] - d[..., 2, 0],
                        d[..., 1, 0] - d[..., 0, 1]], -1)
    ang = torch.atan2(0.5 * torch.linalg.vector_norm(skew, dim=-1), 0.5 * (tr - 1.0))
    return float(ang.abs().max())


def vector_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest Euclidean distance between the rows of two (..., k) stacks."""
    a, b = a.double(), b.double()
    if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
        return math.inf
    return float(torch.linalg.vector_norm(a - b, dim=-1).max())


def _inv_rigid(T: torch.Tensor) -> torch.Tensor:
    R, t = T[..., :3, :3], T[..., :3, 3:]
    out = torch.zeros_like(T)
    out[..., :3, :3] = R.transpose(-1, -2)
    out[..., :3, 3:] = -R.transpose(-1, -2) @ t
    out[..., 3, 3] = 1.0
    return out


def track_rpe(est: torch.Tensor, gt: torch.Tensor) -> float:
    """The tracks' accuracy against the ground truth, independent of any
    tracker: for each track of (..., F, 4, 4) world <- sensor poses, the
    root mean square over k of the translation of dE_k^-1 dG_k, where dE_k
    and dG_k are the estimated and the true motion from frame k to k + 1
    (the relative pose error at a gap of one frame, in metres); the worst
    track (inf if a pose is not finite)."""
    a, b = est.double(), gt.double()
    if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
        return math.inf
    dE = _inv_rigid(a[..., :-1, :, :]) @ a[..., 1:, :, :]
    dG = _inv_rigid(b[..., :-1, :, :]) @ b[..., 1:, :, :]
    err = torch.linalg.vector_norm((_inv_rigid(dE) @ dG)[..., :3, 3], dim=-1)
    return float(err.square().mean(-1).sqrt().max())


def check(name: str, value: float, limit: float) -> dict:
    return {"name": name, "value": value, "limit": limit}


def all_pass(checks) -> bool:
    return bool(checks) and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                                for c in checks)
