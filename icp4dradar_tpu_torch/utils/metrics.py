"""Trajectory evaluation: ATE / RPE — the offline metrics the reference
delegates to external evo-style tooling (SURVEY.md §4: trajectory dumps at
src/iterative_closest_point.cpp:757-812 are its only eval path).

A numpy-only copy of `icp4dradar_tpu/utils/metrics.py`."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def align_umeyama(est: np.ndarray, gt: np.ndarray, with_scale: bool = False):
    """Least-squares similarity/rigid alignment est -> gt.

    est, gt: (F, 3) positions. Returns (s, R, t) with gt ~ s * R @ est + t.
    """
    mu_e = est.mean(0)
    mu_g = gt.mean(0)
    e = est - mu_e
    g = gt - mu_g
    H = e.T @ g / est.shape[0]
    U, D, Vt = np.linalg.svd(H)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = Vt.T @ S @ U.T
    if with_scale:
        var_e = (e ** 2).sum() / est.shape[0]
        s = float(np.trace(np.diag(D) @ S) / var_e)
    else:
        s = 1.0
    t = mu_g - s * R @ mu_e
    return s, R, t


def ate_rmse(
    est_positions: np.ndarray,
    gt_positions: np.ndarray,
    align: bool = True,
) -> float:
    """Absolute trajectory error RMSE [m] over (F, 3) position sequences."""
    est = np.asarray(est_positions, dtype=np.float64)
    gt = np.asarray(gt_positions, dtype=np.float64)
    assert est.shape == gt.shape
    if align:
        s, R, t = align_umeyama(est, gt)
        est = (s * (R @ est.T)).T + t
    err = np.linalg.norm(est - gt, axis=-1)
    return float(np.sqrt((err ** 2).mean()))


def rpe(
    est_poses: np.ndarray,
    gt_poses: np.ndarray,
    delta: int = 1,
) -> Tuple[float, float]:
    """Relative pose error over (F, 4, 4) pose sequences.

    Returns (trans_rmse [m], rot_rmse [rad]) over frame gaps of `delta`.
    """
    est = np.asarray(est_poses, dtype=np.float64)
    gt = np.asarray(gt_poses, dtype=np.float64)
    t_errs, r_errs = [], []
    for i in range(len(est) - delta):
        dE = np.linalg.inv(est[i]) @ est[i + delta]
        dG = np.linalg.inv(gt[i]) @ gt[i + delta]
        E = np.linalg.inv(dG) @ dE
        t_errs.append(np.linalg.norm(E[:3, 3]))
        cos_a = np.clip((np.trace(E[:3, :3]) - 1) / 2, -1, 1)
        r_errs.append(np.arccos(cos_a))
    return (
        float(np.sqrt(np.mean(np.square(t_errs)))),
        float(np.sqrt(np.mean(np.square(r_errs)))),
    )
