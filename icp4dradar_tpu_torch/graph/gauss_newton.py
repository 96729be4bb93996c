"""Batched SE(3) pose-graph Gauss-Newton (PyTorch port of
`icp4dradar_tpu/graph/gauss_newton.py`).

What the reference links Ceres for but never runs (CMakeLists.txt:49,
include/radarFactor.hpp): a keyframe graph over odometry chains and loop
closures, solved as dense-block normal equations.

K keyframe poses; the unknowns are RIGHT-multiplied (body-frame) twists
xi in R^{K x 6} (T_k <- T_k exp(xi_k)): Jacobian translation arms stay at
relative-transform scale instead of world-position scale, which keeps the
block-tridiagonal factorisation of `block_solver.py` usable in float32.

Factors (plain dataclasses of tensors, the JAX containers' fields):
- RelPoseFactors: SE(3) between-factors (i, j, T_meas, weight, mask)
- PointFactors, LineFactors, PlaneFactors, Plane3Factors: factors binding
  one keyframe each (point-to-point, -line, -plane through a normal and an
  offset, -plane through three points).

Per-factor Jacobians come from `torch.func.jacfwd` at xi = 0 (forward-mode
autodiff through the port's residual functions, as JAX's
`jax.vmap(jax.jacfwd(...))`), all factors of a type in one batched pass;
blocks scatter-add (`index_put_(accumulate=True)`) into the dense
(6K, 6K) H. The gauge is
pinned with a prior on pose 0; Huber weights damp outlier closures.
`optimize_pose_graph` runs the GN loop on the host: one host sync an
iteration, its convergence test.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
from torch.func import jacfwd

from icp4dradar_tpu_torch.config import PoseGraphConfig
from icp4dradar_tpu_torch.geom.linalg import small_matmul
from icp4dradar_tpu_torch.geom.se3 import se3_exp
from icp4dradar_tpu_torch.graph.factors import (
    point_to_line_residual,
    point_to_plane_norm_residual,
    point_to_plane_residual,
    point_to_point_residual,
    relative_pose_residual,
)


class _Tensors:
    """`replace` for a dataclass of tensors, as the JAX containers have."""

    def replace(self, **fields):
        return dataclasses.replace(self, **fields)


def _device_of(*xs, device=None):
    """`device`, else the device of the first tensor among xs, else the
    card (the port's entry points run on the card unless asked)."""
    if device is not None:
        return torch.device(device)
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return torch.device("cuda")


def _index(x, dev):
    return torch.as_tensor(x, device=dev).to(torch.int64)


def _float(x, dev):
    x = torch.as_tensor(x, device=dev)
    return x if x.is_floating_point() else x.to(torch.float32)


def _weight_mask(weight, mask, n, dt, dev):
    weight = torch.ones(n, dtype=dt, device=dev) if weight is None else _float(weight, dev)
    mask = torch.ones(n, dtype=dt, device=dev) if mask is None else _float(mask, dev)
    return weight, mask


@dataclass
class RelPoseFactors(_Tensors):
    """Between-factors (F,): i -> j measured transforms."""

    i: torch.Tensor        # (F,) int64
    j: torch.Tensor        # (F,) int64
    T_meas: torch.Tensor   # (F,4,4)
    weight: torch.Tensor   # (F,) scalar information weight
    mask: torch.Tensor     # (F,) {0,1}

    @classmethod
    def build(cls, i, j, T_meas, weight=None, mask=None, device=None):
        dev = _device_of(T_meas, i, device=device)
        T_meas = _float(T_meas, dev)
        i = _index(i, dev)
        weight, mask = _weight_mask(weight, mask, i.shape[0], T_meas.dtype, dev)
        return cls(i=i, j=_index(j, dev), T_meas=T_meas, weight=weight, mask=mask)


@dataclass
class PointFactors(_Tensors):
    """World point-to-point factors (P,): body point p under pose k should
    land on world point q (the reference's LidarDistanceFactor)."""

    k: torch.Tensor        # (P,) int64 keyframe index
    p_body: torch.Tensor   # (P,3)
    q_world: torch.Tensor  # (P,3)
    weight: torch.Tensor   # (P,)
    mask: torch.Tensor     # (P,)

    @classmethod
    def build(cls, k, p_body, q_world, weight=None, mask=None, device=None):
        dev = _device_of(p_body, k, device=device)
        p_body = _float(p_body, dev)
        k = _index(k, dev)
        weight, mask = _weight_mask(weight, mask, k.shape[0], p_body.dtype, dev)
        return cls(k=k, p_body=p_body, q_world=_float(q_world, dev), weight=weight,
                   mask=mask)


@dataclass
class LineFactors(_Tensors):
    """Point-to-line factors (P,): body point p under pose k should fall on
    the world line through (a, b) — the reference's RadarEdgeFactor
    (include/radarFactor.hpp:11-54)."""

    k: torch.Tensor        # (P,) int64 keyframe index
    p_body: torch.Tensor   # (P,3)
    line_a: torch.Tensor   # (P,3)
    line_b: torch.Tensor   # (P,3)
    weight: torch.Tensor   # (P,)
    mask: torch.Tensor     # (P,)

    @classmethod
    def build(cls, k, p_body, line_a, line_b, weight=None, mask=None, device=None):
        dev = _device_of(p_body, k, device=device)
        p_body = _float(p_body, dev)
        k = _index(k, dev)
        weight, mask = _weight_mask(weight, mask, k.shape[0], p_body.dtype, dev)
        return cls(k=k, p_body=p_body, line_a=_float(line_a, dev),
                   line_b=_float(line_b, dev), weight=weight, mask=mask)


@dataclass
class PlaneFactors(_Tensors):
    """Point-to-plane factors with a unit normal and an offset — the
    reference's LidarPlaneNormFactor (include/radarFactor.hpp:105-137):
    residual n . (T p) + d."""

    k: torch.Tensor        # (P,) int64 keyframe index
    p_body: torch.Tensor   # (P,3)
    normal: torch.Tensor   # (P,3) unit plane normal (world)
    offset: torch.Tensor   # (P,) negative_OA_dot_norm
    weight: torch.Tensor   # (P,)
    mask: torch.Tensor     # (P,)

    @classmethod
    def build(cls, k, p_body, normal, offset, weight=None, mask=None, device=None):
        dev = _device_of(p_body, k, device=device)
        p_body = _float(p_body, dev)
        k = _index(k, dev)
        weight, mask = _weight_mask(weight, mask, k.shape[0], p_body.dtype, dev)
        return cls(k=k, p_body=p_body, normal=_float(normal, dev),
                   offset=_float(offset, dev), weight=weight, mask=mask)


@dataclass
class Plane3Factors(_Tensors):
    """Point-to-plane factors through three world points — the reference's
    LidarPlaneFactor (include/radarFactor.hpp:56-103): signed distance of
    T p to the plane spanned by (j, l, m)."""

    k: torch.Tensor        # (P,) int64 keyframe index
    p_body: torch.Tensor   # (P,3)
    plane_j: torch.Tensor  # (P,3)
    plane_l: torch.Tensor  # (P,3)
    plane_m: torch.Tensor  # (P,3)
    weight: torch.Tensor   # (P,)
    mask: torch.Tensor     # (P,)

    @classmethod
    def build(cls, k, p_body, plane_j, plane_l, plane_m, weight=None, mask=None,
              device=None):
        dev = _device_of(p_body, k, device=device)
        p_body = _float(p_body, dev)
        k = _index(k, dev)
        weight, mask = _weight_mask(weight, mask, k.shape[0], p_body.dtype, dev)
        return cls(k=k, p_body=p_body, plane_j=_float(plane_j, dev),
                   plane_l=_float(plane_l, dev), plane_m=_float(plane_m, dev),
                   weight=weight, mask=mask)


@dataclass
class PoseGraph(_Tensors):
    poses: torch.Tensor                     # (K,4,4)
    rel: Optional[RelPoseFactors] = None
    points: Optional[PointFactors] = None
    lines: Optional[LineFactors] = None
    planes: Optional[PlaneFactors] = None
    planes3: Optional[Plane3Factors] = None


def _huber_weight(r2: torch.Tensor, delta: float) -> torch.Tensor:
    """IRLS weight for the Huber loss on residual norm sqrt(r2)."""
    r = torch.sqrt(torch.clamp(r2, min=1e-20))
    return torch.where(r <= delta, torch.ones_like(r), delta / r)


def _right_perturbed(T: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """T exp(xi) for T (P, 4, 4) and one twist xi (6,) shared by the P
    poses."""
    return small_matmul(T, se3_exp(xi.expand(T.shape[0], 6)))


def _single_pose_linearize(poses, res_fn, k, payload):
    """Residuals r0 (P, D) and Jacobians J (P, D, 6) at xi = 0 of factors
    binding ONE pose each: res_fn(T, *payload) -> (P, D) around poses[k].
    One `jacfwd` pass (the residuals as its aux output) over a twist shared
    by all P factors: factor p depends on it through its own pose alone, so
    column i of its Jacobian is d r_p / d xi_p,i, which the JAX package
    takes per factor under `jax.vmap(jax.jacfwd(...))`."""
    Tk = poses[k]

    def f(xi):
        r = res_fn(_right_perturbed(Tk, xi), *payload)
        return r, r

    J, r0 = jacfwd(f, has_aux=True)(torch.zeros(6, dtype=poses.dtype, device=poses.device))
    return r0, J


def _single_pose_blocks(poses, res_fn, k, payload, weight, mask, huber_delta):
    """Shared GN linearisation for factors binding ONE pose each: returns
    per-factor (Hkk (P,6,6), gk (P,6), cost ()) at xi = 0 around
    poses[k], with Huber-IRLS weights."""
    P, dt, dev = k.shape[0], poses.dtype, poses.device
    if P == 0:
        return (torch.zeros((0, 6, 6), dtype=dt, device=dev),
                torch.zeros((0, 6), dtype=dt, device=dev),
                torch.zeros((), dtype=dt, device=dev))
    r0, J = _single_pose_linearize(poses, res_fn, k, payload)
    r2 = torch.sum(r0 * r0, dim=-1)
    w = weight * mask * _huber_weight(r2, huber_delta)
    cost = torch.sum(w * r2)
    JW = J * w[:, None, None]
    Hkk = torch.einsum("pri,prj->pij", JW, J)
    gk = torch.einsum("pri,pr->pi", JW, r0)
    return Hkk, gk, cost


def _rel_linearize(poses, rel: RelPoseFactors, huber_delta: float):
    """GN linearisation of between-factors at xi = 0: returns
    (r0 (F,6), Ji (F,6,6), Jj (F,6,6), w (F,), cost ()) with the Huber-IRLS
    weights folded into w; both Jacobians from one `jacfwd` pass. Shared by
    the dense and block-sparse assemblies."""
    F, dt, dev = rel.i.shape[0], poses.dtype, poses.device
    if F == 0:
        z = torch.zeros((0, 6, 6), dtype=dt, device=dev)
        return (torch.zeros((0, 6), dtype=dt, device=dev), z, z,
                torch.zeros((0,), dtype=dt, device=dev), torch.zeros((), dtype=dt, device=dev))
    Ti, Tj = poses[rel.i], poses[rel.j]

    def f(xi_i, xi_j):
        r = relative_pose_residual(_right_perturbed(Ti, xi_i), _right_perturbed(Tj, xi_j),
                                   rel.T_meas)
        return r, r

    zero = torch.zeros(6, dtype=dt, device=dev)
    (Ji, Jj), r0 = jacfwd(f, argnums=(0, 1), has_aux=True)(zero, zero)
    r2 = torch.sum(r0 * r0, dim=-1)
    w = rel.weight * rel.mask * _huber_weight(r2, huber_delta)
    cost = torch.sum(w * r2)
    return r0, Ji, Jj, w, cost


def _iter_single_pose_factors(graph: PoseGraph):
    """Yield (factors, res_fn, payload) for every populated single-pose
    factor container — the one place that knows each type's residual
    signature."""
    if graph.points is not None:
        pf = graph.points
        yield pf, point_to_point_residual, (pf.p_body, pf.q_world)
    if graph.lines is not None:
        lf = graph.lines
        yield lf, point_to_line_residual, (lf.p_body, lf.line_a, lf.line_b)
    if graph.planes is not None:
        nf = graph.planes
        yield nf, point_to_plane_norm_residual, (nf.p_body, nf.normal, nf.offset)
    if graph.planes3 is not None:
        p3 = graph.planes3
        yield p3, point_to_plane_residual, (p3.p_body, p3.plane_j, p3.plane_l,
                                            p3.plane_m)


def pose_graph_normal_equations(
    graph: PoseGraph,
    cfg: PoseGraphConfig = PoseGraphConfig(),
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Assemble (H (6K,6K), g (6K,), cost ()) at the current linearisation.

    GN normal equations for r(xi) ~ r0 + J xi: H = J^T W J, g = J^T W r0;
    the solver applies xi = -H^-1 g. The (i, j) blocks accumulate in a
    (K, K, 6, 6) tensor, one `index_put_(accumulate=True)` per block
    kind."""
    poses = graph.poses
    K, dt, dev = poses.shape[0], poses.dtype, poses.device
    Hb = torch.zeros((K, K, 6, 6), dtype=dt, device=dev)
    g = torch.zeros((K, 6), dtype=dt, device=dev)
    cost = torch.zeros((), dtype=dt, device=dev)

    if graph.rel is not None:
        rel = graph.rel
        r0, Ji, Jj, w, c = _rel_linearize(poses, rel, cfg.huber_delta)
        cost = cost + c
        JiW = Ji * w[:, None, None]
        JjW = Jj * w[:, None, None]
        Hij = torch.einsum("fri,frj->fij", JiW, Jj)
        Hii = torch.einsum("fri,frj->fij", JiW, Ji)
        Hjj = torch.einsum("fri,frj->fij", JjW, Jj)
        Hb.index_put_((rel.i, rel.i), Hii, accumulate=True)
        Hb.index_put_((rel.i, rel.j), Hij, accumulate=True)
        Hb.index_put_((rel.j, rel.i), Hij.transpose(-1, -2), accumulate=True)
        Hb.index_put_((rel.j, rel.j), Hjj, accumulate=True)
        g.index_put_((rel.i,), torch.einsum("fri,fr->fi", JiW, r0), accumulate=True)
        g.index_put_((rel.j,), torch.einsum("fri,fr->fi", JjW, r0), accumulate=True)

    for fac, res_fn, payload in _iter_single_pose_factors(graph):
        Hkk, gk, c = _single_pose_blocks(poses, res_fn, fac.k, payload, fac.weight,
                                         fac.mask, cfg.huber_delta)
        cost = cost + c
        Hb.index_put_((fac.k, fac.k), Hkk, accumulate=True)
        g.index_put_((fac.k,), gk, accumulate=True)

    H = Hb.permute(0, 2, 1, 3).reshape(6 * K, 6 * K)
    return H, g.reshape(-1), cost


def _apply_twists(poses: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    return small_matmul(poses, se3_exp(xi))


def solve_pose_graph_step(
    graph: PoseGraph,
    H: torch.Tensor,
    g: torch.Tensor,
    cfg: PoseGraphConfig = PoseGraphConfig(),
    gauge_weight: float = 1e6,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Solve the damped system with the pose-0 gauge prior; return
    (new_poses, |dx|). A Cholesky that fails gives NaN poses (as JAX's
    does), with no host sync to check it."""
    K = graph.poses.shape[0]
    d = torch.full((6 * K,), cfg.damping, dtype=H.dtype, device=H.device)
    d[:6] += gauge_weight
    L, info = torch.linalg.cholesky_ex(H + torch.diag(d))
    L = torch.where(info == 0, L, torch.nan)
    y = torch.linalg.solve_triangular(L, -g[:, None], upper=False)
    xi = torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)[:, 0]
    xi = xi.reshape(K, 6)
    return _apply_twists(graph.poses, xi), torch.sum(torch.abs(xi))


def optimize_pose_graph(
    graph: PoseGraph,
    cfg: PoseGraphConfig = PoseGraphConfig(),
) -> Tuple[PoseGraph, torch.Tensor]:
    """GN to convergence (the iteration cap, or |dx| <= convergence_eps).
    Returns (graph at the final poses, cost there)."""
    poses = graph.poses
    for _ in range(cfg.max_iterations):
        gr = graph.replace(poses=poses)
        H, g, _ = pose_graph_normal_equations(gr, cfg)
        poses, delta = solve_pose_graph_step(gr, H, g, cfg)
        if not bool(delta > cfg.convergence_eps):      # the iteration's host sync
            break
    out = graph.replace(poses=poses)
    _, _, cost = pose_graph_normal_equations(out, cfg)
    return out, cost
