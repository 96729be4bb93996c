"""Block-sparse pose-graph Gauss-Newton: O(K) memory and work instead of
the dense (6K, 6K) system (PyTorch port of
`icp4dradar_tpu/graph/block_solver.py`).

A keyframe odometry graph is a chain plus a handful of loop closures: its
Hessian is block-tridiagonal plus a few off-band blocks.

- chain between-factors (j = i+1) and all single-pose factors (point /
  line / plane, include/radarFactor.hpp:11-171) assemble into per-block
  diagonals (K,6,6) and sub-diagonals (K-1,6,6) — never a dense H;
- each loop closure's (12,12) PSD contribution is kept as a rank-6 column
  block U_l = S_l J~^T sqrt(w), so H = T + U U^T with T block-tridiagonal
  and U (6K, 6L);
- the step is preconditioned conjugate gradients on the exact H, with the
  block-tridiagonal Cholesky of an over-damped T^ = T + lam I and a
  Woodbury correction through the 6L-dim capacitance (I + U^T T^-1 U) as
  the preconditioner (the float32 strategy of `solve_block_step`).

The recurrences over K (`block_tridiag_cholesky`, both substitutions of
`block_tridiag_solve`) are host loops of 6x6 torch operations (a
substitution step is one `addmm` through the inverted diagonal factors);
the GN loop and the PCG loop each test their condition on the host, the
one sync an iteration. `GN_ITERATIONS` and
`PCG_ITERATIONS` count the iterations run (set them to 0 to measure a
call).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from icp4dradar_tpu_torch.config import PoseGraphConfig
from icp4dradar_tpu_torch.graph.gauss_newton import (
    PoseGraph,
    RelPoseFactors,
    _apply_twists,
    _iter_single_pose_factors,
    _rel_linearize,
    _single_pose_blocks,
    _Tensors,
)

GN_ITERATIONS = 0
PCG_ITERATIONS = 0


@dataclass
class BlockNormalEq(_Tensors):
    """H = tridiag(diag, off) + U U^T; g; scalar cost.

    diag: (K,6,6) block diagonal, off: (K-1,6,6) = H[i+1, i] sub-diagonal,
    U: (K,6,R) loop-closure low-rank columns (R = 6 * n_loops, 0 if none).
    """

    diag: torch.Tensor
    off: torch.Tensor
    U: torch.Tensor
    g: torch.Tensor      # (K,6)
    cost: torch.Tensor   # ()


def split_chain_loops(
    rel: Optional[RelPoseFactors],
) -> Tuple[Optional[RelPoseFactors], Optional[RelPoseFactors]]:
    """Host-side split of between-factors into chain-adjacent (j == i+1)
    and loop (everything else) sets; one host read of the indices."""
    if rel is None:
        return None, None
    i = rel.i.cpu().numpy()
    j = rel.j.cpu().numpy()
    adj = j == i + 1

    def take(sel):
        if not np.any(sel):
            return None
        idx = torch.from_numpy(np.flatnonzero(sel)).to(rel.i.device)
        return RelPoseFactors(i=rel.i[idx], j=rel.j[idx], T_meas=rel.T_meas[idx],
                              weight=rel.weight[idx], mask=rel.mask[idx])

    return take(adj), take(~adj)


def block_normal_equations(
    graph: PoseGraph,
    chain: Optional[RelPoseFactors],
    loops: Optional[RelPoseFactors],
    cfg: PoseGraphConfig = PoseGraphConfig(),
) -> BlockNormalEq:
    """Assemble the block-sparse normal equations at the current
    linearisation. `chain` must satisfy j == i+1 per factor (see
    split_chain_loops); graph.rel is IGNORED here — pass its split instead.
    Single-pose factors are read from the graph containers."""
    poses = graph.poses
    K, dt, dev = poses.shape[0], poses.dtype, poses.device
    diag = torch.zeros((K, 6, 6), dtype=dt, device=dev)
    off = torch.zeros((max(K - 1, 1), 6, 6), dtype=dt, device=dev)
    g = torch.zeros((K, 6), dtype=dt, device=dev)
    cost = torch.zeros((), dtype=dt, device=dev)

    if chain is not None:
        r0, Ji, Jj, w, c = _rel_linearize(poses, chain, cfg.huber_delta)
        cost = cost + c
        JiW = Ji * w[:, None, None]
        JjW = Jj * w[:, None, None]
        for idx, blk in ((chain.i, torch.einsum("fri,frj->fij", JiW, Ji)),
                         (chain.j, torch.einsum("fri,frj->fij", JjW, Jj))):
            diag.index_put_((idx,), blk, accumulate=True)
        # off[i] = H[i+1, i] = Jj^T W Ji
        off.index_put_((chain.i,), torch.einsum("fri,frj->fij", JjW, Ji), accumulate=True)
        g.index_put_((chain.i,), torch.einsum("fri,fr->fi", JiW, r0), accumulate=True)
        g.index_put_((chain.j,), torch.einsum("fri,fr->fi", JjW, r0), accumulate=True)

    n_loops = 0 if loops is None else loops.i.shape[0]
    Ub = torch.zeros((K, n_loops, 6, 6), dtype=dt, device=dev)
    if loops is not None:
        r0, Ji, Jj, w, c = _rel_linearize(poses, loops, cfg.huber_delta)
        cost = cost + c
        sw = torch.sqrt(torch.clamp(w, min=0.0))[:, None, None]
        l_ix = torch.arange(n_loops, device=dev)
        # Ub[k, l] = U[k, :, 6l:6l+6]
        Ub.index_put_((loops.i, l_ix), Ji.transpose(-1, -2) * sw, accumulate=True)
        Ub.index_put_((loops.j, l_ix), Jj.transpose(-1, -2) * sw, accumulate=True)
        JiW = Ji * w[:, None, None]
        JjW = Jj * w[:, None, None]
        g.index_put_((loops.i,), torch.einsum("fri,fr->fi", JiW, r0), accumulate=True)
        g.index_put_((loops.j,), torch.einsum("fri,fr->fi", JjW, r0), accumulate=True)
    U = Ub.permute(0, 2, 1, 3).reshape(K, 6, 6 * n_loops)

    for fac, res_fn, payload in _iter_single_pose_factors(graph):
        Hkk, gk, c = _single_pose_blocks(poses, res_fn, fac.k, payload, fac.weight,
                                         fac.mask, cfg.huber_delta)
        cost = cost + c
        diag.index_put_((fac.k,), Hkk, accumulate=True)
        g.index_put_((fac.k,), gk, accumulate=True)

    return BlockNormalEq(diag=diag, off=off, U=U, g=g, cost=cost)


def _cholesky(A: torch.Tensor) -> torch.Tensor:
    """Cholesky factor, NaN where A is not positive definite (JAX's
    semantics; `cholesky_ex` keeps the failure on the device)."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info == 0)[..., None, None], L, torch.nan)


def block_tridiag_cholesky(
    diag: torch.Tensor, off: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block-Cholesky of the SPD block-tridiagonal T: T = L L^T with L
    block-bidiagonal. Returns (Ld (K,6,6) lower-triangular diagonal blocks,
    Lo (K-1,6,6) sub-diagonal blocks). A host loop over K of 6x6 ops."""
    K = diag.shape[0]
    L = _cholesky(diag[0])
    Ld, Lo = [L], []
    for k in range(1, K):
        # C = B L_prev^{-T}  <=>  L_prev C^T = B^T
        C = torch.linalg.solve_triangular(L, off[k - 1].transpose(-1, -2),
                                          upper=False).transpose(-1, -2)
        L = _cholesky(diag[k] - C @ C.transpose(-1, -2))
        Ld.append(L)
        Lo.append(C)
    Lo = torch.stack(Lo) if Lo else off[:0]
    return torch.stack(Ld), Lo


def _substitution(Ld: torch.Tensor, Lo: torch.Tensor):
    """The block-Cholesky (Ld, Lo) in the form the substitutions step
    through: the inverses of the diagonal factors (one batched triangular
    solve) and the per-step maps M_k = Ld_k^-1 Lo_{k-1} (forward) and N_k
    = Ld_k^-T Lo_k^T (backward), so that each step of either recurrence
    is one `addmm`. Made once per factorisation, used by every PCG
    iteration."""
    K = Ld.shape[0]
    eye = torch.eye(6, dtype=Ld.dtype, device=Ld.device).expand(K, 6, 6)
    inv = torch.linalg.solve_triangular(Ld, eye, upper=False)
    invT = inv.transpose(-1, -2)
    M = (inv[1:] @ Lo).unbind(0)
    N = (invT[:-1] @ Lo.transpose(-1, -2)).unbind(0)
    return inv, invT, M, N


def _substitute(sub, rhs: torch.Tensor) -> torch.Tensor:
    """T x = rhs (K,6,M) by forward and backward substitution on
    `_substitution`'s form: y_k = Ld_k^-1 rhs_k - M_k y_{k-1}, then x_k =
    Ld_k^-T y_k - N_k x_{k+1}; two host loops of one launch a step."""
    inv, invT, M, N = sub
    K = rhs.shape[0]
    c = (inv @ rhs).unbind(0)
    y = [c[0]]
    for k in range(1, K):
        y.append(torch.addmm(c[k], M[k - 1], y[-1], alpha=-1))
    d = (invT @ torch.stack(y)).unbind(0)
    x = [d[K - 1]]
    for k in range(K - 2, -1, -1):
        x.append(torch.addmm(d[k], N[k], x[-1], alpha=-1))
    return torch.stack(x[::-1])


def block_tridiag_solve(
    Ld: torch.Tensor, Lo: torch.Tensor, rhs: torch.Tensor
) -> torch.Tensor:
    """Solve T x = rhs given the block-Cholesky (Ld, Lo). rhs: (K,6,M) ->
    (K,6,M); forward and backward substitution as two host loops (through
    the inverted diagonal factors: the same solution, rounded otherwise
    than JAX's triangular solves)."""
    return _substitute(_substitution(Ld, Lo), rhs)


def block_matvec(ne: BlockNormalEq, x: torch.Tensor,
                 damping: float, gauge_weight: float) -> torch.Tensor:
    """Exact H x for H = tridiag + U U^T + damping I + gauge on block 0.
    x: (K,6), in the dtype of `ne`. Purely local contractions (no long
    recurrences), so it anchors the PCG below."""
    y = torch.einsum("kij,kj->ki", ne.diag, x) + damping * x
    if x.shape[0] > 1:
        y[1:] += torch.einsum("kij,kj->ki", ne.off, x[:-1])
        y[:-1] += torch.einsum("kji,kj->ki", ne.off, x[1:])
    y[0] += gauge_weight * x[0]
    if ne.U.shape[-1]:
        y = y + torch.einsum("kir,r->ki", ne.U, torch.einsum("kir,ki->r", ne.U, x))
    return y


def solve_block_step(
    ne: BlockNormalEq,
    poses: torch.Tensor,
    cfg: PoseGraphConfig = PoseGraphConfig(),
    gauge_weight: float = 1e6,
    pre_damping_rel: float = 1e-4,
    pre_damping_abs: float = 1e-3,
    cg_iters: int = 64,
    cg_tol: float = 1e-6,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One damped GN step on the block system.

    float32 strategy (the JAX package's, for a device without float64): a
    long keyframe chain's Hessian has bending modes mu_min ~ w/K^2, so its
    float32 block-tridiagonal Cholesky goes indefinite beyond a few hundred
    keyframes. So the slightly OVER-damped T^ = T + lam I is factored (lam
    = pre_damping_rel * mean(tr diag)/6 + pre_damping_abs + damping, just
    large enough to keep the recurrence positive definite) and M = T^ + U
    U^T serves only as the PRECONDITIONER of conjugate gradients on the
    exact H (whose matvec is local contractions, taken in float64). PCG's
    preconditioned condition is 1 + lam/mu_min, so it converges in about
    sqrt(lam/mu_min) iterations. The loop tests its residual on the host,
    one sync an iteration."""
    global PCG_ITERATIONS
    dt, dev = poses.dtype, poses.device
    eye6 = torch.eye(6, dtype=dt, device=dev)
    scale = torch.mean(torch.diagonal(ne.diag, dim1=-2, dim2=-1).sum(-1)) / 6.0
    lam = pre_damping_rel * scale + pre_damping_abs + cfg.damping
    diag_pre = ne.diag + lam * eye6
    diag_pre[0] += gauge_weight * eye6
    Ld, Lo = block_tridiag_cholesky(diag_pre, ne.off)

    sub = _substitution(Ld, Lo)
    R = ne.U.shape[-1]
    if R:
        TinvU = _substitute(sub, ne.U)                                 # (K,6,R)
        S = torch.eye(R, dtype=dt, device=dev) + torch.einsum("kir,kis->rs", ne.U, TinvU)
        S_lu, S_piv, _ = torch.linalg.lu_factor_ex(S)

    def apply_pre(r):
        """M^-1 r with M = T^ + U U^T (Woodbury through the 6L capacitance)."""
        z = _substitute(sub, r[..., None])[..., 0]
        if R:
            corr = torch.linalg.lu_solve(S_lu, S_piv,
                                         torch.einsum("kir,ki->r", ne.U, z)[:, None])[:, 0]
            z = z - torch.einsum("kir,r->ki", TinvU, corr)
        return z

    def dot(a, b):
        return torch.sum(a * b)

    # the exact H matvec in float64 (everything else of the step stays
    # float32). On the long chain of tests/test_graph.py (K >= 256) the PCG
    # runs to its cap in both packages and the step lands 20-80% of its
    # length off the exact GN step, so which perturbed starts converge is
    # decided by round-off, not by this matvec: at K = 512, seeds 5-10, JAX
    # converged from 3 of 6, the port from 2 of 6 in float32 and 1 of 6 in
    # float64 (PERF.md section 7). Kept: it converges from the seed of the
    # JAX test (5), where the float32 matvec does not
    # (tests/test_torch_graph.py::test_long_chain_pcg_stops_at_its_cap_in_both_packages).
    ne64 = BlockNormalEq(**{f: getattr(ne, f).double() for f in ("diag", "off", "U", "g",
                                                                 "cost")})
    b = -ne.g
    tol2 = cg_tol * cg_tol * dot(b, b)
    x = torch.zeros_like(b)
    r = b
    z = apply_pre(r)
    p = z
    rz = dot(r, z)
    it = 0
    while it < cg_iters and bool(dot(r, r) > tol2):          # the iteration's host sync
        Hp = block_matvec(ne64, p.double(), cfg.damping, gauge_weight).to(dt)
        alpha = rz / torch.clamp(dot(p, Hp), min=1e-30)
        x = x + alpha * p
        r = r - alpha * Hp
        z = apply_pre(r)
        rz_new = dot(r, z)
        p = z + rz_new / torch.clamp(rz, min=1e-30) * p
        rz = rz_new
        it += 1
    PCG_ITERATIONS += it
    return _apply_twists(poses, x), torch.sum(torch.abs(x))


def optimize_pose_graph_block(
    graph: PoseGraph,
    cfg: PoseGraphConfig = PoseGraphConfig(),
) -> Tuple[PoseGraph, torch.Tensor]:
    """GN to convergence on the block-sparse system: a drop-in for
    optimize_pose_graph at chain + loops structure. graph.rel is split on
    the host into chain and loop sets once."""
    chain, loops = split_chain_loops(graph.rel)
    return optimize_pose_graph_block_split(graph, chain, loops, cfg)


def optimize_pose_graph_block_split(
    graph: PoseGraph,
    chain: Optional[RelPoseFactors],
    loops: Optional[RelPoseFactors],
    cfg: PoseGraphConfig = PoseGraphConfig(),
) -> Tuple[PoseGraph, torch.Tensor]:
    """The GN loop over block assembly and the PCG step, with the
    between-factors already split into chain-adjacent and loop sets."""
    global GN_ITERATIONS
    poses = graph.poses
    for _ in range(cfg.max_iterations):
        ne = block_normal_equations(graph.replace(poses=poses), chain, loops, cfg)
        poses, delta = solve_block_step(ne, poses, cfg)
        GN_ITERATIONS += 1
        if not bool(delta > cfg.convergence_eps):      # the iteration's host sync
            break
    out = graph.replace(poses=poses)
    return out, block_normal_equations(out, chain, loops, cfg).cost
