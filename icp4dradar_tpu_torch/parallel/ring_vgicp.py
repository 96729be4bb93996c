"""Ring-sweep distributed VGICP: register a scan against a target sharded
over the ranks of a mesh without gathering it (PyTorch port of
`icp4dradar_tpu/parallel/ring_vgicp.py`).

Every rank holds 1/n of the target's voxel distributions and receives the
whole scan; it sweeps only its own 1/n slice of the scan (padded with
masked rows to a multiple of n). Ring step k: the slice is swept against
the shard now visiting the rank, by the sweep kernel K4 with `return_best`
(the matched payload [d2, mean3, cov6] of every source), the payload is
merged into the slice's running best (`merge_best_rows`: strictly smaller
d2 wins), and the shard moves on to rank (r+1) % n while the rank receives
rank (r-1)'s: one `batch_isend_irecv` pair of the shard's (M/n, 10) rows
[mean3, cov6, mask]. After n steps every slice has seen every shard; one
frozen-payload pass (the frozen kernel K5) gives the slice's partial sums,
and one all-reduce turns them into (H, g, cost, sum w, sum w d2), the same
on every rank. At n = 1 a ring step would rotate the shard onto itself:
the exchange is the identity there, as `ppermute` is, and is skipped (NCCL
refuses a send to its own rank); the step still runs. The last rotation of
a sweep, which would only bring every shard home, is skipped too.

The running best stays in K4's blocked (ns, 10, ts) `return_best` layout,
which K5 reads as it is: no re-blocking between the two kernels.

The GN loop runs on the host: one host read of the update size an
iteration, computed from all-reduced sums, so the same on every rank."""

from __future__ import annotations

from dataclasses import replace
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from icp4dradar_tpu_torch.geom.linalg import small_matmul, solve_spd6
from icp4dradar_tpu_torch.geom.se3 import se3_exp
from icp4dradar_tpu_torch.ops.vgicp_fused import (
    VgicpOperands,
    merge_best_rows,
    vgicp_frozen,
    vgicp_pack_targets,
    vgicp_prepare,
    vgicp_sweep,
)
from icp4dradar_tpu_torch.parallel.mesh import all_reduce_sum, axis_group, axis_rank, axis_size


def _pad_scan_to_mesh(src_xyz, src_mask, src_cov6, n):
    """Pad the scan's rows to a multiple of n with masked (weight-0) rows,
    so that every rank gets an equal slice."""
    pad = (-src_xyz.shape[0]) % n
    if pad == 0:
        return src_xyz, src_mask, src_cov6
    return (torch.cat([src_xyz, src_xyz.new_zeros((pad, 3))]),
            torch.cat([src_mask, src_mask.new_zeros(pad)]),
            torch.cat([src_cov6, src_cov6.new_zeros((pad, 6))]))


def scan_slice_operands(src_xyz, src_mask, src_cov6, mesh: DeviceMesh,
                        axis: str) -> VgicpOperands:
    """This rank's 1/n slice of a replicated scan (padded to a multiple of
    n), prepared once for the sweeps and frozen steps of a registration."""
    n, r = axis_size(mesh, axis), axis_rank(mesh, axis)
    sx, sm, sc = _pad_scan_to_mesh(src_xyz, src_mask, src_cov6, n)
    Nl = sx.shape[0] // n
    sl = slice(r * Nl, (r + 1) * Nl)
    return vgicp_prepare(sx[sl], sm[sl], sc[sl])


class RingTarget:
    """This rank's shard of a ring-swept target, its (M/n, 10) rows [mean3,
    cov6, mask], and the ring sweeps and frozen steps against all shards.
    `packed`: each shard's live rows are front-packed (a sector query's
    compaction), so the sweep skips the tiles past a shard's live count."""

    def __init__(self, rows: torch.Tensor, mesh: DeviceMesh, axis: str, packed: bool,
                 max_correspondence_dist: float, cov_eps: float):
        self.rows, self.mesh, self.axis, self.packed = rows.contiguous(), mesh, axis, packed
        self.kw = dict(max_correspondence_dist=max_correspondence_dist, cov_eps=cov_eps)
        self.n = axis_size(mesh, axis)
        self.own = self._pack(self.rows)       # packed once for every sweep

    def _pack(self, rows: torch.Tensor) -> dict:
        count = torch.sum(rows[:, 9] > 0.5).to(torch.int32) if self.packed else None
        return vgicp_pack_targets(rows[:, :3], rows[:, 3:9], rows[:, 9], tgt_count=count)

    def _shift(self, rows: torch.Tensor) -> torch.Tensor:
        """One ring step: send the rows to rank (r+1) % n and receive rank
        (r-1) % n's, one batch_isend_irecv pair."""
        group = axis_group(self.mesh, self.axis)
        r = axis_rank(self.mesh, self.axis)
        to = dist.get_global_rank(group, (r + 1) % self.n)
        frm = dist.get_global_rank(group, (r - 1) % self.n)
        got = torch.empty_like(rows)
        for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, rows, to, group),
                                           dist.P2POp(dist.irecv, got, frm, group)]):
            req.wait()
        return got

    def best(self, T: torch.Tensor, ops: VgicpOperands) -> torch.Tensor:
        """The slice's running best over the n shards at transform T: K4
        with `return_best` once a ring step -> (ns, 10, ts)."""
        best = vgicp_sweep(T, replace(ops, **self.own), return_best=True,
                           **self.kw)[-1]
        rows = self.rows
        for _ in range(1, self.n):
            rows = self._shift(rows)
            b = vgicp_sweep(T, replace(ops, **self._pack(rows)), return_best=True,
                            **self.kw)[-1]
            best = merge_best_rows(best, b)
        return best

    def normal_equations(self, T: torch.Tensor, ops: VgicpOperands):
        """(H, g, cost, wsum, d2sum) of the whole scan against the whole
        target at T, the same on every rank: the ring's best, one frozen
        step (K5) on it, one all-reduce of the slice sums."""
        H, g, cost, wsum, d2sum = vgicp_frozen(T, ops, self.best(T, ops), **self.kw)
        return tuple(all_reduce_sum([H, g, cost, wsum, d2sum], self.mesh, self.axis))

    def align(self, T0: torch.Tensor, ops: VgicpOperands, lm_lambda: float,
              max_iterations: int, transformation_epsilon: float):
        """The GN loop against the ring from T0 (both frames the caller's)
        -> (T, fitness, iterations). A damped 6x6 solve on every rank; the
        loop stops on an update sum |xi| <= epsilon (one host read an
        iteration) or at the cap."""
        T = T0
        eye = torch.eye(6, dtype=T.dtype, device=T.device)
        it = 0
        delta = float("inf")
        wsum = d2sum = torch.zeros((), dtype=T.dtype, device=T.device)
        while it < max_iterations and delta > transformation_epsilon:
            H, g, _, wsum, d2sum = self.normal_equations(T, ops)
            xi = solve_spd6(H + lm_lambda * eye, -g)
            xi = torch.where(torch.isfinite(xi), xi, 0.0)
            T = small_matmul(se3_exp(xi), T)
            delta = float(torch.sum(torch.abs(xi)))
            it += 1
        fitness = d2sum / torch.clamp(wsum, min=1.0)
        return T, fitness, torch.tensor(it, dtype=torch.int32, device=T.device)


def _target_shard(tgt_mean, tgt_cov6, tgt_mask, mesh, axis):
    n, r = axis_size(mesh, axis), axis_rank(mesh, axis)
    M = tgt_mean.shape[0]
    if M % n:
        raise ValueError(f"target rows {M} must be divisible by mesh size {n}")
    sl = slice(r * (M // n), (r + 1) * (M // n))
    return torch.cat([tgt_mean[sl], tgt_cov6[sl], tgt_mask[sl, None].to(tgt_mean.dtype)],
                     dim=-1)


def ring_vgicp_normal_equations(
    T: torch.Tensor,
    src_xyz: torch.Tensor,
    src_mask: torch.Tensor,
    src_cov6: torch.Tensor,
    tgt_mean: torch.Tensor,
    tgt_cov6: torch.Tensor,
    tgt_mask: torch.Tensor,
    mesh: DeviceMesh,
    axis: str = "dp",
    max_correspondence_dist: float = 2.0,
    cov_eps: float = 1e-3,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One distributed GN pass -> (H (6,6), g (6,), cost, wsum, d2sum), the
    same on every rank, equal to `vgicp_iteration` on the whole target up
    to the ring's tie rule. Every rank receives the whole (M, ...) target
    (M divisible by the mesh size) and the whole scan, and works on its
    rows [r M/n, (r+1) M/n) and its slice of the scan."""
    ring = RingTarget(_target_shard(tgt_mean, tgt_cov6, tgt_mask, mesh, axis), mesh, axis,
                      False, max_correspondence_dist, cov_eps)
    return ring.normal_equations(T, scan_slice_operands(src_xyz, src_mask, src_cov6, mesh,
                                                        axis))


def ring_vgicp_align(
    src_xyz: torch.Tensor,
    src_mask: torch.Tensor,
    src_cov6: torch.Tensor,
    tgt_mean: torch.Tensor,
    tgt_cov6: torch.Tensor,
    tgt_mask: torch.Tensor,
    mesh: DeviceMesh,
    init_transform: Optional[torch.Tensor] = None,
    axis: str = "dp",
    max_correspondence_dist: float = 2.0,
    cov_eps: float = 1e-3,
    lm_lambda: float = 1e-6,
    max_iterations: int = 64,
    transformation_epsilon: float = 5e-4,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The full distributed GN against the ring-sharded target -> (T (4,4),
    fitness, iterations), the same on every rank. As `vgicp_align`, it
    optimises in the frame centred on the initial translation (world
    coordinates kilometres out cancel in float32)."""
    dt, dev = src_xyz.dtype, src_xyz.device
    T0 = torch.eye(4, dtype=dt, device=dev) if init_transform is None else init_transform
    center = T0[:3, 3].clone()
    T0 = T0.clone()
    T0[:3, 3] = 0.0
    rows = _target_shard(tgt_mean - center, tgt_cov6, tgt_mask, mesh, axis)
    ring = RingTarget(rows, mesh, axis, False, max_correspondence_dist, cov_eps)
    T, fitness, iters = ring.align(T0, scan_slice_operands(src_xyz, src_mask, src_cov6, mesh,
                                                           axis),
                                   lm_lambda, max_iterations, transformation_epsilon)
    T = T.clone()
    T[:3, 3] += center
    return T, fitness, iters
