"""Distributed pose-graph Gauss-Newton over the ranks of a mesh (PyTorch
port of `icp4dradar_tpu/parallel/distributed_gn.py`).

Factors are sharded across the mesh's data axis: every rank assembles the
normal-equation contribution of its contiguous 1/n of every factor
container (padded with masked rows to a multiple of n), the partial sums
are all-reduced (SUM, in the graph's float32, one collective a call,
packed), and the reduced system is solved replicated on every rank with
the single-device solvers of `graph/` (dense Cholesky, or the block PCG).
The block solver's loop closures stay replicated and out of the reduce:
their low-rank columns concatenate rather than add.

The GN loop runs on the host, as the single-device optimisers do. Its
branch is taken on the all-reduced (MAX) update size, so every rank leaves
the loop at the same iteration even if two ranks' replicated solves were
to round apart; an early exit on one rank would leave the others waiting
in the next collective."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh

from icp4dradar_tpu_torch.config import PoseGraphConfig
from icp4dradar_tpu_torch.graph.block_solver import (
    BlockNormalEq,
    block_normal_equations,
    solve_block_step,
    split_chain_loops,
)
from icp4dradar_tpu_torch.graph.gauss_newton import (
    PoseGraph,
    pose_graph_normal_equations,
    solve_pose_graph_step,
)
from icp4dradar_tpu_torch.parallel.mesh import all_reduce_max as _all_reduce_max
from icp4dradar_tpu_torch.parallel.mesh import all_reduce_sum as _all_reduce_sum
from icp4dradar_tpu_torch.parallel.mesh import axis_rank, axis_size

# factor-family slots on PoseGraph that shard row-wise, with finite filler
# payloads for the masked pad rows (a 0/0 in a padded row would poison the
# sum through 0 * nan)
_FACTOR_FIELDS = ("rel", "points", "lines", "planes", "planes3")
_PAD_FILLERS = {
    "T_meas": torch.eye(4),
    "line_b": torch.tensor([1.0, 0.0, 0.0]),
    "normal": torch.tensor([0.0, 0.0, 1.0]),
    "plane_l": torch.tensor([1.0, 0.0, 0.0]),
    "plane_m": torch.tensor([0.0, 1.0, 0.0]),
}


def _pad_container(fac, n: int):
    """Pad every per-factor tensor to a multiple of n with masked-out rows."""
    pad = (-fac.mask.shape[0]) % n
    if pad == 0:
        return fac

    def pad_field(name, x):
        fill = _PAD_FILLERS.get(name)
        if fill is None:
            tail = x.new_zeros((pad,) + tuple(x.shape[1:]))
        else:
            tail = fill.to(dtype=x.dtype, device=x.device).expand((pad,) + tuple(fill.shape))
        return torch.cat([x, tail])

    return fac.replace(**{f.name: pad_field(f.name, getattr(fac, f.name))
                          for f in dataclasses.fields(fac)})


def pad_factors_for_mesh(graph: PoseGraph, n: int) -> PoseGraph:
    """Pad every populated factor container to a multiple of the mesh size
    (masked rows with finite filler payloads)."""
    return graph.replace(**{name: _pad_container(getattr(graph, name), n)
                            for name in _FACTOR_FIELDS if getattr(graph, name) is not None})


def _shard(fac, mesh: DeviceMesh, axis: str):
    """This rank's contiguous 1/n of a padded factor container."""
    if fac is None:
        return None
    n, r = axis_size(mesh, axis), axis_rank(mesh, axis)
    per = fac.mask.shape[0] // n
    return fac.replace(**{f.name: getattr(fac, f.name)[r * per:(r + 1) * per]
                          for f in dataclasses.fields(fac)})


def _local_graph(graph: PoseGraph, mesh: DeviceMesh, axis: str) -> PoseGraph:
    return graph.replace(**{name: _shard(getattr(graph, name), mesh, axis)
                            for name in _FACTOR_FIELDS})


def distributed_normal_equations(
    graph: PoseGraph,
    mesh: DeviceMesh,
    cfg: PoseGraphConfig = PoseGraphConfig(),
    axis: str = "dp",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(H, g, cost) with factor shards assembled per rank and summed."""
    local = _local_graph(pad_factors_for_mesh(graph, axis_size(mesh, axis)), mesh, axis)
    H, g, cost = pose_graph_normal_equations(local, cfg)
    return tuple(_all_reduce_sum([H, g, cost], mesh, axis))


def distributed_optimize_pose_graph(
    graph: PoseGraph,
    mesh: DeviceMesh,
    cfg: PoseGraphConfig = PoseGraphConfig(),
    axis: str = "dp",
) -> Tuple[PoseGraph, torch.Tensor]:
    """GN loop: sharded dense assembly, one all-reduce and a replicated
    Cholesky solve an iteration. Returns (the padded graph at the final
    poses, the summed cost there), as the JAX package does."""
    graph = pad_factors_for_mesh(graph, axis_size(mesh, axis))
    local = _local_graph(graph, mesh, axis)
    poses = graph.poses
    for _ in range(cfg.max_iterations):
        H, g, _ = pose_graph_normal_equations(local.replace(poses=poses), cfg)
        H, g = _all_reduce_sum([H, g], mesh, axis)
        poses, delta = solve_pose_graph_step(local.replace(poses=poses), H, g, cfg)
        if not bool(_all_reduce_max(delta, mesh, axis) > cfg.convergence_eps):
            break
    _, _, cost = pose_graph_normal_equations(local.replace(poses=poses), cfg)
    (cost,) = _all_reduce_sum([cost], mesh, axis)
    return graph.replace(poses=poses), cost


def _block_shards(graph: PoseGraph, mesh: DeviceMesh, axis: str):
    """(local graph of single-pose shards without `rel`, this rank's shard
    of the chain factors, the replicated loop factors, the padded graph
    without `rel`)."""
    n = axis_size(mesh, axis)
    chain, loops = split_chain_loops(graph.rel)
    padded = pad_factors_for_mesh(graph.replace(rel=None), n)
    chain = None if chain is None else _shard(_pad_container(chain, n), mesh, axis)
    return _local_graph(padded, mesh, axis), chain, loops, padded


def distributed_block_normal_equations(
    graph: PoseGraph,
    mesh: DeviceMesh,
    cfg: PoseGraphConfig = PoseGraphConfig(),
    axis: str = "dp",
):
    """The assembly stage of the O(K) distributed block GN alone: each
    rank's block normal equations of its chain and single-pose shards,
    summed. Returns (diag, off, g, cost), the same on every rank. Loop
    factors are left out (the full solver replicates them)."""
    local, chain, _, _ = _block_shards(graph, mesh, axis)
    ne = block_normal_equations(local, chain, None, cfg)
    return tuple(_all_reduce_sum([ne.diag, ne.off, ne.g, ne.cost], mesh, axis))


def distributed_optimize_pose_graph_block(
    graph: PoseGraph,
    mesh: DeviceMesh,
    cfg: PoseGraphConfig = PoseGraphConfig(),
    axis: str = "dp",
) -> Tuple[PoseGraph, torch.Tensor]:
    """O(K) distributed GN: each rank assembles the block normal equations
    of its chain and single-pose shards, the (K,6,6) / (K-1,6,6) / (K,6)
    blocks and the cost are summed in one all-reduce an iteration, the
    loop closures' blocks and low-rank columns are added replicated, and
    the block PCG solve (`graph.block_solver.solve_block_step`) runs on
    every rank. Returns (the graph with its single-pose factors padded, the
    final poses and the caller's between-factors untouched, the cost)."""
    local, chain, loops, padded = _block_shards(graph, mesh, axis)

    def normal_eq(poses) -> BlockNormalEq:
        ne = block_normal_equations(local.replace(poses=poses), chain, None, cfg)
        diag, off, g, cost = _all_reduce_sum([ne.diag, ne.off, ne.g, ne.cost], mesh, axis)
        U = ne.U
        if loops is not None:
            nl = block_normal_equations(PoseGraph(poses=poses), None, loops, cfg)
            diag, off, g, cost, U = diag + nl.diag, off + nl.off, g + nl.g, cost + nl.cost, nl.U
        return BlockNormalEq(diag=diag, off=off, U=U, g=g, cost=cost)

    poses = graph.poses
    for _ in range(cfg.max_iterations):
        poses, delta = solve_block_step(normal_eq(poses), poses, cfg)
        if not bool(_all_reduce_max(delta, mesh, axis) > cfg.convergence_eps):
            break
    return padded.replace(poses=poses, rel=graph.rel), normal_eq(poses).cost

