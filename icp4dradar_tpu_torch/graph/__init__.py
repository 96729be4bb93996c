"""Pose-graph back end (PyTorch port of `icp4dradar_tpu/graph/`): the Ceres
factors the reference declares but never solves (include/radarFactor.hpp:
11-171), as batched residuals with forward-mode autodiff Jacobians
(`torch.func`), a dense and a block-sparse SE(3) Gauss-Newton solver, and
the structure-factor miner over the voxel map's Gaussians."""

from icp4dradar_tpu_torch.graph.factors import (  # noqa: F401
    point_to_line_residual,
    point_to_plane_residual,
    point_to_plane_norm_residual,
    point_to_point_residual,
    relative_pose_residual,
)
from icp4dradar_tpu_torch.graph.gauss_newton import (  # noqa: F401
    PoseGraph,
    RelPoseFactors,
    PointFactors,
    LineFactors,
    PlaneFactors,
    Plane3Factors,
    optimize_pose_graph,
    pose_graph_normal_equations,
    solve_pose_graph_step,
)
from icp4dradar_tpu_torch.graph.block_solver import (  # noqa: F401
    BlockNormalEq,
    block_normal_equations,
    block_tridiag_cholesky,
    block_tridiag_solve,
    optimize_pose_graph_block,
    optimize_pose_graph_block_split,
    split_chain_loops,
)
