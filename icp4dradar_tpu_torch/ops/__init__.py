"""Compute kernels: the fused ICP-moments pass, the fused VGICP sweep and
its frozen-payload GN pass, the damped GN step, the masked 1-NN search
(CUDA kernels + plain versions), the chunked k-NN, masked compaction. The
library is built from `csrc/` at the first CUDA launch."""

from icp4dradar_tpu_torch.ops.icp_fused import (  # noqa: F401
    IcpOperands,
    icp_iteration_moments,
    icp_iteration_moments_plain,
    icp_moments,
    icp_prepare,
    moments_to_transform,
)
from icp4dradar_tpu_torch.ops.compaction import mask_compact  # noqa: F401
from icp4dradar_tpu_torch.ops.gn_step import gn_step, gn_step_plain  # noqa: F401
from icp4dradar_tpu_torch.ops.knn import (  # noqa: F401
    NnOperands,
    knn,
    nearest_neighbor,
    nearest_neighbor_plain,
    nearest_neighbor_with_coords,
    nearest_neighbor_with_coords_plain,
    nn_pack_plain,
    nn_prepare,
    nn_search,
    nn_search_coords,
    nn_search_coords_plain,
    nn_search_plain,
)
from icp4dradar_tpu_torch.ops.vgicp_fused import (  # noqa: F401
    VgicpOperands,
    radar_point_covariances_packed,
    vgicp_frozen,
    vgicp_iteration,
    vgicp_iteration_batch,
    vgicp_iteration_frozen,
    vgicp_iteration_frozen_plain,
    vgicp_iteration_plain,
    vgicp_prepare,
    vgicp_sweep,
)
