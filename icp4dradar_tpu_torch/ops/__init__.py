"""Compute kernels: the fused ICP-moments pass and the fused VGICP sweep
(CUDA kernels + plain versions), masked compaction. The library is built
from `csrc/` at the first CUDA launch."""

from icp4dradar_tpu_torch.ops.icp_fused import (  # noqa: F401
    icp_iteration_moments,
    icp_iteration_moments_plain,
    moments_to_transform,
)
from icp4dradar_tpu_torch.ops.compaction import mask_compact  # noqa: F401
from icp4dradar_tpu_torch.ops.vgicp_fused import (  # noqa: F401
    radar_point_covariances_packed,
    vgicp_iteration,
    vgicp_iteration_batch,
    vgicp_iteration_plain,
)
