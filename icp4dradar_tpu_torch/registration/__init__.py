"""Registration: batched point-to-point ICP, VGICP scan-to-map tracking."""

from icp4dradar_tpu_torch.registration.icp import IcpResult, icp_point_to_point  # noqa: F401
from icp4dradar_tpu_torch.registration.gicp import GicpResult  # noqa: F401
from icp4dradar_tpu_torch.registration.vgicp import (  # noqa: F401
    vgicp_align,
    vgicp_align_block,
)
