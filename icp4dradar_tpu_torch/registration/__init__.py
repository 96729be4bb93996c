"""Registration: batched point-to-point ICP, kNN GICP and VGICP scan-to-map
tracking."""

from icp4dradar_tpu_torch.registration.icp import IcpResult, icp_point_to_point  # noqa: F401
from icp4dradar_tpu_torch.registration.gicp import (  # noqa: F401
    GicpResult,
    covariances_from_neighbors,
    gicp_align,
    point_covariances,
)
from icp4dradar_tpu_torch.registration.vgicp import (  # noqa: F401
    vgicp_align,
    vgicp_align_block,
    vgicp_align_streams,
)
