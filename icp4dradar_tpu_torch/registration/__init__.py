"""Registration: batched point-to-point ICP."""

from icp4dradar_tpu_torch.registration.icp import IcpResult, icp_point_to_point  # noqa: F401
