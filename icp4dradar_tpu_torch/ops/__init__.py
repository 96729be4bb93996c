"""Compute kernels: the fused ICP-moments pass (CUDA kernel + plain
version). The library is built from `csrc/` at the first CUDA launch."""

from icp4dradar_tpu_torch.ops.icp_fused import (  # noqa: F401
    icp_iteration_moments,
    icp_iteration_moments_plain,
    moments_to_transform,
)
