"""Core geometry on torch tensors: SO(3)/SE(3), Horn alignment, 3x3 solves.
Batched over leading dimensions throughout."""

from icp4dradar_tpu_torch.geom.so3 import (  # noqa: F401
    quat_normalize,
    quat_to_matrix,
    so3_exp,
    so3_log,
    so3_hat,
)
from icp4dradar_tpu_torch.geom.se3 import (  # noqa: F401
    se3_identity,
    se3_from_rt,
    se3_inverse,
    se3_apply,
    se3_exp,
    se3_log,
)
from icp4dradar_tpu_torch.geom.kabsch import kabsch_umeyama  # noqa: F401
from icp4dradar_tpu_torch.geom.linalg import inv3x3, solve3x3  # noqa: F401
