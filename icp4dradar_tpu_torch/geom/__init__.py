"""Core geometry on torch tensors: SO(3)/SE(3), Horn alignment, closed-form
3x3 and 6x6 solves. Batched over leading dimensions throughout."""

from icp4dradar_tpu_torch.geom.so3 import (  # noqa: F401
    quat_identity,
    quat_multiply,
    quat_conjugate,
    quat_rotate,
    quat_slerp,
    so3_vee,
    matrix_to_quat,
    quat_normalize,
    quat_to_matrix,
    so3_exp,
    so3_log,
    so3_hat,
    so3_project,
    matrix_to_rpy,
)
from icp4dradar_tpu_torch.geom.se3 import (  # noqa: F401
    se3_identity,
    se3_from_rt,
    se3_rotation,
    se3_translation,
    se3_compose,
    se3_inverse,
    se3_apply,
    se3_exp,
    se3_log,
)
from icp4dradar_tpu_torch.geom.kabsch import kabsch_umeyama, masked_lstsq  # noqa: F401
from icp4dradar_tpu_torch.geom.linalg import (  # noqa: F401
    condition_number,
    inv3x3,
    solve3x3,
    solve_psd,
    batched_solve_psd,
    solve_spd6,
    sym3x3_eigvals,
    sym3x3_largest_eigvec,
    sym3x3_smallest_eigvec,
)
