"""Utilities: metrics (ATE/RPE) and trajectory file IO (numpy only)."""

from icp4dradar_tpu_torch.utils.metrics import ate_rmse, rpe, align_umeyama  # noqa: F401
from icp4dradar_tpu_torch.utils.trajectory import (  # noqa: F401
    write_velocity_txt,
    write_rt_txt,
    write_result_csv,
    read_result_csv,
)
