"""Scan preprocessing: Doppler outlier rejection + ego-velocity estimation,
REVE ego velocity with inlier extraction, IMU gyro rotation priors."""

from icp4dradar_tpu_torch.preprocess.doppler import (  # noqa: F401
    SineFit,
    draw_uniforms,
    fit_sine_ransac,
    sine_residuals,
    static_dynamic_split,
    lsq_ego_velocity,
    preprocess_scan,
    preprocess_frames,
)
from icp4dradar_tpu_torch.preprocess.reve import (  # noqa: F401
    EgoVelocityEstimate,
    draw_reve_uniforms,
    estimate_ego_velocity,
    reve_hypotheses,
)
from icp4dradar_tpu_torch.preprocess.imu import (  # noqa: F401
    integrate_gyro,
    imu_prior_deltas,
)
