"""Scan preprocessing: Doppler outlier rejection + ego-velocity estimation."""

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
