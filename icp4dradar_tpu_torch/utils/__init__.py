"""Utilities: metrics (ATE/RPE), trajectory file IO, the JSONL metrics
logger, stage timers and profiler traces, checkpointing, PLY/HTML exports,
debug guards, and the JAX package's Threefry draws in numpy (`threefry`)."""

from icp4dradar_tpu_torch.utils.logging import MetricsLogger  # noqa: F401
from icp4dradar_tpu_torch.utils.metrics import ate_rmse, rpe, align_umeyama  # noqa: F401
from icp4dradar_tpu_torch.utils.trajectory import (  # noqa: F401
    write_velocity_txt,
    write_rt_txt,
    write_result_csv,
    read_result_csv,
    write_pcl_info,
    write_tum,
)
from icp4dradar_tpu_torch.utils.threefry import (  # noqa: F401
    doppler_uniforms,
    reve_batch_uniforms,
    reve_uniforms,
)
from icp4dradar_tpu_torch.utils.checkpoint import save_checkpoint, load_checkpoint  # noqa: F401
from icp4dradar_tpu_torch.utils.profiling import StageTimer, profile_trace  # noqa: F401
from icp4dradar_tpu_torch.utils.viz import write_ply, export_map_ply, write_html_viewer, voxel_downsample  # noqa: F401
from icp4dradar_tpu_torch.utils.debug import checked, assert_finite_tree, validate_scan  # noqa: F401
