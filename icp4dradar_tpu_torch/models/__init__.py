"""End-to-end odometry pipelines: scan-to-scan (the `icp4radar` node,
src/iterative_closest_point.cpp:263-721) and scan-to-map VGICP tracking
(the `radar_odometry` node, src/radar_odometry.cpp:311-434), the streaming
session with checkpoint/resume, keyframe-local submaps
(src/iterative_closest_point.cpp:577-633), the local-map window ICP
(:637-684) and the keyframe pose-graph back end."""

from icp4dradar_tpu_torch.models.scan_to_scan import (  # noqa: F401
    ScanToScanState,
    ScanToScanOutput,
    scan_to_scan_init,
    scan_to_scan_step,
    run_scan_to_scan,
    run_scan_to_scan_replay,
)
from icp4dradar_tpu_torch.models.scan_to_map import (  # noqa: F401
    ScanToMapState,
    ScanToMapOutput,
    scan_to_map_init,
    scan_to_map_step,
    run_scan_to_map,
    run_scan_to_map_blocked,
    run_scan_to_map_batch,
)
from icp4dradar_tpu_torch.models.submap import SubmapAccumulator  # noqa: F401
from icp4dradar_tpu_torch.models.local_map import local_map_refinement, build_windows  # noqa: F401
from icp4dradar_tpu_torch.models.streaming import OdometrySession  # noqa: F401
from icp4dradar_tpu_torch.models.pose_graph_odometry import (  # noqa: F401
    PoseGraphOdometryResult,
    run_pose_graph_odometry,
)
