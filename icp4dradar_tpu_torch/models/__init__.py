"""End-to-end odometry pipelines: scan-to-scan (the `icp4radar` node,
src/iterative_closest_point.cpp:263-721)."""

from icp4dradar_tpu_torch.models.scan_to_scan import (  # noqa: F401
    ScanToScanState,
    ScanToScanOutput,
    scan_to_scan_init,
    scan_to_scan_step,
    run_scan_to_scan,
)
