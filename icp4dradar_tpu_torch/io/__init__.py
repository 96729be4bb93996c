"""Data ingestion: the RadarScan container, .bin and PCD frame IO, vendor
adapters, ROS1 bags, sequence datasets."""

from icp4dradar_tpu_torch.io.scan import RadarScan, stack_scans  # noqa: F401
from icp4dradar_tpu_torch.io.bin_io import (  # noqa: F401
    read_radar_bin,
    write_radar_bin,
    frame_path,
)
from icp4dradar_tpu_torch.io.dataset import (  # noqa: F401
    BinSequenceDataset,
    SyntheticSequence,
    VENDOR_PROFILES,
    VendorProfile,
)
from icp4dradar_tpu_torch.io.formats import (  # noqa: F401
    RadarFields,
    adapt_point_records,
    detect_format,
)
from icp4dradar_tpu_torch.io.rosbag import (  # noqa: F401
    RosbagReader,
    RosbagWriter,
    ImuSample,
    OdomSample,
)
from icp4dradar_tpu_torch.io.bag_dataset import RadarBagDataset  # noqa: F401
from icp4dradar_tpu_torch.io.synthetic_bag import write_synthetic_bag  # noqa: F401
from icp4dradar_tpu_torch.io.pcd import read_pcd, write_pcd, PcdSequenceDataset  # noqa: F401
