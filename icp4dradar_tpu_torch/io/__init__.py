"""Data ingestion: the RadarScan container, .bin frame IO, sequence
datasets."""

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
