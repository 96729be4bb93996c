"""icp4dradar_tpu_torch — the PyTorch + CUDA port of `icp4dradar_tpu`.

A second package beside the JAX one, grown slice by slice. The JAX package
is the reference: every ported module keeps its counterpart's file name and
public function names, and `tests/test_torch_*.py` hold each against it.

Ported so far: the scan-to-scan odometry path (`models.run_scan_to_scan`)
with Doppler preprocessing and batched point-to-point ICP on a hand-written
CUDA ICP-moments kernel (`csrc/icp_moments.cu`); scan-to-map tracking
(`models.run_scan_to_map[_blocked]`) with REVE, the voxel-hash map and
VGICP on the CUDA sweep kernel and its frozen-payload pass
(`csrc/vgicp_sweep.cu`), or kNN GICP on the CUDA 1-NN search
(`csrc/nn_search.cu`); B-stream serving, the streaming session, the
map API and the local-map pass; the pose-graph back end (`graph`); the
host side: ROS1 bags, PCD, the native loaders (`native`), IMU rotation
priors, the record/replay harness, PLY/HTML exports, profiling and debug
guards; the CLI's three modes with the JAX CLI's options but
``--distributed``. This package never imports jax or `icp4dradar_tpu`.

Subpackages (same names as the JAX package)
-------------------------------------------
- ``geom``          SO(3)/SE(3), Horn rotation, closed-form 3x3 solves
- ``io``            RadarScan, .bin and PCD IO, vendor adapters, ROS1 bags,
                    synthetic sequences and bags
- ``preprocess``    Doppler sine-RANSAC, static/dynamic split, ego velocity,
                    REVE, IMU gyro rotation priors
- ``mapping``       the voxel-hash map: insert, sector query, map k-NN
- ``ops``           kernel wrappers and their plain versions, k-NN, build
- ``registration``  batched point-to-point ICP, kNN GICP, VGICP
- ``models``        scan-to-scan and scan-to-map odometry, CLI
- ``utils``         ATE/RPE, trajectory files, logging, checkpoints, viz,
                    profiling, debug guards
- ``csrc``          CUDA C++ sources, built with nvcc at first use
- ``native``        host C++ (.bin prefetching loader, rosbag streamer),
                    built with g++ at first use
"""

__version__ = "0.1.0"

import torch as _torch

# Geometry is precision-critical: reduced-precision products at radar
# ranges (~80 m) inject meter-scale errors into distance cross-terms that
# compound through the pose chain (the JAX package measured 0.3 m -> 30 m
# ATE under bf16 matmuls). Keep every float32 product in IEEE fp32.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from icp4dradar_tpu_torch.config import PipelineConfig  # noqa: E402,F401
