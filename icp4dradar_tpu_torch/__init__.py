"""icp4dradar_tpu_torch — the PyTorch + CUDA port of `icp4dradar_tpu`.

A second package beside the JAX one, grown slice by slice. The JAX package
is the reference: every ported module keeps its counterpart's file name and
public function names, and `tests/test_torch_*.py` hold each against it.

Ported so far: the scan-to-scan odometry path (`models.run_scan_to_scan`)
with Doppler preprocessing, batched point-to-point ICP on a hand-written
CUDA ICP-moments kernel (`csrc/icp_moments.cu`), and the CLI's
``--mode scan_to_scan``. This package never imports jax or
`icp4dradar_tpu`.

Subpackages (same names as the JAX package)
-------------------------------------------
- ``geom``          SO(3)/SE(3), Horn rotation, closed-form 3x3 solves
- ``io``            RadarScan, .bin IO, synthetic sequences
- ``preprocess``    Doppler sine-RANSAC, static/dynamic split, ego velocity
- ``ops``           the ICP-moments kernel wrapper, its plain version, build
- ``registration``  batched point-to-point ICP
- ``models``        scan-to-scan odometry, CLI
- ``utils``         ATE/RPE, trajectory file writers
- ``csrc``          CUDA C++ sources, built with nvcc at first use
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
