"""Native C++ host runtime: the prefetching .bin frame loader
(`radario.cpp`) and the rosbag record streamer (`bagio.cpp`), the port's
own copies of the JAX package's sources.

Each source is compiled with g++ at first use (ctypes ABI, no pybind11)
into `build/icp4dradar_tpu_torch/native/` at the repository root, beside
the CUDA library of `ops/_build.py`; nothing builds at import. A build or
load failure raises: the callers never fall back silently.
"""

from icp4dradar_tpu_torch.native.loader import NativeBinLoader, build_native  # noqa: F401
