"""Where the port keeps what it compiles (PyTorch port of
`icp4dradar_tpu/utils/cache.py`).

The JAX package points XLA's persistent compilation cache at a directory
on the TPU and turns it off on the CPU. The port's only compiled artefact
is the CUDA library of `csrc/`, which `ops/_build.py` builds with nvcc into
`build/icp4dradar_tpu_torch/` at the repository root, named by a hash of
the sources and flags: an unchanged library loads at once, whatever its
compile time. This function names that directory.
"""

from __future__ import annotations


def setup_compilation_cache(min_compile_secs: float = 2.0) -> str:
    """The directory the CUDA library is built into and loaded from
    (created), or "" without a CUDA device, as the JAX package returns ""
    off the TPU. `min_compile_secs` is the JAX signature's and unused: every
    build is kept."""
    import torch

    if not torch.cuda.is_available():
        return ""
    from icp4dradar_tpu_torch.ops import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return str(_build.BUILD_DIR)
