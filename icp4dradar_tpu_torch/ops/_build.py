"""Build the port's CUDA sources (`icp4dradar_tpu_torch/csrc/*.cu`) with nvcc
into one shared library with a plain C interface, and load it with ctypes.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
         -shared -Xcompiler -fPIC -o build/icp4dradar_tpu_torch/lib....so csrc/*.cu

The library lands in `build/icp4dradar_tpu_torch/` at the repository root,
named by a hash of the sources and flags, so an edited source rebuilds and
an unchanged one loads at once. Only the repository's own sources are
built. nvcc comes from CUDA_HOME, else PATH. Nothing here runs at import:
the first CUDA launch builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "icp4dradar_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # no FMA contraction: the kernels' distance ties must split exactly as
    # the plain PyTorch versions' separately rounded products and sums do
    "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / shared memory / spills into the log
)

_LIB: Optional[ctypes.CDLL] = None


def find_nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").is_file():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources():
    srcs = sorted(CSRC_DIR.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    return srcs


def library_path() -> Path:
    """Path of the library for the current sources and flags."""
    h = hashlib.sha256()
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libicp4dradar_kernels_{h.hexdigest()[:16]}.so"


def build_library() -> Path:
    """Compile csrc/*.cu unless the hashed library already exists. Raises
    RuntimeError carrying nvcc's output when the build fails. The compiler's
    output (ptxas register and shared-memory report) is kept beside the
    library as `<name>.log`."""
    out = library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
    out.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed (exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return out


def build_log() -> str:
    """The compiler output of the current library's build ('' if none)."""
    log = library_path().with_suffix(".log")
    return log.read_text() if log.is_file() else ""


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, once per process."""
    global _LIB
    if _LIB is None:
        _LIB = ctypes.CDLL(str(build_library()))
    return _LIB
