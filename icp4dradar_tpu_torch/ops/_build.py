"""Build the port's CUDA sources (`icp4dradar_tpu_torch/csrc/*.cu`) with nvcc
into one shared library with a plain C interface, and load it with ctypes.
Every source compiles in its own nvcc process, all started together, then
one nvcc links the objects:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
         -Xcompiler -fPIC -Xptxas -v -c csrc/<name>.cu -o <name>.o   # each
    nvcc -gencode arch=compute_90a,code=sm_90a -shared -o lib....so *.o

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
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + (
    "-std=c++17", "-O3",
    # no FMA contraction: the kernels' distance ties must split exactly as
    # the plain PyTorch versions' separately rounded products and sums do
    "-fmad=false",
    "-Xcompiler", "-fPIC",
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


def _run_all(cmds):
    """Run the commands concurrently; [(cmd, returncode, output)]."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    outs = [(cmd, p.communicate()[0]) for cmd, p in procs]
    return [(cmd, p.returncode, text) for (cmd, text), (_, p) in zip(outs, procs)]


def build_library() -> Path:
    """Compile csrc/*.cu unless the hashed library already exists: one nvcc
    per source, all at once, then one link. Raises RuntimeError carrying
    nvcc's output when a step fails. The compiler's output (ptxas register
    and shared-memory report) is kept beside the library as `<name>.log`."""
    out = library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = find_nvcc(), f"tmp{os.getpid()}"
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in _sources()]
    steps = _run_all([[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                      for src, obj in zip(_sources(), objs)])
    tmp = out.with_suffix(f".{tag}.so")
    if all(rc == 0 for _, rc, _ in steps):
        steps += _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                            *map(str, objs)]])
    log = "".join(f"$ {' '.join(cmd)}\n{text}" for cmd, _, text in steps)
    out.with_suffix(".log").write_text(log)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if any(rc != 0 for _, rc, _ in steps):
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed:\n{log}")
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


def launch(device, fn, *args) -> int:
    """fn(*args, stream) on the current stream of CUDA `device` (a
    torch.device), entering the device only when it is not the current one;
    returns fn's CUDA error code."""
    import torch

    stream = torch.cuda.current_stream(device).cuda_stream
    if device.index == torch.cuda.current_device():
        return fn(*args, stream)
    with torch.cuda.device(device):
        return fn(*args, stream)
