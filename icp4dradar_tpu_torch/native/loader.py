"""g++ build of the native sources and the ctypes wrapper of the
prefetching .bin frame loader (radario.cpp)."""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR.parents[1] / "build" / "icp4dradar_tpu_torch" / "native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
_BUILD_LOCK = threading.Lock()


def build_native_lib(name: str, extra_flags=()) -> str:
    """Compile `native/<name>.cpp` -> `BUILD_DIR/lib<name>-<hash>.so`, the
    hash over the source and the flags, so an edited source rebuilds and an
    unchanged one loads at once. The library is written under a temporary
    name and renamed into place, so processes that build at once never
    load a partial file. Raises on a compiler error."""
    src = _DIR / f"{name}.cpp"
    flags = CXX_FLAGS + tuple(extra_flags)
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"lib{name}-{digest}.so"
    with _BUILD_LOCK:
        if so.exists():
            return str(so)
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run(["g++", *CXX_FLAGS, str(src), "-o", tmp, *extra_flags],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed on {src.name}:\n{proc.stderr}")
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return str(so)


def build_native() -> str:
    """Compile radario.cpp (cached). Raises on failure."""
    return build_native_lib("radario")


_lib = None


def _get_lib():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build_native())
        lib.rl_open.restype = ctypes.c_void_p
        lib.rl_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                                ctypes.c_int]
        lib.rl_num_frames.restype = ctypes.c_int
        lib.rl_num_frames.argtypes = [ctypes.c_void_p]
        lib.rl_load.restype = ctypes.c_int
        lib.rl_load.argtypes = [
            ctypes.c_void_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.rl_close.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


class NativeBinLoader:
    """Prefetching .bin frame loader. load(k) -> (xyz, intensity, doppler, n)."""

    def __init__(self, folder: str, max_points: int,
                 prefetch_depth: int = 8, num_threads: int = 2):
        self._lib = _get_lib()
        self.max_points = max_points
        self._h = self._lib.rl_open(os.fsencode(folder), max_points, prefetch_depth,
                                    num_threads)
        if not self._h:
            raise RuntimeError(f"rl_open failed for {folder}")
        self.num_frames = self._lib.rl_num_frames(self._h)

    def load(self, order: int):
        xyz = np.zeros((self.max_points, 3), dtype=np.float32)
        intensity = np.zeros(self.max_points, dtype=np.float32)
        doppler = np.zeros(self.max_points, dtype=np.float32)
        fp = ctypes.POINTER(ctypes.c_float)
        n = self._lib.rl_load(
            self._h, order,
            xyz.ctypes.data_as(fp), intensity.ctypes.data_as(fp),
            doppler.ctypes.data_as(fp),
        )
        if n < 0:
            raise IndexError(f"frame {order} out of range")
        return xyz, intensity, doppler, n

    def close(self):
        if getattr(self, "_h", None):
            self._lib.rl_close(self._h)
            self._h = None

    def __del__(self):
        self.close()

    def __len__(self):
        return self.num_frames
