"""LZ4 frame (de)compression via ctypes on the system liblz4 (a copy of
`icp4dradar_tpu/io/lz4f.py`).

ROS1 bags compress chunks with roslz4, which writes the standard LZ4 frame
format (magic 0x184D2204) — the same streams `rosbag::View` reads
transparently in the reference (src/radar_odometry.cpp:251). This binds
the LZ4F one-shot/streaming API of the runtime `liblz4.so.1` directly: no
Python lz4 module, no -dev headers, no compilation.

`available()` gates the feature: the Python bag walk raises cleanly when
the library is absent.
"""

from __future__ import annotations

import ctypes
import ctypes.util
from typing import Optional

_LZ4F_VERSION = 100


def _load() -> Optional[ctypes.CDLL]:
    for name in ("liblz4.so.1", "liblz4.so", "liblz4.dylib"):
        try:
            return ctypes.CDLL(name)
        except OSError:
            continue
    path = ctypes.util.find_library("lz4")
    if path:
        try:
            return ctypes.CDLL(path)
        except OSError:
            pass
    return None


_lib: Optional[ctypes.CDLL] = None
_loaded = False


def _get() -> Optional[ctypes.CDLL]:
    global _lib, _loaded
    if not _loaded:
        _loaded = True
        lib = _load()
        if lib is not None:
            try:
                lib.LZ4F_createDecompressionContext.restype = ctypes.c_size_t
                lib.LZ4F_createDecompressionContext.argtypes = [
                    ctypes.POINTER(ctypes.c_void_p), ctypes.c_uint]
                lib.LZ4F_freeDecompressionContext.restype = ctypes.c_size_t
                lib.LZ4F_freeDecompressionContext.argtypes = [ctypes.c_void_p]
                lib.LZ4F_decompress.restype = ctypes.c_size_t
                lib.LZ4F_decompress.argtypes = [
                    ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.POINTER(ctypes.c_size_t), ctypes.c_void_p,
                    ctypes.POINTER(ctypes.c_size_t), ctypes.c_void_p]
                lib.LZ4F_isError.restype = ctypes.c_uint
                lib.LZ4F_isError.argtypes = [ctypes.c_size_t]
                lib.LZ4F_compressFrameBound.restype = ctypes.c_size_t
                lib.LZ4F_compressFrameBound.argtypes = [
                    ctypes.c_size_t, ctypes.c_void_p]
                lib.LZ4F_compressFrame.restype = ctypes.c_size_t
                lib.LZ4F_compressFrame.argtypes = [
                    ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
                    ctypes.c_size_t, ctypes.c_void_p]
            except AttributeError:
                lib = None
        _lib = lib
    return _lib


def available() -> bool:
    return _get() is not None


def decompress(data: bytes, expected_size: int = 0) -> bytes:
    """Decompress one LZ4 frame stream. `expected_size` (the bag chunk
    header's `size` field) pre-sizes the output; the buffer grows if the
    hint is wrong."""
    lib = _get()
    if lib is None:
        raise RuntimeError("liblz4 not available for lz4 chunk decompression")
    dctx = ctypes.c_void_p()
    rc = lib.LZ4F_createDecompressionContext(ctypes.byref(dctx), _LZ4F_VERSION)
    if lib.LZ4F_isError(rc):
        raise RuntimeError("LZ4F_createDecompressionContext failed")
    try:
        src = ctypes.create_string_buffer(data, len(data))
        out = bytearray()
        cap = max(int(expected_size), 1 << 16)
        dst = ctypes.create_string_buffer(cap)
        src_off = 0
        while src_off < len(data):
            dst_sz = ctypes.c_size_t(cap)
            src_sz = ctypes.c_size_t(len(data) - src_off)
            rc = lib.LZ4F_decompress(
                dctx, dst, ctypes.byref(dst_sz),
                ctypes.byref(src, src_off), ctypes.byref(src_sz), None)
            if lib.LZ4F_isError(rc):
                raise ValueError("corrupt lz4 frame in bag chunk")
            out += dst.raw[: dst_sz.value]
            if src_sz.value == 0 and dst_sz.value == 0:
                raise ValueError("lz4 decompression stalled (corrupt frame)")
            src_off += src_sz.value
        return bytes(out)
    finally:
        lib.LZ4F_freeDecompressionContext(dctx)


def compress(data: bytes) -> bytes:
    """One-shot LZ4 frame compression (writer / test fixtures)."""
    lib = _get()
    if lib is None:
        raise RuntimeError("liblz4 not available for lz4 compression")
    bound = lib.LZ4F_compressFrameBound(len(data), None)
    dst = ctypes.create_string_buffer(int(bound))
    src = ctypes.create_string_buffer(data, len(data))
    rc = lib.LZ4F_compressFrame(dst, len(dst), src, len(data), None)
    if lib.LZ4F_isError(rc):
        raise RuntimeError("LZ4F_compressFrame failed")
    return dst.raw[: int(rc)]
