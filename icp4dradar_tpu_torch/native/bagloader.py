"""ctypes wrapper of the native rosbag record streamer (bagio.cpp).

Streams (op, header_bytes, data_bytes) records in bag order with chunk
payloads already decompressed by the C++ worker pool (bz2 and lz4 through
the dlopen'd system libraries). `io/rosbag.py` reads a bag through it
with `use_native=True`; only a bag whose compression `check_supported()`
declines takes the Python path there."""

from __future__ import annotations

import ctypes
import os
from typing import Iterator, Tuple

from icp4dradar_tpu_torch.native.loader import build_native_lib


def build_native() -> str:
    """Compile bagio.cpp (cached). Raises on failure."""
    return build_native_lib("bagio", extra_flags=("-ldl",))


_lib = None


def _get_lib():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build_native())
        lib.bag_open.restype = ctypes.c_int64
        lib.bag_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
        lib.bag_record_count.restype = ctypes.c_int64
        lib.bag_record_count.argtypes = [ctypes.c_int64]
        lib.bag_record_info.restype = ctypes.c_int
        lib.bag_record_info.argtypes = [
            ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int),
        ]
        lib.bag_read_header.restype = ctypes.c_int64
        lib.bag_read_header.argtypes = [
            ctypes.c_int64, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64]
        lib.bag_read_data.restype = ctypes.c_int64
        lib.bag_read_data.argtypes = [
            ctypes.c_int64, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64]
        lib.bag_close.argtypes = [ctypes.c_int64]
        _lib = lib
    return _lib


class NativeBagStreamer:
    """Iterates (op, header_bytes, decompressed_data_bytes) in bag order.

    Raises ValueError at construction when the bag cannot be indexed (a
    truncated record, a length past the end of the file), and mid-stream
    when a record cannot be read or decompressed."""

    def __init__(self, path: str, prefetch_depth: int = 4,
                 num_threads: int = 2):
        self._lib = _get_lib()
        self._h = self._lib.bag_open(os.fsencode(path), prefetch_depth, num_threads)
        if not self._h:
            raise ValueError(f"corrupt ROS1 bag (a record runs past the end of the "
                             f"file or its header is malformed): {path}")
        self.num_records = int(self._lib.bag_record_count(self._h))

    def check_supported(self) -> bool:
        """True iff every record's compression is handled (metadata-only
        scan, before any message is read)."""
        op = ctypes.c_int()
        size = ctypes.c_int64()
        comp_ok = ctypes.c_int()
        for i in range(self.num_records):
            if not self._lib.bag_record_info(
                    self._h, i, ctypes.byref(op), ctypes.byref(size),
                    ctypes.byref(comp_ok)) or not comp_ok.value:
                return False
        return True

    def records(self) -> Iterator[Tuple[int, bytes, bytes]]:
        op = ctypes.c_int()
        size = ctypes.c_int64()
        comp_ok = ctypes.c_int()
        hbuf = ctypes.create_string_buffer(1 << 16)
        for i in range(self.num_records):
            if not self._lib.bag_record_info(
                    self._h, i, ctypes.byref(op), ctypes.byref(size),
                    ctypes.byref(comp_ok)):
                raise ValueError(f"bad record index {i}")
            if not comp_ok.value:
                raise ValueError("unsupported chunk compression (the native reader "
                                 "handles none/bz2/lz4)")
            hlen = self._lib.bag_read_header(self._h, i, hbuf, len(hbuf))
            if hlen < 0 and len(hbuf) < (1 << 20):
                # the indexer accepts headers up to kMaxHeaderLen = 1 MB;
                # grow to that bound and retry before declaring failure
                hbuf = ctypes.create_string_buffer(1 << 20)
                hlen = self._lib.bag_read_header(self._h, i, hbuf, len(hbuf))
            if hlen < 0:
                raise ValueError(f"header read failed at record {i}")
            dbuf = ctypes.create_string_buffer(max(int(size.value), 1))
            dlen = self._lib.bag_read_data(self._h, i, dbuf, len(dbuf))
            if dlen < 0:
                raise ValueError(f"corrupt chunk at record {i} (read or "
                                 f"decompression failed)")
            yield op.value, hbuf.raw[:hlen], dbuf.raw[:dlen]

    def close(self):
        if getattr(self, "_h", None):
            self._lib.bag_close(self._h)
            self._h = None

    def __del__(self):
        self.close()
