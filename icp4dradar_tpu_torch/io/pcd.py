"""PCD (Point Cloud Data) file IO (a numpy-only copy of
`icp4dradar_tpu/io/pcd.py`) — the reference's USE_PCD_FILES input path
(src/iterative_closest_point.cpp:269-299 loads `<seq>/pcd/%05d.pcd` via
pcl::io::loadPCDFile). Supports ASCII and binary encodings, arbitrary float
fields (x,y,z [+ intensity, doppler, ...]), no PCL dependency.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from icp4dradar_tpu_torch.io.scan import RadarScan

_PCD_TO_NP = {("F", 4): np.float32, ("F", 8): np.float64,
              ("I", 1): np.int8, ("I", 2): np.int16, ("I", 4): np.int32,
              ("U", 1): np.uint8, ("U", 2): np.uint16, ("U", 4): np.uint32}


def read_pcd(path: str) -> Dict[str, np.ndarray]:
    """Parse a .pcd file -> {field: (N,) float32 column}."""
    with open(path, "rb") as f:
        header = {}
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            if not line or line.startswith("#"):
                continue
            key, _, val = line.partition(" ")
            header[key.upper()] = val
            if key.upper() == "DATA":
                break
        fields = header["FIELDS"].split()
        sizes = [int(x) for x in header["SIZE"].split()]
        types = header["TYPE"].split()
        counts = [int(x) for x in header.get("COUNT", " ".join(["1"] * len(fields))).split()]
        n = int(header["POINTS"])
        data_mode = header["DATA"].split()[0]

        np_fields = []
        for name, size, typ, count in zip(fields, sizes, types, counts):
            dt = _PCD_TO_NP[(typ, size)]
            if count == 1:
                np_fields.append((name, dt))
            else:
                for c in range(count):
                    np_fields.append((f"{name}_{c}", dt))
        dtype = np.dtype(np_fields)

        if data_mode == "ascii":
            raw = np.loadtxt(f, dtype=np.float64, max_rows=n)
            raw = np.atleast_2d(raw)
            out = {}
            for i, (name, _) in enumerate(np_fields):
                out[name] = raw[:, i].astype(np.float32)
            return out
        elif data_mode == "binary":
            buf = f.read(n * dtype.itemsize)
            arr = np.frombuffer(buf, dtype=dtype, count=n)
            return {name: arr[name].astype(np.float32) for name, _ in np_fields}
        else:
            raise ValueError(f"unsupported PCD DATA mode: {data_mode} "
                             "(binary_compressed not supported)")


def write_pcd(path: str, columns: Dict[str, np.ndarray],
              binary: bool = True) -> None:
    """Write float32 columns as a .pcd file."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    names = list(columns.keys())
    cols = [np.asarray(columns[k], dtype=np.float32).reshape(-1) for k in names]
    n = len(cols[0])
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        f"FIELDS {' '.join(names)}\n"
        f"SIZE {' '.join(['4'] * len(names))}\n"
        f"TYPE {' '.join(['F'] * len(names))}\n"
        f"COUNT {' '.join(['1'] * len(names))}\n"
        f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n"
        f"POINTS {n}\n"
        f"DATA {'binary' if binary else 'ascii'}\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        stacked = np.stack(cols, axis=-1)
        if binary:
            f.write(stacked.astype(np.float32).tobytes())
        else:
            np.savetxt(f, stacked, fmt="%.6f")


class PcdSequenceDataset:
    """`<folder>/pcd/%05d.pcd` frame sequence -> RadarScan stream
    (reference path layout, src/iterative_closest_point.cpp:270-284)."""

    def __init__(self, folder: str, max_points: int = 4096):
        self.folder = folder
        self.max_points = max_points
        self.num_frames = 0
        while os.path.exists(self._path(self.num_frames)):
            self.num_frames += 1

    def _path(self, k: int) -> str:
        return os.path.join(self.folder, "pcd", f"{k:05d}.pcd")

    def __len__(self) -> int:
        return self.num_frames

    def __getitem__(self, k: int):
        cols = read_pcd(self._path(k))
        xyz = np.stack([cols["x"], cols["y"], cols["z"]], axis=-1)
        doppler = cols.get("doppler", cols.get("Doppler"))
        intensity = cols.get("intensity", cols.get("Power"))
        return RadarScan.from_arrays(
            xyz, doppler, intensity, max_points=self.max_points, time=float(k)
        )

    def __iter__(self):
        for k in range(self.num_frames):
            yield self[k]
