"""The port's host IO beside the bags against the JAX package's: the vendor
adapter (`io/formats.py`), PCD files in binary and ASCII (each package's
reader on the other's files), `PcdSequenceDataset`, and `.bin` sequences
through the native prefetching loader (`native/radario.cpp`) against numpy
reads and JAX's dataset. Small frames (at most 256 points). Every
comparison is exact, except the ASCII PCD files, which hold six decimals
(atol 1e-6 on values up to 30: the 5e-7 of the text and float32's rounding
of it)."""

import os

import numpy as np
import pytest

from icp4dradar_tpu.io import BinSequenceDataset as JaxBinDataset
from icp4dradar_tpu.io import PcdSequenceDataset as JaxPcdDataset
from icp4dradar_tpu.io import adapt_point_records as jax_adapt
from icp4dradar_tpu.io import detect_format as jax_detect
from icp4dradar_tpu.io import read_pcd as jax_read_pcd
from icp4dradar_tpu.io import write_pcd as jax_write_pcd
from icp4dradar_tpu_torch.io import (
    BinSequenceDataset, PcdSequenceDataset, adapt_point_records, detect_format, read_pcd,
    write_pcd, write_radar_bin,
)
from icp4dradar_tpu_torch.native import NativeBinLoader
from tests._torch_threads import one_torch_thread  # noqa: F401

SCAN_FIELDS = ("xyz", "doppler", "intensity", "mask", "time")


SCHEMAS = {
    "rio": ["x", "y", "z", "snr_db", "noise_db", "v_doppler_mps"],
    "ti_mmwave": ["x", "y", "z", "intensity", "velocity"],
    "oculii": ["x", "y", "z", "Doppler", "Range", "Power", "Alpha", "Beta"],
    "coloradar": ["x", "y", "z", "intensity", "range", "doppler"],
}


def _columns(rng, names, n=200):
    return {k: rng.normal(0, 10, n).astype(np.float64 if k == "x" else np.float32)
            for k in names}


@pytest.mark.parametrize("schema", list(SCHEMAS))
def test_formats_match_jax(schema):
    rng = np.random.default_rng(len(schema))
    cols = _columns(rng, SCHEMAS[schema])
    assert detect_format(cols) == jax_detect(cols) == schema
    p, j = adapt_point_records(cols), jax_adapt(cols)
    for f in ("xyz", "intensity", "doppler", "range", "noise_db"):
        assert getattr(p, f).dtype == np.float32
        np.testing.assert_array_equal(getattr(p, f), getattr(j, f), err_msg=f)
    if schema == "ti_mmwave":          # ref axis swap: x = -y_raw, y = x_raw
        np.testing.assert_array_equal(p.xyz[:, 0], -cols["y"])


def test_format_priority_and_unsupported():
    # rio's and coloradar's fields together: rio wins (the reference's order)
    both = set(SCHEMAS["rio"]) | set(SCHEMAS["coloradar"]) | set(SCHEMAS["ti_mmwave"])
    assert detect_format(both) == jax_detect(both) == "rio"
    assert detect_format(["x", "y", "z", "intensity", "velocity", "range", "doppler"]) \
        == "ti_mmwave"
    assert detect_format(["x", "y"]) is None
    with pytest.raises(ValueError, match="unsupported point cloud with fields: a, x"):
        adapt_point_records({"x": np.zeros(2), "a": np.zeros(2)})


@pytest.mark.parametrize("binary", [True, False])
def test_pcd_roundtrip_both_ways(tmp_path, binary):
    rng = np.random.default_rng(int(binary))
    cols = {k: rng.uniform(-30, 30, 150).astype(np.float32)
            for k in ("x", "y", "z", "intensity", "doppler")}
    a, b = os.fspath(tmp_path / "port.pcd"), os.fspath(tmp_path / "jax.pcd")
    write_pcd(a, cols, binary=binary)
    jax_write_pcd(b, cols, binary=binary)
    assert open(a, "rb").read() == open(b, "rb").read()
    tol = 0 if binary else 1e-6     # 6 decimals, then the float32 rounding
    for reader in (read_pcd, jax_read_pcd):
        out = reader(a)
        assert list(out) == list(cols)
        for k in cols:
            assert out[k].dtype == np.float32
            np.testing.assert_allclose(out[k], cols[k], atol=tol, rtol=0)
    # a header with comments, mixed types and a COUNT > 1 field
    raw = np.zeros(3, dtype=[("x", "<f4"), ("i", "<u2"), ("n", "<f8", (2,))])
    raw["x"], raw["i"], raw["n"] = [1.5, -2, 3], [7, 8, 9], [[1, 2], [3, 4], [5, 6]]
    (tmp_path / "m.pcd").write_bytes(
        b"# comment\nVERSION 0.7\nFIELDS x i n\nSIZE 4 2 8\nTYPE F U F\nCOUNT 1 1 2\n"
        b"WIDTH 3\nHEIGHT 1\nPOINTS 3\nDATA binary\n" + raw.tobytes())
    p, j = read_pcd(os.fspath(tmp_path / "m.pcd")), jax_read_pcd(os.fspath(tmp_path / "m.pcd"))
    assert list(p) == list(j) == ["x", "i", "n_0", "n_1"]
    for k in p:
        np.testing.assert_array_equal(p[k], j[k])


def test_pcd_sequence_dataset_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    for k in range(4):
        n = 40 + 30 * k
        write_pcd(os.fspath(tmp_path / "pcd" / f"{k:05d}.pcd"), {
            "x": rng.normal(0, 20, n), "y": rng.normal(0, 20, n), "z": rng.normal(0, 2, n),
            "intensity": rng.uniform(5, 30, n), "doppler": rng.normal(0, 1, n)},
            binary=k % 2 == 0)
    port, jax_ = PcdSequenceDataset(os.fspath(tmp_path), max_points=100), \
        JaxPcdDataset(os.fspath(tmp_path), max_points=100)
    assert len(port) == len(jax_) == 4
    for p, j in zip(port, jax_):
        for f in SCAN_FIELDS:
            np.testing.assert_array_equal(getattr(p, f).numpy(), np.asarray(getattr(j, f)))
    assert port[3].mask.sum() == 100 and port[0].mask.sum() == 40     # truncated, padded
    assert float(port[2].time) == 2.0


def _write_bin_sequence(folder, sizes, seed=0):
    rng = np.random.default_rng(seed)
    for k, n in enumerate(sizes):
        write_radar_bin(os.fspath(folder / "data" / f"radar_pointcloud_{k}.bin"),
                        rng.normal(0, 10, (n, 5)).astype(np.float32))


def test_native_bin_loader_matches_numpy_and_jax(tmp_path):
    _write_bin_sequence(tmp_path, [10, 256, 300, 0, 77])
    native = BinSequenceDataset(os.fspath(tmp_path), max_points=256)
    plain = BinSequenceDataset(os.fspath(tmp_path), max_points=256, use_native=False)
    jax_ = JaxBinDataset(os.fspath(tmp_path), max_points=256)
    assert native.native_used and not plain.native_used
    assert len(native) == len(plain) == len(jax_) == 5
    for k in range(5):
        for f in SCAN_FIELDS:
            a = getattr(native[k], f).numpy()
            np.testing.assert_array_equal(a, getattr(plain[k], f).numpy())
            np.testing.assert_array_equal(a, np.asarray(getattr(jax_[k], f)))
    assert [int(native[k].mask.sum()) for k in range(5)] == [10, 256, 256, 0, 77]
    # out of order, then sequential again: the prefetcher serves any frame
    order = [4, 0, 2, 1, 3, 0, 1, 2, 3, 4]
    for k in order:
        np.testing.assert_array_equal(native[k].xyz.numpy(), plain[k].xyz.numpy())


def test_native_loader_bounds(tmp_path):
    _write_bin_sequence(tmp_path, [5, 6])
    loader = NativeBinLoader(os.fspath(tmp_path), max_points=4)
    assert len(loader) == 2
    xyz, intensity, doppler, n = loader.load(1)
    assert n == 4 and xyz.shape == (4, 3)
    for k in (-1, 2):
        with pytest.raises(IndexError):
            loader.load(k)
    loader.close()
    loader.close()                      # idempotent
    assert len(NativeBinLoader(os.fspath(tmp_path / "missing"), 4)) == 0
