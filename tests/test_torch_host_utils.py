"""The port's host utilities against the JAX package's: the PLY and HTML
exports byte for byte on the same inputs (a map export on the same voxel
map, and a batched map's export holding every stream's points),
`voxel_downsample`, `StageTimer`, `profile_trace`, the `checked` float
guard (a NaN made inside the function and masked away before its output),
and the errors of `assert_finite_tree` and `validate_scan`, message for
message. `voxel_downsample` agrees to 1e-6 (float64 sums in both, over
points ordered alike); everything else is exact."""

import dataclasses
import json
import os
import re
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icp4dradar_tpu.io import RadarScan as JaxScan
from icp4dradar_tpu.mapping.voxel_hash import voxel_map_create as jax_map_create
from icp4dradar_tpu.mapping.voxel_hash import voxel_map_insert as jax_map_insert
from icp4dradar_tpu.utils import assert_finite_tree as jax_assert_finite
from icp4dradar_tpu.utils import export_map_ply as jax_export_map_ply
from icp4dradar_tpu.utils import validate_scan as jax_validate_scan
from icp4dradar_tpu.utils import voxel_downsample as jax_downsample
from icp4dradar_tpu.utils import write_html_viewer as jax_html
from icp4dradar_tpu.utils import write_ply as jax_ply
from icp4dradar_tpu_torch.interop import VOXEL_MAP_FIELDS, voxel_map_from_numpy
from icp4dradar_tpu_torch.io import RadarScan
from icp4dradar_tpu_torch.utils import (
    StageTimer, assert_finite_tree, checked, export_map_ply, profile_trace,
    validate_scan, voxel_downsample, write_html_viewer, write_ply,
)
from tests._torch_threads import one_torch_thread  # noqa: F401


def _same_file(tmp_path, name, port, jax_):
    a, b = tmp_path / f"port_{name}", tmp_path / f"jax_{name}"
    port(os.fspath(a))
    jax_(os.fspath(b))
    assert a.read_bytes() == b.read_bytes(), name
    return a.read_text()


def test_ply_and_html_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    pts = rng.normal(0, 20, (300, 3)).astype(np.float32)
    inten = rng.uniform(5, 30, 300).astype(np.float32)
    text = _same_file(tmp_path, "c.ply", lambda p: write_ply(p, pts, inten),
                      lambda p: jax_ply(p, pts, inten))
    assert "element vertex 300" in text and "property uchar red" in text
    _same_file(tmp_path, "g.ply", lambda p: write_ply(p, pts), lambda p: jax_ply(p, pts))
    est = np.cumsum(rng.normal(0, 1, (50, 3)), axis=0)
    gt = est + rng.normal(0, 0.1, est.shape)
    big = rng.normal(0, 30, (25000, 3))            # over 20000: subsampled
    for name, kw in (("a.html", {}), ("b.html", dict(gt_positions=gt, map_points=big,
                                                     title="t"))):
        html = _same_file(tmp_path, name, lambda p: write_html_viewer(p, est, **kw),
                          lambda p: jax_html(p, est, **kw))
        mp = json.loads(re.search(r"const mp=(.*);", html).group(1))
        assert mp is None if not kw else len(mp) == 20000


def test_export_map_ply_matches_jax_and_writes_every_stream(tmp_path):
    rng = np.random.default_rng(1)
    jmap = jax_map_create(capacity=1 << 10)
    for k in range(3):
        jmap = jax_map_insert(jmap, jnp.asarray(rng.normal(0, 6, (200, 3)), jnp.float32),
                              intensity=jnp.asarray(rng.uniform(5, 30, 200), jnp.float32))
    arrays = {k: np.asarray(getattr(jmap, k)) for k in VOXEL_MAP_FIELDS}
    pmap = voxel_map_from_numpy(arrays, device="cpu")
    n = {}
    _same_file(tmp_path, "map.ply", lambda p: n.setdefault("port", export_map_ply(p, pmap)),
               lambda p: n.setdefault("jax", jax_export_map_ply(p, jmap)))
    assert n["port"] == n["jax"] == int(arrays["occupied"].sum()) > 100
    # a batched (S, C) map: every stream's occupied voxels, stream by stream
    other = {k: np.roll(v, 7, axis=0) for k, v in arrays.items()}
    other["occupied"][:50] = 0
    batched = voxel_map_from_numpy({k: np.stack([arrays[k], other[k]]) for k in arrays},
                                   device="cpu")
    count = export_map_ply(os.fspath(tmp_path / "b.ply"), batched)
    assert count == int(arrays["occupied"].sum() + other["occupied"].sum())
    rows = (tmp_path / "b.ply").read_text().split("end_header\n")[1].splitlines()
    assert len(rows) == count


def test_voxel_downsample_matches_jax():
    rng = np.random.default_rng(2)
    pts = rng.normal(0, 3, (2000, 3)).astype(np.float32)
    p, j = voxel_downsample(pts, 0.5), jax_downsample(pts, 0.5)
    assert p.dtype == np.float32 and 100 < len(p) < 2000
    np.testing.assert_allclose(p, j, atol=1e-6, rtol=0)
    assert voxel_downsample(np.zeros((0, 3), np.float32)).shape == (0, 3)


def test_stage_timer_and_profile_trace(tmp_path):
    timer = StageTimer()
    for _ in range(3):
        with timer.stage("a", sync_fn=lambda: {"x": [torch.ones(2)]}):
            time.sleep(0.002)
    timer.tic("b")
    assert timer.toc("b", sync=torch.zeros(1)) >= 0.0
    s = timer.summary()
    assert s["a"]["count"] == 3 and s["a"]["total_s"] >= 0.006 and s["b"]["count"] == 1
    assert s["a"]["mean_ms"] == pytest.approx(1e3 * s["a"]["total_s"] / 3)
    with profile_trace(os.fspath(tmp_path / "prof")) as prof:
        torch.ones(64).cumsum(0).sum()
    assert any("cumsum" in e.key for e in prof.key_averages())
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert any("cumsum" in e.get("name", "") for e in trace["traceEvents"])


def test_checked_catches_a_masked_nan():
    def masked(x):
        # log(x - 2) is NaN for x < 2; the where() masks it out of the output
        return torch.where(x > 5, torch.log(x - 2), torch.zeros_like(x))

    x = torch.tensor([1.0, 10.0])
    assert torch.isfinite(masked(x)).all()          # unseen without the guard
    with pytest.raises(FloatingPointError, match="aten.log"):
        checked(masked)(x)
    with pytest.raises(FloatingPointError, match="aten.reciprocal|aten.div"):
        checked(lambda t: 1.0 / t)(torch.zeros(3))
    # finite work passes and returns fn's value; NaN already in an input is
    # not the op's doing
    np.testing.assert_array_equal(checked(masked)(torch.tensor([6.0])).numpy(),
                                  np.log([4.0]).astype(np.float32))
    assert torch.isnan(checked(lambda t: t + 1)(torch.tensor([float("nan")]))).all()
    assert checked(lambda: torch.empty(4).fill_(1.0).sum())() == 4.0


def test_assert_finite_tree_matches_jax():
    def tree(lib):
        return {"b": [1.0, lib.asarray([0.0, np.nan, np.inf], dtype=lib.float32)],
                "a": lib.ones(2, dtype=lib.float32)}

    for name, port_tree, jax_tree in (
            ("tree", {"b": [1.0, torch.tensor([0.0, np.nan, np.inf])], "a": torch.ones(2)},
             tree(jnp)),
            ("t", [np.ones(2, np.float32), (np.asarray([np.nan], np.float32),)],
             [np.ones(2, np.float32), (np.asarray([np.nan], np.float32),)])):
        msgs = []
        for fn, t in ((assert_finite_tree, port_tree), (jax_assert_finite, jax_tree)):
            with pytest.raises(FloatingPointError) as e:
                fn(t, name)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    assert msgs[0] == "t[1][0]: 1 non-finite values"
    assert_finite_tree({"a": torch.ones(3), "n": None, "i": torch.arange(3)})


def _scan_pair(n=6, **edit):
    rng = np.random.default_rng(3)
    xyz = rng.normal(0, 5, (n, 3)).astype(np.float32)
    p = RadarScan.from_arrays(xyz, max_points=8)
    j = JaxScan.from_arrays(xyz, max_points=8)
    for f, v in edit.items():
        p = dataclasses.replace(p, **{f: torch.as_tensor(v)})
        j = j.replace(**{f: jnp.asarray(v)})
    return p, j


@pytest.mark.parametrize("edit,err", [
    ({}, None),
    ({"doppler": np.zeros(7, np.float32)}, ValueError),
    ({"mask": np.full(8, 0.5, np.float32)}, ValueError),
    ({"xyz": np.where(np.arange(8)[:, None] == 2, np.nan, 1.0).astype(np.float32)},
     FloatingPointError),
    ({"xyz": np.where(np.arange(8)[:, None] == 7, np.nan, 1.0).astype(np.float32)}, None),
])
def test_validate_scan_matches_jax(edit, err):
    p, j = _scan_pair(**edit)
    if err is None:
        validate_scan(p)
        jax_validate_scan(j)
        return
    msgs = []
    for fn, s in ((validate_scan, p), (jax_validate_scan, j)):
        with pytest.raises(err) as e:
            fn(s, "frame")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
