"""The port's roofline module (`icp4dradar_tpu_torch/utils/roofline.py`)
against the JAX package's (`icp4dradar_tpu/utils/roofline.py`, read on the
CPU): the same work counts per pair and per point for the same arguments
(the JAX model's VPU and MXU operations summed into FP32 operations, its
fixed ops the port's launches); the walls at the H100's limits and the one
that binds; `measure_hot_kernels` refusing to run without a card;
`chip_smoke.py`'s bounds coming from the module; and
`setup_compilation_cache` off the card."""

import pytest

from icp4dradar_tpu.utils import roofline as jr
from icp4dradar_tpu_torch.utils import roofline as pr
from icp4dradar_tpu_torch.utils.cache import setup_compilation_cache

SHAPES = [(2048, 2048), (2048, 16384), (512, 4096), (100, 1000), (16384, 16384), (7, 9)]


@pytest.mark.parametrize("n,m", SHAPES)
def test_work_counts_match_jax(n, m):
    for pf, jf, kw in ((pr.nn_kernel_roofline, jr.nn_kernel_roofline, {}),
                       (pr.nn_kernel_roofline, jr.nn_kernel_roofline, dict(ts=256, tm=1024)),
                       (pr.vgicp_sweep_roofline, jr.vgicp_sweep_roofline, {}),
                       (pr.vgicp_sweep_roofline, jr.vgicp_sweep_roofline, dict(ts=512, tm=256))):
        p, j = pf(n, m, **kw), jf(n, m, **kw)
        assert p.fp32_ops == j.vpu_flops + j.mxu_flops, (pf.__name__, kw)
        assert p.hbm_bytes == j.hbm_bytes, (pf.__name__, kw)
        assert p.launches == 1 and j.fixed_ops == 0
    for probes, window in ((8, 4), (8, 8), (12, 4)):
        p, j = pr.insert_roofline(n, 1 << 18, probes, window), \
            jr.insert_roofline(n, 1 << 18, probes, window)
        assert (p.fp32_ops, p.hbm_bytes, p.launches) == (j.vpu_flops, j.hbm_bytes, j.fixed_ops)


def test_walls_and_the_binding_one():
    """One second of each wall at the H100's limits; the wall that binds
    names the report; the bound models of the kernel rows bind where their
    work says (K4 and K2 on operations at the path's shapes, the packing on
    bytes), and a launch floor above both walls binds a one-launch call."""
    assert pr.KernelRoofline("b", hbm_bytes=pr.H100_HBM_GBPS * 1e9).bound() == (1e3, "bytes")
    assert pr.KernelRoofline("o", fp32_ops=pr.H100_FP32_TFLOPS * 1e12).bound() == \
        (1e3, "operations")
    k4 = pr.vgicp_sweep_bound(8, 2048, [801])
    ms, by = k4.bound()
    assert by == "operations"
    assert ms == pytest.approx((9 * 8 * 2048 * 801 + 300 * 8 * 2048) / 67e12 * 1e3)
    assert pr.nn_search_bound(2048, 16384, [542]).bound()[1] == "operations"
    assert pr.nn_pack_bound(16384).bound() == (4 * (9 * 16384 + 1) / 3.35e12 * 1e3, "bytes")
    rep = k4.report(1e-4)
    assert rep["bound_by"] == "FP32"
    assert rep["roofline_fraction"] == pytest.approx(ms / 0.1, abs=1e-4)
    assert k4.report(1e-4, launch_floor_ms=0.05)["bound_by"] == "launch"
    ins = pr.insert_roofline(2048, 1 << 18)
    rep = ins.report(1e-3, launch_floor_ms=0.005)
    assert rep["bound_by"] == "launch" and rep["launches"] == 15
    assert "15 launches" in pr.format_report(rep)
    # two streams' sweep: each stream's frames meet its own live rows only
    two = pr.vgicp_sweep_bound(8, 2048, [801, 1200])
    assert two.fp32_ops == 9 * 8 * 2048 * 2001 + 300 * 16 * 2048
    k1 = pr.icp_moments_bound(1024, 2048, 2048, 1000)
    assert k1.hbm_bytes == 4 * (16 * 1024 + 4 * 1024 * 2048 * 2 + 19 * 1024)
    assert pr.slot_floor_ms(pr.H100_FP32_SLOTS_PER_S) == 1e3
    assert pr.vgicp_frozen_bound(2048).bound()[1] == "bytes"        # PERF.md: 0.000049 ms
    gn = pr.gn_step_bound(128)                     # 301 bytes a frame, bound by them
    assert gn.hbm_bytes == 128 * 301 and gn.bound()[1] == "bytes"


def test_measure_hot_kernels_needs_the_card():
    with pytest.raises(RuntimeError, match="card"):
        pr.measure_hot_kernels("cpu")


def test_chip_smoke_bounds_come_from_the_module():
    """`chip_smoke.py` keeps no peak or work count of its own: every bound
    it reports is a model of the module."""
    import pathlib
    import re

    src = (pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py").read_text()
    assert not re.search(r"PEAK_|FLOPS_PER|SLOTS_PER_S|3\.35e12|67e12", src)
    assert "from icp4dradar_tpu_torch.utils import roofline as rl" in src
    bounds = re.findall(r"(\w*b\w*_ms), \w+ = (.+)", src)
    assert len(bounds) >= 10
    for name, rhs in bounds:
        assert rhs.endswith(".bound()"), (name, rhs)      # a KernelRoofline of the module


def test_setup_compilation_cache_off_the_card():
    """Without a CUDA device (these tests' CPU) there is nothing to cache, as
    the JAX package's returns "" off the TPU."""
    assert setup_compilation_cache() == ""
