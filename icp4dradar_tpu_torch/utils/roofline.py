"""Analytic roofline of the port's kernels on an NVIDIA H100 (PyTorch port
of `icp4dradar_tpu/utils/roofline.py`, with the card's limits in place of
the TPU v5e's).

A kernel's work is counted once, and a measured time is set against the
walls it could meet:

- FP32: 67 TFLOP/s, the H100 SXM's FP32 peak (NVIDIA's data sheet, 700 W).
  The port runs every geometry operation in IEEE float32 with no
  reduced-precision dot, so the JAX model's VPU and MXU operations are one
  count here: FP32 operations.
- HBM: 3.35 TB/s, the H100 SXM's memory rate.
- Launch: launches x a launch floor, the time the card takes to start one
  kernel, which `measure_hot_kernels` (and `chip_smoke.py`) measure on the
  card; it replaces the TPU's fixed cost per gather/scatter/sort dispatch.

Two kinds of model live here.

- The JAX package's models, with its work counts per point pair and per
  point over its padded tile grid (`nn_kernel_roofline`: 13 operations a
  pair; `vgicp_sweep_roofline`: 12 + 20 a pair and 300 a source;
  `insert_roofline`: 60 a point and a fixed launch count).
- The bound column of `PERF.md` and `chip_smoke.py`'s kernel rows: the
  least time for the work a call's data needs (the live pairs, not the
  padded grid), each input read once and each output written once:
  `icp_moments_bound` (K1), `vgicp_sweep_bound` (K4), `nn_search_bound`
  (K2, K3), `nn_pack_bound` (K2's packing), `vgicp_frozen_bound` (K5)
  and `gn_step_bound` (the GN step).
  Compares are not counted: a pair's squared distance is 3 subtractions
  and 3 multiply-adds, 9 operations.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence, Tuple

# ---- the H100 SXM (NVIDIA's data sheet, at its 700 W limit) ----
H100_FP32_TFLOPS = 67.0
H100_HBM_GBPS = 3350.0
# FP32 issue slots: 132 SMs x 128 lanes at the 1.98 GHz boost clock; an
# operation that may not contract (the kernels build with -fmad=false)
# takes a slot each
H100_FP32_SLOTS_PER_S = 132 * 128 * 1.98e9

# operations a unit of work, for the bound models (compares not counted)
PAIR_D2_OPS = 9               # 3 sub, 3 mul, 3 add
VGICP_OPS_PER_SOURCE = 300    # p = R s + t and the Mahalanobis GN epilogue
FROZEN_OPS_PER_SOURCE = 320   # p = R s + t, the fresh distance, the GN epilogue
ICP_MOMENTS_OUT = 19          # K1's moment sums a pair
VGICP_ACC_OUT = 30            # K4's H (21), g (6), cost, sum w, sum w d2
FROZEN_OUT = 45               # K5's finished values a group
# the damped GN step a frame (`csrc/gn_step.cu`): H + lm I 72, -g 6, the
# Schur solve 287, |xi| 6, se3_exp 165 (sin, cos, sqrt one each), exp(xi) T
# 128, sum |xi| 9
GN_STEP_OPS_PER_FRAME = 673


@dataclass(frozen=True)
class KernelRoofline:
    """One kernel's analytic work -> its walls and, against a measured
    time, its share of the binding one."""

    name: str
    fp32_ops: float = 0.0
    hbm_bytes: float = 0.0
    launches: int = 0

    def walls(self, launch_floor_ms: float = 0.0) -> dict:
        """Seconds on each wall: FP32, HBM and launches x the floor."""
        return {"FP32": self.fp32_ops / (H100_FP32_TFLOPS * 1e12),
                "HBM BW": self.hbm_bytes / (H100_HBM_GBPS * 1e9),
                "launch": self.launches * launch_floor_ms * 1e-3}

    def bound(self) -> Tuple[float, str]:
        """(ms, "bytes" or "operations"): the larger of the bytes over the
        memory rate and the operations over the FP32 peak, the least time
        the card could take (launches not counted)."""
        w = self.walls()
        t_bytes, t_ops = w["HBM BW"], w["FP32"]
        return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")

    def report(self, measured_s: float, launch_floor_ms: float = 0.0) -> dict:
        """Achieved rates against the peaks, and the binding wall."""
        walls = self.walls(launch_floor_ms)
        wall, wall_t = max(walls.items(), key=lambda kv: kv[1])
        out = {
            "kernel": self.name,
            "measured_ms": round(measured_s * 1e3, 4),
            "bound_by": wall,
            # the share of the binding wall's time: how close the kernel
            # runs to the speed of light of its dominant resource
            "roofline_fraction": round(wall_t / measured_s, 4) if measured_s > 0 else 0.0,
            "speed_of_light_ms": round(wall_t * 1e3, 5),
        }
        if self.fp32_ops:
            out["achieved_fp32_tflops"] = round(self.fp32_ops / measured_s / 1e12, 4)
            out["fp32_peak_fraction"] = round(walls["FP32"] / measured_s, 4)
        if self.hbm_bytes:
            out["achieved_gbps"] = round(self.hbm_bytes / measured_s / 1e9, 2)
            out["hbm_peak_fraction"] = round(walls["HBM BW"] / measured_s, 4)
        if self.launches:
            out["launches"] = self.launches
            out["ms_per_launch"] = round(measured_s * 1e3 / self.launches, 4)
        return out


def slot_floor_ms(ops: float) -> float:
    """The time `ops` FP32 operations take at one issue slot each."""
    return ops / H100_FP32_SLOTS_PER_S * 1e3


# ---- the JAX package's models (its counts per pair and per point) ----

def nn_kernel_roofline(n: int, m: int, ts: int = 512, tm: int = 2048) -> KernelRoofline:
    """Brute-force 1-NN sweep over the padded tile grid: 13 operations a
    pair (the d2 sum 9, the penalty 1, the minimum 1, the argmin 2); the
    sources re-read per target tile, the targets per source block."""
    np_ = n + (-n) % min(ts, max(8, n))
    mp_ = m + (-m) % tm
    pairs = float(np_) * mp_
    ns, nt = np_ // min(ts, max(8, n)), mp_ // tm
    return KernelRoofline("nn_sweep", fp32_ops=13.0 * pairs,
                          hbm_bytes=nt * np_ * 12.0 + ns * mp_ * 16.0, launches=1)


def vgicp_sweep_roofline(n: int, m: int, ts: int = 2048, tm: int = 1024) -> KernelRoofline:
    """One fused VGICP sweep + GN pass over the padded tile grid: 12
    elementwise and 20 payload-contraction operations a pair, 300 a source
    for the GN tail; 10- and 11-column payloads re-read per tile."""
    ts = min(ts, max(8, n))
    np_ = n + (-n) % ts
    tmt = min(tm, m + (-m) % 8)
    mp_ = m + (-m) % tmt
    pairs = float(np_) * mp_
    ns, nt = np_ // ts, mp_ // tmt
    return KernelRoofline("vgicp_sweep", fp32_ops=32.0 * pairs + 300.0 * np_,
                          hbm_bytes=nt * np_ * 40.0 + ns * mp_ * 44.0, launches=1)


def insert_roofline(n: int, capacity: int, max_probes: int = 8,
                    window: int = 4) -> KernelRoofline:
    """Batched voxel-hash insert: a launch-count model (one sort, ~4
    gathers/scatters a probe round, ~6 deposit scatters); the bytes are
    the touched rows, far under the memory wall."""
    rounds = math.ceil(max_probes / window)
    return KernelRoofline("voxel_insert", fp32_ops=60.0 * n,
                          hbm_bytes=n * (11 * 4 + window * 12) + n * 10 * 4,
                          launches=1 + 4 * rounds + 6)


# ---- the bound models of the port's kernels (the data's live work) ----

def icp_moments_bound(pairs: int, n: int, m: int, live_pairs: int) -> KernelRoofline:
    """K1 (`csrc/icp_moments.cu`), one iteration over `pairs` cloud pairs of
    n sources and m targets: T, xyz and masks of both clouds read once, 19
    sums a pair out; 9 operations a live point pair."""
    return KernelRoofline(
        "icp_moments", fp32_ops=PAIR_D2_OPS * float(live_pairs),
        hbm_bytes=4.0 * (16 * pairs + 4 * pairs * n + 4 * pairs * m + ICP_MOMENTS_OUT * pairs),
        launches=1)


def vgicp_sweep_bound(frames: int, n: int, live_rows: Sequence[int]) -> KernelRoofline:
    """K4 (`csrc/vgicp_sweep.cu` `vgicp_sweep_launch`): `frames` frames of n
    sources a stream, against one target set a stream whose live rows are
    `live_rows` (one count a stream): T, the sources (xyz, mask, cov6), the
    live target rows (mean, cov6, mask) and the counts read once, 30 sums a
    frame out; 9 operations a live pair and 300 a source."""
    S, live = len(live_rows), float(sum(live_rows))
    F = frames * S
    return KernelRoofline(
        "vgicp_sweep",
        fp32_ops=PAIR_D2_OPS * frames * n * live + VGICP_OPS_PER_SOURCE * F * n,
        hbm_bytes=4.0 * (16 * F + 10 * F * n + 10 * live + S + VGICP_ACC_OUT * F), launches=1)


def nn_search_bound(n: int, m: int, live_rows: Sequence[int],
                    coords: bool = False) -> KernelRoofline:
    """K2 (`csrc/nn_search.cu` `nn_search_launch`) a stream of n sources
    against m target rows, `live_rows` of them live (one count a stream):
    sources, every target row and its mask read once, (index, d2) out, or
    (d2, coordinates) for K3 (`coords`); 9 operations a live pair."""
    S = len(live_rows)
    out = 4 if coords else 2
    return KernelRoofline("nn_coords" if coords else "nn_search",
                          fp32_ops=PAIR_D2_OPS * n * float(sum(live_rows)),
                          hbm_bytes=4.0 * S * (3 * n + 4 * m + out * n), launches=1)


def nn_pack_bound(m: int, streams: int = 1) -> KernelRoofline:
    """K2's packing (`nn_pack_launch`): targets and masks read once; rows,
    original indices and the live count written."""
    return KernelRoofline("nn_pack", hbm_bytes=4.0 * streams * (4 * m + 5 * m + 1), launches=1)


def vgicp_frozen_bound(n: int, groups: int = 1) -> KernelRoofline:
    """K5 (`vgicp_frozen_launch`): T, the sources (xyz, mask, cov6) and the
    (10, n) matched payload read once, 45 finished values a group out; 320
    operations a source."""
    return KernelRoofline(
        "vgicp_frozen", fp32_ops=FROZEN_OPS_PER_SOURCE * float(n),
        hbm_bytes=4.0 * (16 * groups + 10 * n + 10 * n + FROZEN_OUT * groups), launches=1)


def gn_step_bound(n: int) -> KernelRoofline:
    """The GN step (`csrc/gn_step.cu` `gn_step_launch`) for n frames: T
    (16 floats), H (36), g (6) and the active byte read once, T (16) and
    dlt (1) written: 301 bytes and 673 operations a frame."""
    return KernelRoofline("gn_step", fp32_ops=GN_STEP_OPS_PER_FRAME * float(n),
                          hbm_bytes=n * (4.0 * (16 + 36 + 6 + 16 + 1) + 1), launches=1)


# ---- measurement on the card ----

def _time_cuda(torch, fn, reps: int) -> float:
    """Mean seconds a call of fn, CUDA events around `reps` calls after two
    warm-up calls."""
    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e-3 / reps


def measure_launch_floor_ms(device="cuda", reps: int = 200) -> float:
    """The card's launch floor: ms a launch of a one-element kernel,
    launched back to back (CUDA events)."""
    import torch

    x = torch.zeros(1, device=device)
    return _time_cuda(torch, lambda: x.add_(1.0), reps) * 1e3


def measure_hot_kernels(device="cuda", reps: int = 64, n: int = 2048, m: int = 16384,
                        capacity: int = 1 << 18) -> list:
    """Time the three hot paths on the card, each with CUDA events over
    `reps` calls on operands made once, and return their roofline reports
    against the models above (the launch floor measured first, its ms in
    every report): K2's 1-NN search (n sources against m live targets), K4's
    sweep (one frame of n sources against m live voxels) and the voxel
    insert (n points into a map of `capacity` slots). Raises without a
    CUDA device: the models' walls are the card's."""
    import torch

    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"measure_hot_kernels times the card's kernels; got device "
                           f"{device} (CUDA available: {torch.cuda.is_available()})")
    from icp4dradar_tpu_torch.mapping import voxel_map_create, voxel_map_insert
    from icp4dradar_tpu_torch.ops.knn import nn_prepare, nn_search
    from icp4dradar_tpu_torch.ops.vgicp_fused import (
        radar_point_covariances_packed,
        vgicp_prepare,
        vgicp_sweep,
    )

    floor_ms = measure_launch_floor_ms(device)
    g = torch.Generator(device=device).manual_seed(0)
    src = torch.rand((n, 3), generator=g, device=device) * 80.0 - 40.0
    tgt = torch.rand((m, 3), generator=g, device=device) * 80.0 - 40.0
    ones_n, ones_m = torch.ones(n, device=device), torch.ones(m, device=device)
    cov6 = radar_point_covariances_packed(src)
    tcov6 = torch.tensor([0.05, 0.05, 0.05, 0.0, 0.0, 0.0], device=device).expand(m, 6)
    T0 = torch.eye(4, device=device)
    nn_ops = nn_prepare(tgt, ones_m)
    vg_ops = vgicp_prepare(src, ones_n, cov6, tgt, tcov6.contiguous(), ones_m)
    vm0 = voxel_map_create(capacity, 0.5, 8, device=device)
    reports = []
    for model, fn in (
            (nn_search_bound(n, m, [m]), lambda: nn_search(src, nn_ops)),
            (vgicp_sweep_bound(1, n, [m]), lambda: vgicp_sweep(T0, vg_ops)),
            (insert_roofline(n, capacity), lambda: voxel_map_insert(vm0, src, ones_n))):
        rep = model.report(_time_cuda(torch, fn, reps), floor_ms)
        rep["launch_floor_ms"] = round(floor_ms, 5)
        rep["reps"] = reps
        reports.append(rep)
    return reports


def format_report(rep: dict) -> str:
    extra = []
    if "achieved_fp32_tflops" in rep:
        extra.append(f"FP32 {rep['achieved_fp32_tflops']} TF/s "
                     f"({rep['fp32_peak_fraction']:.1%} of peak)")
    if "achieved_gbps" in rep:
        extra.append(f"HBM {rep['achieved_gbps']} GB/s ({rep['hbm_peak_fraction']:.1%})")
    if "launches" in rep:
        extra.append(f"{rep['launches']} launches @ {rep['ms_per_launch']} ms")
    return (f"{rep['kernel']}: {rep['measured_ms']} ms, bound by {rep['bound_by']} "
            f"(speed-of-light {rep['speed_of_light_ms']} ms, {rep['roofline_fraction']:.1%} "
            f"of it) - " + "; ".join(extra))
