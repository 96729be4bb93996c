"""The benchmark's roofline yardstick: the least time an NVIDIA H100 SXM
could take for the work a kernel launch's inputs need.

Frozen copy of the operation and byte counts of
`icp4dradar_tpu_torch/utils/roofline.py` (:36-48, :150-171:
`icp_moments_bound`, `vgicp_sweep_bound`), without its launch-floor wall
(a host quantity, not part of a roofline). The peaks are NVIDIA's data
sheet figures at the card's 700 W limit: FP32 67 TFLOP/s outside the
tensor cores, HBM3 3.35 TB/s. A launch's bound is the larger of its
operations over the FP32 peak and its bytes over the memory rate;
compares are not counted, so a pair's squared distance is 9 operations.

The launches themselves are read back from the outputs the timed path
returns: which pairs or frames each GN or ICP iteration swept follows from
the per-pair or per-frame iteration counts.
"""

from __future__ import annotations

from typing import List, Sequence

FP32_FLOPS = 67.0e12
HBM_BYTES_PER_S = 3.35e12

PAIR_D2_OPS = 9               # 3 sub, 3 mul, 3 add
VGICP_OPS_PER_SOURCE = 300    # p = R s + t and the Mahalanobis GN epilogue
ICP_MOMENTS_OUT = 19          # K1's moment sums a pair
VGICP_ACC_OUT = 30            # K4's H (21), g (6), cost, sum w, sum w d2


def bound_s(ops: float, nbytes: float) -> float:
    return max(ops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S)


def icp_moments_bound_s(pairs: int, n: int, m: int, live_pairs: float) -> float:
    """K1 (`csrc/icp_moments.cu`), one launch over `pairs` cloud pairs of n
    sources and m targets: T, xyz and masks of both clouds read once, 19
    sums a pair out; 9 operations a live point pair."""
    return bound_s(PAIR_D2_OPS * float(live_pairs),
                   4.0 * (16 * pairs + 4 * pairs * n + 4 * pairs * m + ICP_MOMENTS_OUT * pairs))


def vgicp_sweep_bound_s(frames: int, n: int, live_rows: Sequence[int]) -> float:
    """K4 (`csrc/vgicp_sweep.cu`), one launch: `frames` frames of n sources
    a stream, each stream against its own target set with `live_rows` live
    rows (one count a stream): T, the sources (xyz, mask, cov6), the live
    target rows (mean, cov6, mask) and the counts read once, 30 sums a
    frame out; 9 operations a live pair and 300 a source."""
    S, live = len(live_rows), float(sum(live_rows))
    F = frames * S
    return bound_s(PAIR_D2_OPS * frames * n * live + VGICP_OPS_PER_SOURCE * F * n,
                   4.0 * (16 * F + 10 * F * n + 10 * live + S + VGICP_ACC_OUT * F))


def icp_launches_bound_s(iterations: Sequence[int], live_src: Sequence[int],
                         live_tgt: Sequence[int], n: int, m: int) -> float:
    """The bound of every K1 launch of one batched ICP call
    (`registration/icp.py`): iteration k sweeps the pairs whose final
    iteration count exceeds k, one launch an iteration until none is
    active, then one fitness launch sweeps every pair."""
    its = list(iterations)
    lp = [float(a) * float(b) for a, b in zip(live_src, live_tgt)]
    total = 0.0
    for k in range(max(its, default=0)):
        act = [i for i, it in enumerate(its) if it > k]
        total += icp_moments_bound_s(len(act), n, m, sum(lp[i] for i in act))
    return total + icp_moments_bound_s(len(its), n, m, sum(lp))


def vgicp_launches_bound_s(iterations, submap_points, n: int, groups: List[slice]) -> float:
    """The bound of every K4 launch of a tracker's run: `iterations` and
    `submap_points` are (B, F) nested lists of the outputs, `groups` the
    frame slices that register together (one frame of the per-frame
    tracker, a block of the blocked one). A group's GN runs one sweep of
    all its B x frames an iteration until no frame is active: as many
    launches as its largest iteration count."""
    total = 0.0
    for g in groups:
        launches = max(max(row[g]) for row in iterations)
        live = [int(row[g][0]) for row in submap_points]
        frames = len(range(*g.indices(len(iterations[0]))))
        total += launches * vgicp_sweep_bound_s(frames, n, live)
    return total
