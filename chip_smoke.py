#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (`icp4dradar_tpu_torch`) on one
NVIDIA GPU: the quickest proof that the port builds, agrees with its plain
versions and runs its main path at full size.

    python3 chip_smoke.py [--parent DIR]

Phases (any failure exits non-zero; nothing is caught and ignored):
1. device  — requires CUDA; prints torch/CUDA versions and the card's name
             and power limit (nvidia-smi).
2. build   — compiles csrc/*.cu with nvcc (sm_90a) and prints the seconds
             and the ptxas resource report per kernel (registers, shared
             memory, spills).
3. kernel  — the ICP-moments kernel against its plain PyTorch version on the
             card: 8 bench pairs (2048 x 2048) under random poses, the same
             pairs with two marked inactive (zero rows, the active rows
             identical to the call without the mask), a ragged case with
             random masks, a pair whose targets are all masked and one
             with no valid source, exact ties (two, and four in one pair
             across the kernel's chunks), the multi-tile shape of the
             local-map pass (8 pairs x 4096 x 4096: ties across the
             2048-row tile boundary, over both tiles and first in the
             second tile, and a pair with 2049 live targets among masked
             rows, each tie's average exact), and the full bench batch (1024
             pairs; clouds prepared once against the per-call path);
             tolerance rtol 1e-4 / atol 1e-3 on every moment. Times both at
             1024 x 2048 x 2048 (one ICP iteration on prepared clouds; CUDA
             events, median of 10, in turns plain / kernel / kernel /
             plain) and prints the share of the FP32 bound and of the
             slot floor (9 slots a pair at 1.98 GHz on 132 SMs x 128
             lanes) it reaches, over all pairs and over the live pairs.
4. slice   — the bench sequence of `bench.py` (1024 frames x 2048 points,
             5000 landmarks, seed 0) through
             run_scan_to_scan(use_doppler_prior=True): warm-up, then one
             timed run with the kernel launch count reset just before and
             read just after (launches must equal ICP iterations + 1). Fails
             on non-finite outputs, on any rejected frame, or on an ATE
             (align=False) outside 1.976 +- 0.05 m. Prints the pairs still
             active at each ICP iteration (the kernel sweeps only those).
             Also checks that the CUDA path agrees with the CPU path on a
             16-frame x 256-point input.
4b. local map — local_map_refinement over phase 4's track: 68 windows of
             15 frames subsampled to 4096 points, 67 pairs x 4096 x 4096 in
             one batched ICP (K1's multi-tile path), launches counted (must
             equal ICP iterations + 1); the corrections of pairs 0, 22, 44
             and 66 run again on the CPU (the plain version; all 67 take ~4
             min there) within 1e-4 with equal iterations. Prints one K1
             iteration at this shape (CUDA events, median of 10) beside its
             FP32 bound (0.151 ms) and slot floor (0.302 ms), its plain
             version and the whole pass.
4c. pose graph — run_pose_graph_odometry(keyframe_every=4, loop_radius=8,
             min_loop_gap=20, max_loop_candidates=24) on the figure-eight of
             scripts/eval_suite.py (128 frames x 2048 points, 6000
             landmarks, two opposite-turn laps; 32 keyframes) on the JAX
             package's draws (`utils.threefry`): the s2s front end
             (warm-up, then one timed run with K1's count set to 0 just
             before and read just after), its loop-closure ICP (all
             candidates in one batched call on K1, its own count set to 0
             just before it: launches must equal its iterations + 1;
             candidates, pairs swept per launch and the call's ms), a
             fabricated closure between keyframes 2 and K-4 10 m off (the
             refined ATE within 0.5 m of the clean run's, the factor
             dropped), and the s2m front end with structure factors (one
             run, K4's count read over it; 4c runs after phase 5, whose
             s2m run warms that path). Each run's closures within 1
             of the JAX CPU run's (scripts/port_pose_graph_reference.py),
             its refined ATE (align=False) within 0.05 m of JAX's (or,
             where the odometry itself differs from JAX's by more than
             0.03 m, the refinement's gain within 0.05 m of JAX's) and at
             most its odometry's x 1.05. Then the block solver on the K =
             512 long chain of tests/test_graph.py (20 GN iterations at
             most) on the card and on the CPU: poses within 1e-3 m of each
             other and 0.05 m of the truth; wall ms, GN and PCG iterations,
             and one GN iteration's kernel launches and host syncs
             (profiler). Last, dense against block on the card at K = 32
             with every factor type: positions within 1e-4 m.
5. s2m     — the scan-to-map bench cell of `bench.py` (the first 256 frames
             of the same sequence) through run_scan_to_map_blocked(block=8,
             use_const_velocity_rot=True): warm-up, then one timed run with
             the VGICP sweep launch count reset just before and read just
             after. It must equal the sum of the warm-up frames' GN sweeps
             plus, per block, the largest sweep count of its 8 frames (no
             block may fall back to the sequential re-track). Fails on
             non-finite outputs, on a lost frame (fitness 1e6) or on an ATE
             (align=False) outside 0.034 +- 0.01 m. The GN step's launches
             (`gn_step`), counted over the same run, must equal its K4
             sweeps (plus any K5 steps). A third run prints the
             host-clock phase split (REVE, sorts, sector query, GN loop,
             insert). Also checks CUDA against CPU on a 24 x 256 input, and
             runs the map API (radius and box searches, box delete and its
             acquiring form, box re-add, point delete, a maybe_rehash of
             the deletes' tombstones) on the final map (capacity 2^18) on
             the card and on the CPU: tables, points, masks and counts
             equal.
5c. session — OdometrySession at full width (the first 256 bench frames,
             2048 points, capacity 2^18, submap 2^14): frames 0-7 through
             `process`, then 31 `process_batch(block=8)` calls,
             checkpointed after frame 128, K4 launches counted per call
             (a process frame's sweeps; a healthy batch's largest; a batch
             that falls back to the sequential re-track, its re-track's
             sweeps plus a joint GN of 1 to 64); ATE within 0.01 m of the
             JAX CPU run of the
             same schedule on the same keys
             (scripts/port_session_reference.py, 0.03346 m). A second
             session resumes from the file and feeds frames 128-255: its
             poses, final pose and tables equal, bit for bit. An all-NaN
             scan is absorbed and a step whose pose goes non-finite
             (injected) is skipped, the state kept bit for bit. Prints the
             `process` and `process_batch` scans/s with the card's name and
             power limit.
5b. batch  — B-stream serving, `bench.py`'s third cell: 4 streams, stream b
             the frames [256 b, 256 b + 256) of the bench sequence, through
             run_scan_to_map_batch(block=8, use_const_velocity_rot=True),
             2048 points, map capacity 2^18 a stream, on the REVE draws
             of the JAX package's run of the same batch (its Threefry keys,
             `utils.threefry`): warm-up, then one
             timed run with the sweep launch count reset just before and
             read just after. It must equal, summed over the warm-up frames,
             the largest sweep count across streams, plus per block the
             largest count of its 4 x 8 frames; the GN step's launches,
             counted with it, must equal the K4 sweeps. Fails on a lost frame, on
             non-finite outputs, or on a stream whose ATE (align=False,
             against its ground truth re-anchored at its first frame) lies
             outside the JAX CPU run's for that stream
             (scripts/port_batch_reference.py) +- 0.01 m. Prints the
             aggregate scans/s beside phase 5's single-stream figure and a
             phase split; holds stream 0 against its single-stream run on
             the card (a batch of one): every output and table equal, bit
             for bit, or else positions within 1e-5 m with equal sweeps and
             tables (the first frame and output that differ are printed);
             forgets (40 m) and rehashes
             the final maps on the card and on the CPU: equal tables.
6. vgicp   — the VGICP sweep kernel against its plain PyTorch version on
             the card: the bench block (8 frames x 2048 points against a
             real 16,384-row submap of the warm map of phase 5), a fully
             live 16,384-row submap, a ragged masked case, exact ties within
             and across target tiles, three-way ties across the kernel's row
             ranges with masked rows between them, and an empty submap;
             tolerance rtol 1e-5 / atol 1e-4 on every output; the operands
             prepared once against the per-call path (equal). Times at the
             bench block (CUDA events, median of 10, in turns): the plain
             version, the per-call wrapper (packing included), the call the
             GN loop makes on prepared operands, and the launch alone.
             With its stream axis, at the batch cell's block shape (4
             streams x 8 frames against the 4 streams' real submaps of
             phase 5b's final maps, and again with one stream's submap
             empty): against plain and against 4 single-target calls (bit
             for bit expected; a difference is printed and must stay below
             1e-6 relative); the batched call must be one
             vgicp_sweep_kernel launch with no host sync, and is timed
             against the 4 single-target calls.
7. gicp    — the kNN-GICP tracker: the first 64 frames of the bench
             sequence through run_scan_to_map(gicp.use_vgicp=False,
             use_const_velocity_rot=True): warm-up, then one timed run with
             the 1-NN launch counts reset just before and read just after
             (searches must equal the GN iterations plus one fitness
             search per frame, packings one per frame). Fails on
             non-finite outputs, on a lost frame (fitness
             1e6, or nothing matched after the first frame) or on an ATE
             (align=False) above 0.09 m. A third run prints the host-clock
             phase split. At the path shape (the last scan at its tracked
             pose, the sector submap of the final map) the covariances
             over the live rows that gicp_align computes must equal the
             all-rows point_covariances on every live row and be finite.
             A profiled run of the first 16 frames (phase 11's
             `profile_run`) prints the device time and launches a frame
             of the covariances (k-NN included; a
             record_function range around each call), the run's launches
             a frame and its sort kernels; it fails on a sort row (2-D, or with a
             stream axis) as
             wide as the submap, or on nn_merge_kernel or nn_split_kernel
             among its kernels. Also checks CUDA against CPU on a 12 x 256 scene
             whose frames converge below the iteration cap: the tracks'
             ATE within 0.01 m, and the registration alone on identical
             inputs within 5e-3 (its float32 round-off, measured against
             float64 on the CPU).
8. knn     — the 1-NN search (K2: the per-call `nearest_neighbor`, and
             `nn_search` on targets packed once by `nn_prepare`) and its
             coordinate form (K3: `nearest_neighbor_with_coords` and
             `nn_search_coords`) against their plain versions on the card:
             a bench scan at its tracked pose against the 16,384-row sector
             submap of phase 7's final map, a fully live 16,384-row submap,
             a ragged masked case, exact ties within and across cluster
             ranks, all targets masked, and one live row 2e15 m away among
             masked rows (the fallback re-scan: masked row 0 wins);
             indices, distances and coordinates must be equal, and the
             packing kernel's rows equal to its plain version's stable
             sort. K3's path (no pipeline calls it): one prepared and one
             per-call coordinate search at the path shape, counts set to 0
             just before. Times at the path shape (CUDA events, in turns),
             for K2 and K3 each: the call on prepared targets, its one
             launch alone, the per-call form and the plain version; the
             packing and its plain version. A prepared search and a
             prepared coordinate search must each launch one
             nn_search_kernel, and a packing one nn_pack_kernel, and
             nothing else (profiler).
9. inner   — the per-frame VGICP tracker on the same 64 frames, with
             gicp.inner_gn_steps 0 and then 1 (warm-up, then one timed run
             each, counts reset before it): ATE within 0.0252 +- 0.01 m
             without inner steps; with one, frozen-pass launches must equal
             sweep launches, GN iterations their sum, no frame lost, and the
             ATE at most 1.5 x the first run's + 0.005 m.
10. frozen — the frozen-payload GN step (K5) against its plain version on
             the card, on real sweep payloads of phase 9's map (one frame,
             and 8 frames in per-frame groups and in one group) under
             perturbed transforms, with rows marked never matched and an
             empty payload; tolerance rtol 1e-5 / atol 1e-4; two launches
             on the same inputs bit-identical. Times at one 2048-point
             frame: the call on prepared sources, which must launch one
             vgicp_frozen_kernel and nothing else (profiler), and the
             launch alone.
11. profile — one torch.profiler run of the s2s, s2m, batch and
             inner-step trackers (kNN GICP's is in phase 7): device kernel
             time, kernel launches, the top kernels, and the device's idle
             share against the unprofiled run time; the inner-step run lists
             every kernel it launched. The batch's kernel launches over the
             s2m run's must stay below 2 (nothing loops over the streams). Then the host synchronisations (stream / device
             synchronise calls and host-to-device copies) per K4, K5, K2
             and K3 call on prepared operands and per K2 packing, which
             must be none, and per K4 call of the per-call wrapper.
13. host   — the host side on the card: the s2m cell's 256 frames x 2048
             points written as a ROS1 bag (`write_synthetic_bag`:
             ColoRadar fields, /gt and /imu, no compression; seconds and
             MB), and again with bz2 and with lz4 chunks where liblz4
             loads; each read three times by the native streamer and by
             the Python walk, interleaved (identical arrays, `native_used`,
             the MB/s of each, median of 3); `RadarBagDataset` through the
             native streamer (load seconds, one copy a field to the card;
             the points equal the sequence's), its IMU
             batches into `imu_prior_deltas`, and
             run_scan_to_map_blocked(block=8, use_const_velocity_rot=True,
             prior_deltas=...) on the JAX package's REVE draws, K4's count
             set to 0 just before: launches > 0, no lost frame, ATE
             (align=False) within 2e-3 m of the JAX CPU run of the same
             path (scripts/port_bag_reference.py); again without the
             prior, which must track otherwise (other GN sweeps, another
             track), sweeps a frame and scans/s of both. The CLI's
             `--bag --imu-prior --mode scan_to_map --map-interval 8
             --cv-rot --viz --steady-state` run (its seven files, the
             steady-state keys, ATE within 2e-3 m of the library run's
             with the prior and nearer it than the run's without).
             Phase 4's transforms written to output_result.csv and
             replayed (`run_scan_to_scan_replay`), K1's count set to 0
             just before: no launch, velocity bit for bit, the in-memory
             transforms' world_T bit for bit, the file's within 1e-3 m of
             the CPU's prefix product of the file and 2e-3 m of phase 4's
             (six decimals); its ms. 64 frames as `pcd/` through the
             CLI's sniff (finite poses, point counts equal) and as .bin
             through the native loader (equal to numpy and the
             sequence). The phase's seconds, at most 90.
14. knn batch — kNN GICP inside a batch at full width: 4 streams x 16
             frames x 2048 points (stream b the frames [256 b, 256 b + 16)
             of the bench sequence) through the per-frame
             run_scan_to_map_batch with gicp.use_vgicp=False on the JAX
             package's draws, K2's and the packing's counts set to 0 just
             before: the launches (per frame the largest GN iteration count
             across streams, plus one fitness search; one packing a frame)
             against the 4 single-stream runs' sum, each stream against its
             single-stream run bit for bit, scans/s of both; K2 and its
             packing with the stream axis on the batch's own targets (the
             last frame's sector submaps) against their plain versions
             (indices and d2 equal) and 4 single-target calls, timed.
15. parallel — the data-parallel layer under NCCL at world size 1 (a
             FileStore in a temp dir): make_mesh; sharded_scan_to_map_batch
             on phase 9's 4 x 256 VGICP streams against
             run_scan_to_map_batch (bit for bit), batched_preprocess and
             batched_icp_pairs against their single-device functions on
             the same draws made the same way (bit for bit),
             distributed_optimize_pose_graph_block at K = 32 with
             every factor type and run_pose_graph_odometry(mesh=...) on
             phase 4c's figure-eight against the single-device solves
             (1e-4), each pair timed in turns; the all-reduce and all-gather
             alone at the path's payloads; dryrun_multichip(1) in a spawned
             rank (its stages 3, 3b and 3c too: the sharded map, the ring
             normal equations, the 16-frame blocked distributed run).
16. distributed — `run_scan_to_map_distributed` over the s2m cell (256 x
             2048, capacity 2^18, submap 2^14, block 8, cv-rot, JAX's
             draws) under NCCL at world size 1: scans/s in turns with
             run_scan_to_map_blocked, K4's and K5's launch counts over one
             run (each its GN iterations), the ATE against the JAX CPU run
             of scripts/port_distributed_reference.py (+- 0.01 m); the
             sharded map against voxel_map_insert of the recorded batches
             (content), the distributed rehash against voxel_map_rehash
             (tables), one ring pass against vgicp_iteration (1e-4 of the
             largest entry), a save/load round trip; a profiled window (24
             frames); the CLI's --distributed 1 --device cuda on 16
             frames; at most 60 s.
17. accumulate — the sparse-vendor tracking paths at the s2m cell's width
             on JAX's draws: the bench sequence's first 64 frames through
             run_scan_to_map with accumulate_scans=4 (K4 at 8,192
             sources), 16 frames of kNN GICP with accumulate_scans=2 (K2 at
             4,096), the s2m cell through run_scan_to_map_blocked with
             rigid_union=True (K4 at 16,384 sources a block), and the eval
             suite's ti_mmwave sequence (64 frames, matched covariances)
             through the window and the union; each run's K4 / K2 launches
             against its GN sweeps, ATE against the JAX CPU run of
             scripts/port_accumulate_reference.py, scans/s; K4 on a
             16,384-row union and an 8,192-row window and K2 on 4,096
             sources against their plain versions; the roofline module's
             hot-kernel reports with the card's launch floor; at most 60 s.
18. gn step — the GN step kernel (`csrc/gn_step.cu`) against `gn_step_plain`
             on the card at the main path's frame counts (1 and 8, the s2m
             cell's warm-up and blocks; 32, the batch's blocks; 16 and 128,
             the fleet's warm-up and blocks of 16 x 8; 1000), every fifth
             frame inactive, non-finite, inside the Taylor window or 1 rad,
             with and without the mask: T and dlt equal bit for bit, held
             frames unchanged, one launch a call and no host sync; the call
             and its plain version timed at 16 and 128 frames, with the
             kernel's device time, its bound and phases 5 and 5b's launches.
12. ab     — only with `--parent DIR` (a `git archive` of the parent commit
             unpacked at DIR): the K2, K3, K5 and K4 calls of both trees at the
             path shapes (K3 also per call), each tree in its own process,
             in turns (parent, this tree, this tree, parent), with each
             call's kernels and device time (profiler); then phase 7's
             gicp-64 run end to end in the same processes (scans/s).

The kernels' bounds come from the shapes and this run's data through
`icp4dradar_tpu_torch/utils/roofline.py` (bytes over 3.35 TB/s, FP32
operations over 67 TFLOP/s, the H100 SXM data sheet). The
line before the last two is a JSON record of the kernels (K1's row with
phase 4c's `pose_graph_launches` and its loop ICP's `loop_icp_launches`,
`loop_icp_ms` and `loop_icp_pairs`, and phase 13's `replay_launches`; K4's
with phase 4c's `pose_graph_launches` and phase 13's `bag_launches`; K2's
and the packing's with phase 14's `batch_launches`,
`single_stream_launches`, `batch_ms`, `batch_plain_ms` and
`batch_bound_ms`, K2's also `batch_device_ms`, `batch_separate_ms` and
`batch_max_abs_err`; K4's and K5's with phase 16's `distributed_launches`; K4's
and K2's with phase 17's `accumulate_launches` and the new shapes' times;
`gn_step`'s row phase 18's, with `batch_launches` from phase 5b), the
next one the
card's name and power limit; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import dataclasses
import importlib
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

RTOL, ATOL = 1e-4, 1e-3
ATE_EXPECTED, ATE_BAND = 1.976, 0.05
BENCH_FRAMES, BENCH_POINTS = 1024, 2048
MOMENT_GROUPS = {"sw": slice(0, 1), "swp": slice(1, 4), "swq": slice(4, 7),
                 "swpq": slice(7, 16), "swd2": slice(16, 17),
                 "ungated": slice(17, 19)}
KERNEL_SOURCE = "icp4dradar_tpu_torch/csrc/icp_moments.cu"
KERNEL_REPLACES = "icp4dradar_tpu/ops/icp_fused.py:36"
VGICP_SOURCE = "icp4dradar_tpu_torch/csrc/vgicp_sweep.cu"
VGICP_REPLACES = "icp4dradar_tpu/ops/vgicp_fused.py:98"
VG_RTOL, VG_ATOL = 1e-5, 1e-4
LOCAL_MAP_WINDOW, LOCAL_MAP_POINTS = 15, 4096
# the pairs of the local-map pass run again on the CPU (the plain version)
LOCAL_MAP_CPU_PAIRS = (0, 22, 44, 66)
# tests/test_torch_icp_moments.py::test_batched_icp_matches_jax_per_pair
ICP_PARITY_ATOL = 1e-4
SESSION_FRAMES, SESSION_WARM, SESSION_BLOCK, SESSION_CHECKPOINT = 256, 8, 8, 128
# the JAX package's CPU run of the same session schedule on the same keys
# (scripts/port_session_reference.py)
SESSION_ATE_JAX = 0.03346
SESSION_ATE_BAND = 0.01
S2M_FRAMES, S2M_BLOCK = 256, 8
S2M_ATE_EXPECTED, S2M_ATE_BAND = 0.034, 0.01
BATCH_STREAMS = 4
# each stream's ATE in the JAX package's CPU run of the batch cell
# (scripts/port_batch_reference.py, stream by stream with the split key);
# the port is held to each +- the band
BATCH_ATE_JAX = (0.03448, 0.04622, 0.03271, 0.04208)
BATCH_ATE_BAND = 0.01
# the card's batch stream 0 against its single-stream run, where the
# outputs are not equal bit for bit
BATCH_SINGLE_POS_TOL = 1e-5
BATCH_LAUNCH_RATIO_MAX = 2.0
LOST_FITNESS = 1e6
NN_SOURCE = "icp4dradar_tpu_torch/csrc/nn_search.cu"
NN_REPLACES = "icp4dradar_tpu/ops/knn.py:75"
NN_COORDS_REPLACES = "icp4dradar_tpu/ops/knn.py:180"
FROZEN_REPLACES = "icp4dradar_tpu/ops/vgicp_fused.py:264"
GN_STEP_SOURCE = "icp4dradar_tpu_torch/csrc/gn_step.cu"
# no Pallas kernel: the JAX package's step is plain jnp (its `gn_update`
# closures)
GN_STEP_REPLACES = "none: icp4dradar_tpu/registration/vgicp.py:98-102, 201-205 (plain jnp)"
# phase 18: the frame counts the GN step is checked at, and those it is
# timed at (the fleet's warm-up frames and its blocks of 16 streams x 8)
GN_STEP_FRAMES, GN_STEP_TIMED = (1, 8, 16, 32, 128, 1000), (16, 128)
GN_KINDS = ("active", "inactive", "nonfinite", "taylor", "one_rad")
TRACK_FRAMES = 64
# the kNN-GICP run profiled with its host ops (to find the covariances'
# range): summing them costs ~0.1 ms an event, ~2.5 min for all 64 frames
# on a slow host, so the profile covers the first frames only
GICP_PROFILE_FRAMES = 16
# the JAX package's CPU run of these 64 frames, 0.0572 m, plus 0.035 m of
# room for the port's exact distances (see PERF.md)
GICP_ATE_MAX = 0.09
INNER0_ATE_EXPECTED, INNER0_ATE_BAND = 0.0252, 0.01
# phase 4c: the figure-eight of scripts/eval_suite.py through the pose graph
PG_FRAMES = 128
PG_KW = dict(keyframe_every=4, loop_radius=8.0, min_loop_gap=20, max_loop_candidates=24)
# the JAX package's CPU run of the same cell on the same draws
# (scripts/port_pose_graph_reference.py): (odometry ATE, refined ATE,
# accepted closures); the scan-to-map front end loses the figure-eight at
# the turn reversal there (frame ~72)
PG_JAX = {"s2s": (0.61518, 0.46101, 7), "s2m_structure": (35.36726, 35.36254, 1)}
PG_ATE_BAND, PG_ODOM_GAP_MAX, PG_CLOSURE_BAND = 0.05, 0.03, 1
PG_WRONG_OFFSET_M, PG_WRONG_WEIGHT, PG_WRONG_BAND = 10.0, 10.0, 0.5
# the block solver at keyframe scale: tests/test_graph.py's long chain
# (at most 20 GN iterations: 30, the JAX test's cap, took 73.6 s on an H100 80GB
# HBM3; two runs 15 iterations in part by ~1.4e-3 m, by ~2e-4 m at 20)
PG_CHAIN_K, PG_CHAIN_ITERS, PG_CHAIN_CPU_TOL, PG_CHAIN_GT_TOL = 512, 20, 1e-3, 0.05
PG_DENSE_K, PG_DENSE_TOL = 32, 1e-4


# phase 13 (host): the s2m cell's frames as a ROS1 bag, IMU priors into
# the blocked tracker on JAX's draws; its ATE against the JAX package's CPU
# run of the same path (scripts/port_bag_reference.py)
BAG_ATE_JAX = 0.02973
# the card's prior run read 4.8e-4 m from it, its run without the prior
# 4.6e-3 m: the band lies between, so a path that drops the prior fails
BAG_ATE_BAND = 2e-3
BAG_READS = 3
# the replay through output_result.csv: the card's prefix product against
# the CPU's of the same file (float32 at ~1 km from the origin), and the
# file's six decimals against phase 4's exact transforms (read 9.346e-4 m
# on the H100)
REPLAY_CPU_TOL = 1e-3
REPLAY_CSV_TOL = 2e-3
PCD_FRAMES = 64
HOST_BUDGET_S = 90.0
# failures found by a phase that lets the later phases run; main raises on
# them before it prints a result
FAILED = []


def log(msg):
    print(msg, flush=True)


def phase_device(torch):
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: chip_smoke "
                           "needs an NVIDIA GPU")
    log(f"[device] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} devices {torch.cuda.device_count()} "
        f"name {torch.cuda.get_device_name(0)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(f"[device] nvidia-smi: {card}")
    return card


def phase_build():
    from icp4dradar_tpu_torch.ops import _build

    t0 = time.perf_counter()
    path = _build.build_library()
    _build.load_library()
    log(f"[build] {path.name} in {time.perf_counter() - t0:.2f} s")
    # ptxas: "Function properties for <mangled name>", then its spill line
    # and its "Used N registers, ... smem" line
    name = None
    for line in _build.build_log().splitlines():
        if "Function properties for" in line:
            m = re.search(r"([a-z][a-z_]*_kernel)", line)
            name = m.group(1) if m else line.split()[-1]
        elif name and ("spill" in line or "registers" in line):
            log(f"[build] ptxas {name}: {line.split(':', 1)[-1].strip()}")


def compare(name, kern, plain):
    """Max abs / rel error per moment group; raises beyond RTOL/ATOL."""
    kern, plain = kern.double().cpu(), plain.double().cpu()
    if not (np.isfinite(kern.numpy()).all() and np.isfinite(plain.numpy()).all()):
        raise RuntimeError(f"[kernel] {name}: non-finite moments")
    parts = []
    for g, sl in MOMENT_GROUPS.items():
        d = (kern[..., sl] - plain[..., sl]).abs()
        rel = d / plain[..., sl].abs().clamp(min=1e-30)
        parts.append(f"{g} abs {d.max().item():.3e} rel {rel.max().item():.3e}")
    bad = (kern - plain).abs() > ATOL + RTOL * plain.abs()
    log(f"[kernel] {name}: " + "; ".join(parts))
    if bool(bad.any()):
        raise RuntimeError(f"[kernel] {name}: {int(bad.sum())} moments beyond "
                           f"rtol {RTOL} / atol {ATOL}")
    return (kern - plain).abs().max().item()


def time_cuda(torch, fn, reps=10, warmup=2):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def kernel_device_ms(torch, fn, keys, calls=20):
    """Device time per launch of the kernels whose names hold one of
    `keys`, from a torch.profiler trace of `calls` calls of fn: their time
    over the launches the trace holds (it may miss a few at its start;
    None when it saw no device time)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    ev = [e for e in prof.key_averages()
          if e.device_type == cuda and any(k in e.key for k in keys)]
    us, n = sum(e.self_device_time_total for e in ev), sum(e.count for e in ev)
    return us / 1e3 / n if us > 0 else None


def call_kernels(torch, fn, calls=20):
    """{kernel name: (launches per call, device ms per launch)} of fn, from
    a torch.profiler trace of `calls` calls (None when the profiler saw no
    device time). The launches read low when the trace misses one at its
    start."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    res = {}
    for e in prof.key_averages():
        if e.device_type == cuda and e.self_device_time_total > 0:
            name = kernel_name(e.key)
            n, t = res.get(name, (0, 0.0))
            res[name] = (n + e.count, t + e.self_device_time_total / 1e3)
    return {k: (n / calls, t / n) for k, (n, t) in res.items()} or None


def call_device_ms(kernels):
    """Device time of one call: each kernel's time a launch times its
    launches a call, rounded to whole launches."""
    return sum(t * max(1, round(n)) for n, t in kernels.values())


def kernel_name(key):
    """A short name for a profiler kernel key: the word holding `_kernel`
    (the port's kernels, torch's elementwise and reduce kernels), else the
    last part of the qualified name."""
    m = re.search(r"\w*_kernel\w*", key)
    if m:
        return m.group(0)
    m = re.match(r"[A-Za-z_][\w:]*", re.sub(r"^void ", "", key))
    name = m.group(0).split("::")[-1] if m else ""
    return name or key[:60]


def fmt_kernels(kernels):
    if kernels is None:
        return "not measured"
    return ", ".join(f"{k} x{n:g} {t:.4f} ms a launch"
                     for k, (n, t) in sorted(kernels.items()))


def check_one_kernel(tag, kernels, name):
    """Raises unless the calls launched `name`, at most once a call, and no
    other kernel (no check when the profiler saw no device time; the trace
    may miss a few launches at its start, the launch counters count
    them)."""
    if kernels is not None and (set(kernels) != {name} or kernels[name][0] > 1.0):
        raise RuntimeError(f"[{tag}] one call launched {fmt_kernels(kernels)}; expected one "
                           f"{name} and nothing else")


def fmt_ms(x):
    return "not measured" if x is None else f"{x:.4f} ms"


def phase_kernel(torch, scans):
    from icp4dradar_tpu_torch.geom import se3_exp
    from icp4dradar_tpu_torch.ops.icp_fused import (
        icp_iteration_moments, icp_iteration_moments_plain, icp_moments, icp_prepare,
    )

    dev = scans.xyz.device
    rng = np.random.default_rng(0)
    max_err = 0.0

    def both(name, T, src, sm, tgt, tm, active=None):
        k = icp_iteration_moments(T, src, sm, tgt, tm, active=active)
        torch.cuda.synchronize()
        p = icp_iteration_moments_plain(T, src, sm, tgt, tm, active=active)
        return compare(name, k, p), k

    # 8 bench pairs (frame k onto k-1) under random poses
    xi = rng.normal(0.0, [0.5, 0.5, 0.1, 0.01, 0.01, 0.05], (8, 6)).astype(np.float32)
    T = se3_exp(torch.from_numpy(xi).to(dev)).contiguous()
    src, sm = scans.xyz[1:9].contiguous(), scans.mask[1:9].contiguous()
    tgt, tm = scans.xyz[0:8].contiguous(), scans.mask[0:8].contiguous()
    err, k8 = both("bench B=8 2048x2048", T, src, sm, tgt, tm)
    max_err = max(max_err, err)
    # pairs 2 and 5 inactive: zero rows, the others identical
    active = torch.tensor([True, True, False, True, True, False, True, True], device=dev)
    _, ka = both("bench B=8, pairs 2 and 5 inactive", T, src, sm, tgt, tm, active)
    if not (torch.equal(ka[active], k8[active]) and float(ka[~active].abs().max()) == 0.0):
        raise RuntimeError("[kernel] inactive pairs: rows not zero, or active rows changed")

    # ragged: N=1000, M=1234, random masks; pair 2 has all its targets
    # masked, pair 3 no valid source
    B, N, M = 4, 1000, 1234
    src = torch.from_numpy(rng.normal(0, 20, (B, N, 3)).astype(np.float32)).to(dev)
    tgt = torch.from_numpy(rng.normal(0, 20, (B, M, 3)).astype(np.float32)).to(dev)
    sm = torch.from_numpy((rng.uniform(size=(B, N)) > 0.2).astype(np.float32)).to(dev)
    tm = torch.from_numpy((rng.uniform(size=(B, M)) > 0.3).astype(np.float32)).to(dev)
    tm[2] = 0.0
    sm[3] = 0.0
    xi = rng.normal(0.0, [1.0, 1.0, 0.2, 0.02, 0.02, 0.1], (B, 6)).astype(np.float32)
    T = se3_exp(torch.from_numpy(xi).to(dev)).contiguous()
    _, k = both("ragged B=4 1000x1234 masked, pair 2 all targets masked", T, src, sm, tgt, tm)
    if float(k[2, 0]) != 0.0 or float(k[2, 17]) < 1e29 * float(sm[2].sum()):
        raise RuntimeError(f"[kernel] all-masked pair: sw {float(k[2, 0])}, "
                           f"s(mask*dmin) {float(k[2, 17])}")

    # exact ties: two targets at d2 = 5 from the source average to (1, 0, 0)
    src = torch.zeros((1, 1, 3), device=dev)
    tgt = torch.tensor([[[1.0, 2.0, 0.0], [1.0, -2.0, 0.0], [50.0, 50.0, 50.0]]],
                       device=dev)
    _, k = both("exact tie", torch.eye(4, device=dev)[None], src,
                torch.ones((1, 1), device=dev), tgt, torch.ones((1, 3), device=dev))
    want = torch.tensor([1.0, 0.0, 0.0], device=dev)
    if not torch.allclose(k[0, 4:7], want, atol=1e-6) or abs(k[0, 16].item() - 5.0) > 5e-6:
        raise RuntimeError(f"[kernel] exact tie: swq {k[0, 4:7].tolist()} "
                           f"swd2 {k[0, 16].item()}, expected [1, 0, 0] and 5")
    # four targets at d2 = 5 from source 0 (rows 1 and 40 in the kernel's
    # first 64-row chunk, 900 and 2000 chunks later, masked rows between),
    # two at d2 = 5 from source 1 in different chunks only
    tgt = torch.full((1, 2048, 3), 60.0, device=dev)
    for row, v in ((1, (2., 1., 0.)), (40, (1., 2., 0.)), (900, (-2., 1., 0.)),
                   (2000, (0., -1., 2.)), (100, (32., 1., 0.)), (1500, (31., 2., 0.))):
        tgt[0, row] = torch.tensor(v, device=dev)
    tm = torch.ones((1, 2048), device=dev)
    tm[0, 500:700] = 0.0
    src = torch.tensor([[[0.0, 0.0, 0.0], [30.0, 0.0, 0.0]]], device=dev)
    _, k = both("four- and two-way ties across chunks", torch.eye(4, device=dev)[None], src,
                torch.ones((1, 2), device=dev), tgt, tm)
    if k[0, 4:7].tolist() != [31.75, 2.25, 0.5] or k[0, 16].item() != 10.0:
        raise RuntimeError(f"[kernel] ties across chunks: swq {k[0, 4:7].tolist()} swd2 "
                           f"{k[0, 16].item()}, expected [31.75, 2.25, 0.5] and 10")

    max_err = max(max_err, multi_tile_case(torch, dev, rng, both))

    # the full bench batch: one ICP iteration of the main path, on clouds
    # prepared once (as the ICP loop prepares them) and per call
    src, sm = scans.xyz, scans.mask
    tgt = torch.cat([scans.xyz[:1], scans.xyz[:-1]]).contiguous()
    tm = torch.cat([scans.mask[:1], scans.mask[:-1]]).contiguous()
    T = torch.eye(4, device=dev).expand(src.shape[0], 4, 4).contiguous()
    max_err = max(max_err, both(f"bench B={src.shape[0]} 2048x2048",
                                T, src, sm, tgt, tm)[0])
    ops = icp_prepare(src, sm, tgt, tm)
    if not torch.equal(icp_moments(T, ops), icp_iteration_moments(T, src, sm, tgt, tm)):
        raise RuntimeError("[kernel] prepared clouds and the per-call path differ")

    # in turns, plain / kernel / kernel / plain; each a median of 10
    def kernel():
        return icp_moments(T, ops)

    def per_call():
        return icp_iteration_moments(T, src, sm, tgt, tm)

    def plain():
        return icp_iteration_moments_plain(T, src, sm, tgt, tm)

    p1, k1, k2, p2 = (time_cuda(torch, f) for f in (plain, kernel, kernel, plain))
    pc = time_cuda(torch, per_call)
    dev_ms = kernel_device_ms(torch, kernel, ("icp_moments_kernel",), calls=10)
    ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
    B, N, M = src.shape[0], src.shape[1], tgt.shape[1]
    pairs = B * N * M
    _, src_live, _, tgt_live = ops.packed
    live = int((src_live.long() * tgt_live.long()).sum().item())
    # each input read once (T, xyz and masks of both clouds), (B, 19) out;
    # the work is the live pairs, which are all the kernel sweeps
    from icp4dradar_tpu_torch.utils import roofline as rl

    live_model, all_model = (rl.icp_moments_bound(B, N, M, x) for x in (live, pairs))
    bound_ms, bound_by = live_model.bound()
    all_ms, _ = all_model.bound()
    slots_ms, slots_all_ms = (rl.slot_floor_ms(m.fp32_ops) for m in (live_model, all_model))
    log(f"[kernel] time at B={B} x {N} x {M}: kernel {k1:.4f} / {k2:.4f} ms on prepared "
        f"clouds (device time of the kernel alone {fmt_ms(dev_ms)}, profiler; "
        f"{pc:.4f} ms per call with the packing), plain {p1:.3f} / {p2:.3f} ms; "
        f"live pairs {live} of {pairs} ({live / pairs:.3f}); kernel "
        f"{pairs / (ms * 1e-3) / 1e9:.1f} G point pairs/s over all pairs")
    log(f"[kernel] bounds: FP32 {bound_ms:.4f} ms live pairs ({bound_by}; {all_ms:.4f} ms all "
        f"pairs), slot floor {slots_ms:.4f} ms live ({slots_all_ms:.4f} ms all); the "
        f"kernel at {bound_ms / ms:.3f} / {all_ms / ms:.3f} of the FP32 bound and "
        f"{slots_ms / ms:.3f} / {slots_all_ms / ms:.3f} of the slot floor (live / all)")
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None)


def multi_tile_case(torch, dev, rng, both):
    """K1 beyond one 2048-row tile (the local-map shape): 8 pairs x 4096
    sources x 4096 targets, the staging loop running twice and the tie
    re-scan reading L2. Pair 0, under the identity: an exact tie across the
    tile boundary (rows 2047 and 2048), a four-way tie over both tiles
    (rows 5, 1000, 3000, 4095) and a tie whose first row lies in the second
    tile (rows 3500 and 3600, different chunks); dyadic values, so the
    averages are exact. Pair 7: 2049 live targets among masked rows (one row
    in the second tile), a tie between the first and the last live row.
    Returns the largest moment difference."""
    B, N, M = 8, 4096, 4096
    xi = rng.normal(0.0, [0.5, 0.5, 0.1, 0.01, 0.01, 0.05], (B, 6)).astype(np.float32)
    from icp4dradar_tpu_torch.geom import se3_exp

    T = se3_exp(torch.from_numpy(xi).to(dev)).contiguous()
    T[0] = torch.eye(4, device=dev)
    T[7] = torch.eye(4, device=dev)
    src = torch.from_numpy(rng.normal(0, 20, (B, N, 3)).astype(np.float32)).to(dev)
    tgt = torch.from_numpy(rng.normal(0, 20, (B, M, 3)).astype(np.float32)).to(dev)
    sm = torch.from_numpy((rng.uniform(size=(B, N)) > 0.1).astype(np.float32)).to(dev)
    tm = torch.ones((B, M), device=dev)
    tm[3] = torch.from_numpy((rng.uniform(size=M) > 0.3).astype(np.float32)).to(dev)
    # (source, rows, offsets from the source), each offset at d2 = 5
    ties = (((200., 0., 0.), (2047, 2048), ((1., 2., 0.), (1., -2., 0.))),
            ((0., 200., 0.), (5, 1000, 3000, 4095),
             ((2., 1., 0.), (1., 2., 0.), (-2., 1., 0.), (0., -1., 2.))),
            ((0., -200., 0.), (3500, 3600), ((1., 2., 0.), (2., 1., 0.))))
    want = []
    for i, (p, rows, offs) in enumerate(ties):
        src[0, i] = torch.tensor(p, device=dev)
        sm[0, i] = 1.0
        for r, o in zip(rows, offs):
            tgt[0, r] = torch.tensor(p, device=dev) + torch.tensor(o, device=dev)
        want.append(np.asarray(p) + np.mean(offs, axis=0))
    live = np.sort(rng.choice(M, 2049, replace=False))
    tm[7] = 0.0
    tm[7, torch.from_numpy(live).to(dev)] = 1.0
    p7 = torch.tensor([0.0, 0.0, 300.0], device=dev)
    src[7, 0], sm[7, 0] = p7, 1.0
    tgt[7, int(live[0])] = p7 + torch.tensor([1.0, 2.0, 0.0], device=dev)
    tgt[7, int(live[-1])] = p7 + torch.tensor([2.0, 1.0, 0.0], device=dev)
    err, _ = both(f"multi-tile B={B} {N}x{M}: ties across the tile boundary, over both "
                  f"tiles, first in the second tile; 2049 live targets", T, src, sm, tgt, tm)
    one = torch.ones((1,), device=dev)
    for (p, rows, _), w in zip(ties + (((0.0, 0.0, 300.0), (live[0], live[-1]), None),),
                               want + [np.asarray([0.0, 0.0, 300.0]) + [1.5, 1.5, 0.0]]):
        b = 7 if p[2] == 300.0 else 0
        m = both(f"multi-tile tie at rows {tuple(int(r) for r in rows)} of pair {b}",
                 T[b], torch.tensor([p], device=dev), one, tgt[b], tm[b])[1]
        if m[4:7].tolist() != list(w) or m[16].item() != 5.0:
            raise RuntimeError(f"[kernel] multi-tile tie at rows {rows}: q {m[4:7].tolist()} "
                               f"d2 {m[16].item()}, expected {list(w)} and 5")
    return err


def phase_slice(torch, seq, scans):
    from icp4dradar_tpu_torch.config import PipelineConfig
    from icp4dradar_tpu_torch.io import SyntheticSequence
    from icp4dradar_tpu_torch.io.scan import stack_scans
    from icp4dradar_tpu_torch.models import run_scan_to_scan
    from icp4dradar_tpu_torch.ops import icp_fused
    from icp4dradar_tpu_torch.preprocess import draw_uniforms
    from icp4dradar_tpu_torch.utils import ate_rmse

    cfg = PipelineConfig()
    F = scans.xyz.shape[0]

    def run():
        out = run_scan_to_scan(scans, cfg, use_doppler_prior=True)
        torch.cuda.synchronize()
        return out

    t0 = time.perf_counter()
    run()
    log(f"[slice] warm-up run {time.perf_counter() - t0:.3f} s")
    torch.cuda.reset_peak_memory_stats()
    icp_fused.ICP_MOMENTS_LAUNCHES = 0
    t0 = time.perf_counter()
    out = run()
    dt = time.perf_counter() - t0
    launches = icp_fused.ICP_MOMENTS_LAUNCHES
    iters = int(out.iterations.max().item())
    repeats = []
    for _ in range(3):
        t1 = time.perf_counter()
        run()
        repeats.append(time.perf_counter() - t1)
    log(f"[slice] {F} frames in {dt * 1e3:.2f} ms = {F / dt:.1f} scans/s "
        f"(repeats: {', '.join(f'{F / r:.1f}' for r in repeats)} scans/s); "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"[slice] icp_moments launches {launches}, ICP iterations {iters} "
        f"(per-pair mean {out.iterations.float().mean().item():.2f})")
    # a pair stays active until it converges: iteration k sweeps the pairs
    # with more than k iterations, the final fitness pass every pair
    its = out.iterations.cpu()
    n_pairs = its.shape[0]
    counts = [int((its > k).sum()) for k in range(iters)] + [n_pairs]
    log(f"[slice] pairs swept per launch: {counts} ({sum(counts)} of "
        f"{n_pairs * len(counts)})")
    if launches <= 0 or launches != iters + 1:
        raise RuntimeError(f"[slice] launch count {launches} != ICP "
                           f"iterations {iters} + 1")
    for f in ("icp_transform", "world_T", "velocity", "fitness", "sine_A", "sine_b"):
        x = getattr(out, f)
        if x.shape[0] != F or not bool(torch.isfinite(x).all()):
            raise RuntimeError(f"[slice] {f}: shape {tuple(x.shape)} or non-finite")
    n_acc = int(out.accepted.sum().item())
    poses = out.world_T.cpu().numpy()
    ate = ate_rmse(poses[:, :3, 3], seq.poses[:, :3, 3], align=False)
    log(f"[slice] accepted {n_acc}/{F}, converged "
        f"{int(out.converged.sum().item())}/{F}, ATE (align=False) {ate:.4f} m")
    if n_acc != F:
        raise RuntimeError(f"[slice] only {n_acc}/{F} frames accepted")
    if not abs(ate - ATE_EXPECTED) <= ATE_BAND:
        raise RuntimeError(f"[slice] ATE {ate:.4f} m outside "
                           f"{ATE_EXPECTED} +- {ATE_BAND} m")

    # small input: the CUDA path against the CPU path on the same draws
    small = SyntheticSequence(num_frames=16, max_points=256, num_landmarks=2000,
                              seed=0)
    s_cpu = stack_scans([small.scan(k) for k in range(16)])
    g = torch.Generator().manual_seed(0)
    u = draw_uniforms((16,), cfg.doppler.num_hypotheses, g)
    o_cpu = run_scan_to_scan(s_cpu, cfg, uniforms=u, use_doppler_prior=True)
    o_gpu = run_scan_to_scan(s_cpu.to("cuda"), cfg, uniforms=u.cuda(),
                             use_doppler_prior=True)
    d = (o_gpu.world_T.cpu() - o_cpu.world_T).abs().max().item()
    log(f"[slice] 16x256 CUDA vs CPU: max |world_T| diff {d:.3e}, accepted "
        f"equal {bool((o_gpu.accepted.cpu() == o_cpu.accepted).all())}")
    if d > 1e-3 or not bool((o_gpu.accepted.cpu() == o_cpu.accepted).all()):
        raise RuntimeError("[slice] CUDA and CPU paths disagree on 16x256")
    return launches, F / dt, ate, out


def phase_local_map(torch, scans, poses):
    """Window ICP over phase 4's s2s track of the bench sequence: 68
    windows of 15 frames, subsampled to 4096 points, 67 pairs in one batched
    ICP (K1 at 67 x 4096 x 4096, its multi-tile path)."""
    from icp4dradar_tpu_torch.config import PipelineConfig
    from icp4dradar_tpu_torch.models import build_windows, local_map_refinement
    from icp4dradar_tpu_torch.ops import icp_fused
    from icp4dradar_tpu_torch.registration.icp import icp_point_to_point

    cfg = PipelineConfig().icp
    W, P = LOCAL_MAP_WINDOW, LOCAL_MAP_POINTS
    xyz, mask = scans.xyz.cpu().numpy(), scans.mask.cpu().numpy()
    local_map_refinement(xyz[:2 * W], mask[:2 * W], poses[:2 * W], W, P, cfg)   # warm-up
    torch.cuda.synchronize()
    icp_fused.ICP_MOMENTS_LAUNCHES = 0
    t0 = time.perf_counter()
    T = local_map_refinement(xyz, mask, poses, W, P, cfg)
    pass_ms = (time.perf_counter() - t0) * 1e3
    launches = icp_fused.ICP_MOMENTS_LAUNCHES
    # the same windows again, for the iteration counts, the CPU run and the
    # timings (deterministic: the corrections must be the pass's)
    t0 = time.perf_counter()
    wins, masks = build_windows(xyz, mask, poses, W, P)
    windows_ms = (time.perf_counter() - t0) * 1e3
    pairs = len(wins) - 1
    dev = scans.xyz.device
    src, tgt, sm, tm = (torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                        for x in (wins[1:], wins[:-1], masks[1:], masks[:-1]))
    res = icp_point_to_point(src, tgt, sm, tm, cfg=cfg)
    iters = int(res.iterations.max().item())
    its = res.iterations.cpu().numpy()
    log(f"[local map] {len(wins)} windows of {W} frames, {pairs} pairs x {P} x {P} (live rows "
        f"a window {int(masks.sum(axis=1).min())}-{int(masks.sum(axis=1).max())}); pass "
        f"{pass_ms:.2f} ms, of which the windows on the host (numpy) {windows_ms:.2f} ms; "
        f"icp_moments launches {launches}, ICP iterations {iters} (per pair "
        f"mean {its.mean():.2f}, {int((its >= cfg.max_iterations).sum())} at the cap); "
        f"correction |t| max {np.abs(T[:, :3, 3]).max():.4f} m")
    if launches <= 0 or launches != iters + 1:
        raise RuntimeError(f"[local map] launch count {launches} != ICP iterations {iters} + 1")
    if T.shape != (pairs, 4, 4) or not np.isfinite(T).all() or \
            not np.array_equal(res.transform.cpu().numpy(), T):
        raise RuntimeError("[local map] corrections non-finite, misshapen or not repeatable")
    # the plain version on the CPU, on a few of the pairs (each pair's
    # result is its own: converged pairs freeze); all 67 take ~4 min there
    sel = [b for b in LOCAL_MAP_CPU_PAIRS if b < pairs]
    t0 = time.perf_counter()
    cpu = icp_point_to_point(*(x[sel].cpu() for x in (src, tgt, sm, tm)), cfg=cfg)
    cpu_s = time.perf_counter() - t0
    err = float(np.abs(cpu.transform.numpy() - T[sel]).max())
    same_its = bool((cpu.iterations.numpy() == its[sel]).all())
    log(f"[local map] CPU (plain version) on pairs {sel}: max |T| difference {err:.3e} "
        f"(tolerance {ICP_PARITY_ATOL}), iterations equal {same_its}, {cpu_s:.1f} s")
    if not err <= ICP_PARITY_ATOL or not same_its:
        raise RuntimeError(f"[local map] card and CPU disagree: {err:.3e}, iterations equal "
                           f"{same_its}")

    # one K1 iteration at this shape, at the identity (the pass's first)
    ops = icp_fused.icp_prepare(src, sm, tgt, tm)
    T0 = torch.eye(4, device=dev).expand(pairs, 4, 4).contiguous()

    def kernel():
        return icp_fused.icp_moments(T0, ops)

    def plain():
        return icp_fused.icp_iteration_moments_plain(T0, src, sm, tgt, tm)

    k1, k2 = (time_cuda(torch, kernel) for _ in range(2))
    plain_ms = time_cuda(torch, plain, reps=3, warmup=1)
    dev_ms = kernel_device_ms(torch, kernel, ("icp_moments_kernel",), calls=10)
    ms = (k1 + k2) / 2
    live = int(((sm > 0).sum(dim=1) * (tm > 0.5).sum(dim=1)).sum().item())
    from icp4dradar_tpu_torch.utils import roofline as rl

    model = rl.icp_moments_bound(pairs, P, P, live)
    bound_ms, bound_by = model.bound()
    slots_ms = rl.slot_floor_ms(model.fp32_ops)
    log(f"[local map] K1 at {pairs} x {P} x {P}: one iteration {k1:.4f} / {k2:.4f} ms on "
        f"prepared clouds (device time of the kernel alone {fmt_ms(dev_ms)}, profiler), plain "
        f"{plain_ms:.3f} ms; bound {bound_ms:.4f} ms ({bound_by}, {live} live pairs), slot "
        f"floor {slots_ms:.4f} ms; the kernel at {bound_ms / ms:.3f} of the bound and "
        f"{slots_ms / ms:.3f} of the slot floor; the pass {pass_ms:.2f} ms")
    return dict(local_map_launches=launches, local_map_ms=ms, local_map_device_ms=dev_ms,
                local_map_plain_ms=plain_ms, local_map_bound_ms=bound_ms,
                local_map_slot_floor_ms=slots_ms, local_map_pass_ms=pass_ms,
                local_map_max_abs_err=err)


def figure_eight(frames):
    """scripts/eval_suite.py's figure-eight: two opposite-turn laps of 64
    frames through a shared crossing, 2 m a frame."""
    from icp4dradar_tpu_torch.io import SyntheticSequence

    w8 = 2 * 3.14159265 / 64.0
    half = frames // 2
    schedule = np.concatenate([np.full(half, w8), np.full(frames - half, -w8)])
    return SyntheticSequence(num_frames=frames, max_points=2048, num_landmarks=6000,
                             world_extent=140.0, max_range=80.0, seed=0, speed=2.0,
                             dynamic_fraction=0.1, pos_noise=0.03, turn_schedule=schedule)


def pg_loop_graph(torch, K, radius, n_loops, drift_sigma, seed):
    """tests/test_graph.py's circle with random-walk drift, exact chain
    measurements (weight 100) and n_loops closures across it (weight 10),
    as numpy: (gt, drifted poses, rel fields)."""
    from icp4dradar_tpu_torch.geom import se3_exp

    def exp(xi):
        return se3_exp(torch.tensor(np.asarray(xi, np.float32))).numpy()

    rng = np.random.default_rng(seed)
    gt = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    th = 2 * np.pi * np.arange(K) / K
    gt[:, :3, 3] = np.stack([radius * np.cos(th), radius * np.sin(th), 0.01 * np.arange(K)], -1)
    poses = gt.copy()
    drift = np.eye(4, dtype=np.float32)
    for k in range(1, K):
        drift = exp(rng.normal(0, drift_sigma, 6)) @ drift
        poses[k] = drift @ poses[k]
    li = rng.integers(0, K // 2, n_loops)
    i = np.concatenate([np.arange(K - 1), li])
    j = np.concatenate([np.arange(1, K), li + K // 2])
    T = np.stack([np.linalg.inv(gt[a]) @ gt[b] for a, b in zip(i, j)]).astype(np.float32)
    w = np.concatenate([np.full(K - 1, 100.0), np.full(n_loops, 10.0)]).astype(np.float32)
    return gt, poses, dict(i=i, j=j, T_meas=T, weight=w, mask=np.ones(len(i), np.float32))


def pg_single_pose_factors(K, gt, seed, P=400):
    """Factors of every single-pose type on the ground truth: planes z=0
    (normal + offset and through three points), lines y=1, z=2 along x,
    point anchors."""
    rng = np.random.default_rng(seed)

    def body(k, world):
        T = gt[k]
        return np.einsum("pji,pj->pi", T[:, :3, :3], world - T[:, :3, 3]).astype(np.float32)

    def tile(v):
        return np.tile(np.float32(v), (P, 1))

    ones = np.ones(P, np.float32)
    pw = rng.uniform(-3, 6, (P, 3))
    pw[:, 2] = 0.0
    k = rng.integers(0, K, P)
    lw = np.stack([rng.uniform(-3, 6, P), np.full(P, 1.0), np.full(P, 2.0)], -1)
    kl = rng.integers(0, K, P)
    qw = rng.uniform(-3, 6, (P, 3)).astype(np.float32)
    kq = rng.integers(0, K, P)
    return dict(
        planes=dict(k=k, p_body=body(k, pw), normal=tile([0, 0, 1]), offset=0 * ones,
                    weight=ones, mask=ones),
        planes3=dict(k=k, p_body=body(k, pw), plane_j=tile([0, 0, 0]), plane_l=tile([1, 0, 0]),
                     plane_m=tile([0, 1, 0]), weight=ones, mask=ones),
        lines=dict(k=kl, p_body=body(kl, lw), line_a=tile([0, 1, 2]), line_b=tile([1, 1, 2]),
                   weight=ones, mask=ones),
        points=dict(k=kq, p_body=body(kq, qw), q_world=qw, weight=ones, mask=ones))


def pg_check(tag, res, gt, jax_ref, card):
    """Finite poses; accepted closures within PG_CLOSURE_BAND of the JAX CPU
    run's; the refined ATE (align=False) within PG_ATE_BAND of JAX's, or,
    where the odometry ATE itself differs from JAX's by more than
    PG_ODOM_GAP_MAX, the refinement's gain within PG_ATE_BAND of JAX's;
    the refined ATE at most the odometry's x 1.05. Returns (odometry ATE,
    refined ATE)."""
    from icp4dradar_tpu_torch.utils import ate_rmse

    j_odom, j_ref, j_closures = jax_ref
    if not (np.isfinite(res.poses).all() and np.isfinite(res.odom_poses).all()):
        raise RuntimeError(f"[pose graph] {tag}: non-finite poses")
    odom = ate_rmse(res.odom_poses[:, :3, 3], gt, align=False)
    ref = ate_rmse(res.poses[:, :3, 3], gt, align=False)
    log(f"[pose graph] {tag}: odometry ATE {odom:.5f} m (JAX CPU {j_odom}), refined "
        f"{ref:.5f} m (JAX CPU {j_ref}), accepted closures {res.num_loop_closures} (JAX CPU "
        f"{j_closures}), keyframes {len(res.keyframe_indices)}, cost {res.cost:.6g}; {card}")
    if abs(res.num_loop_closures - j_closures) > PG_CLOSURE_BAND:
        raise RuntimeError(f"[pose graph] {tag}: {res.num_loop_closures} closures against the "
                           f"JAX CPU run's {j_closures}")
    if abs(odom - j_odom) <= PG_ODOM_GAP_MAX:
        if abs(ref - j_ref) > PG_ATE_BAND:
            raise RuntimeError(f"[pose graph] {tag}: refined ATE {ref:.5f} m outside "
                               f"{j_ref} +- {PG_ATE_BAND} m")
    else:
        gain, j_gain = odom - ref, j_odom - j_ref
        log(f"[pose graph] {tag}: the odometry differs from JAX's by {odom - j_odom:+.5f} m "
            f"(beyond {PG_ODOM_GAP_MAX} m): gain odometry - refined {gain:+.5f} m against "
            f"JAX's {j_gain:+.5f} m, refined gap {ref - j_ref:+.5f} m")
        if abs(gain - j_gain) > PG_ATE_BAND:
            raise RuntimeError(f"[pose graph] {tag}: refinement gain {gain:+.5f} m outside "
                               f"JAX's {j_gain:+.5f} +- {PG_ATE_BAND} m")
    if ref > odom * 1.05:
        raise RuntimeError(f"[pose graph] {tag}: refined ATE {ref:.5f} m worse than the "
                           f"odometry's {odom:.5f} m x 1.05")
    return odom, ref


def phase_pose_graph(torch, card):
    """Phase 4c: run_pose_graph_odometry on the figure-eight (128 x 2048,
    K = 32 keyframes) with the s2s front end (K1; its loop ICP on K1, K1's
    count set to 0 just before the loop ICP and read just after), a
    fabricated closure, the s2m front end with structure factors (K4); then
    `pg_solvers`."""
    from icp4dradar_tpu_torch.config import PipelineConfig
    from icp4dradar_tpu_torch.io.scan import stack_scans
    from icp4dradar_tpu_torch.models import pose_graph_odometry as pgo
    from icp4dradar_tpu_torch.ops import icp_fused, vgicp_fused
    from icp4dradar_tpu_torch.preprocess.reve import reve_hypotheses
    from icp4dradar_tpu_torch.utils import ate_rmse, doppler_uniforms, reve_uniforms

    cfg = PipelineConfig()
    F = PG_FRAMES
    seq = figure_eight(F)
    scans = stack_scans([seq.scan(k) for k in range(F)]).to("cuda")
    gt = seq.poses[:, :3, 3]
    # the JAX package's draws (its run's key(cfg.seed)), as the reference run's
    u_s2s = torch.from_numpy(doppler_uniforms(cfg.seed, F, cfg.doppler.num_hypotheses)).cuda()
    u_s2m = torch.from_numpy(reve_uniforms(cfg.seed, F, cfg.pose_graph.front_end_block,
                                           reve_hypotheses(cfg.reve))).cuda()

    loops = []
    real_icp = pgo.icp_point_to_point

    def loop_icp(*args, **kw):
        """The run's loop-closure ICP: K1's count set to 0 just before it,
        read just after (then added back to the run's count)."""
        torch.cuda.synchronize()
        before = icp_fused.ICP_MOMENTS_LAUNCHES
        icp_fused.ICP_MOMENTS_LAUNCHES = 0
        t0 = time.perf_counter()
        res = real_icp(*args, **kw)
        torch.cuda.synchronize()
        loops.append(dict(ms=(time.perf_counter() - t0) * 1e3,
                          launches=icp_fused.ICP_MOMENTS_LAUNCHES,
                          its=res.iterations.cpu().numpy(), shape=tuple(args[0].shape)))
        icp_fused.ICP_MOMENTS_LAUNCHES += before
        return res

    def run(u, **kw):
        out = pgo.run_pose_graph_odometry(scans, cfg, uniforms=u, **PG_KW, **kw)
        torch.cuda.synchronize()
        return out

    pgo.icp_point_to_point = loop_icp
    try:
        t0 = time.perf_counter()
        run(u_s2s)
        warm_ms = (time.perf_counter() - t0) * 1e3
        icp_fused.ICP_MOMENTS_LAUNCHES = 0
        times = {}
        t0 = time.perf_counter()
        res = run(u_s2s, phase_times=times)
        s2s_ms = (time.perf_counter() - t0) * 1e3
        k1_launches = icp_fused.ICP_MOMENTS_LAUNCHES
        loop = loops[-1]
        log(f"[pose graph] s2s figure-eight {F} x {scans.xyz.shape[1]}: warm-up {warm_ms:.1f} ms, "
            f"timed run {s2s_ms:.2f} ms; icp_moments launches {k1_launches} (front end and loop "
            f"ICP); its phase split (host clock, a synchronize around each phase): " +
            ", ".join(f"{k} {v * 1e3:.2f} ms" for k, v in times.items()) + f"; {card}")
        its = loop["its"]
        swept = [int((its > k).sum()) for k in range(int(its.max()))] + [len(its)]
        log(f"[pose graph] loop ICP on K1: {loop['shape'][0]} candidates x "
            f"{loop['shape'][1]} points, one batched call {loop['ms']:.2f} ms, icp_moments "
            f"launches {loop['launches']} = iterations {int(its.max())} + 1 expected; pairs "
            f"swept per launch {swept}; {card}")
        if loop["launches"] <= 0 or loop["launches"] != int(its.max()) + 1:
            raise RuntimeError(f"[pose graph] loop ICP launches {loop['launches']} != "
                               f"iterations {int(its.max())} + 1")
        odom, ref = pg_check("s2s", res, gt, PG_JAX["s2s"], card)

        kf = res.keyframe_indices
        K = len(kf)
        T = np.linalg.inv(res.odom_poses[kf[2]]) @ res.odom_poses[kf[K - 4]]
        T[:3, 3] += np.asarray([PG_WRONG_OFFSET_M, 0.0, 0.0])
        inj = run(u_s2s, inject_loop_factors=[(2, K - 4, T, PG_WRONG_WEIGHT)])
        ref_inj = ate_rmse(inj.poses[:, :3, 3], gt, align=False)
        log(f"[pose graph] wrong closure (keyframes 2 -> {K - 4}, {PG_WRONG_OFFSET_M} m off, "
            f"weight {PG_WRONG_WEIGHT}): refined ATE {ref_inj:.5f} m against {ref:.5f} m clean, "
            f"closures {inj.num_loop_closures} against {res.num_loop_closures}")
        if not (np.isfinite(inj.poses).all() and abs(ref_inj - ref) <= PG_WRONG_BAND
                and inj.num_loop_closures == res.num_loop_closures):
            raise RuntimeError("[pose graph] the fabricated closure was not contained")

        # one run (the s2m path is warm from phase 5, the solver from the
        # s2s runs)
        vgicp_fused.VGICP_SWEEP_LAUNCHES = 0
        icp_fused.ICP_MOMENTS_LAUNCHES = 0
        times = {}
        t0 = time.perf_counter()
        full = run(u_s2m, front_end="scan_to_map", structure_factors=True, phase_times=times)
        full_ms = (time.perf_counter() - t0) * 1e3
        k4_launches = vgicp_fused.VGICP_SWEEP_LAUNCHES
        k1_full = icp_fused.ICP_MOMENTS_LAUNCHES
        log(f"[pose graph] s2m + structure factors: run {full_ms:.2f} ms; vgicp_sweep "
            f"launches {k4_launches}, icp_moments launches {k1_full} (loop ICP); phase split: " +
            ", ".join(f"{k} {v * 1e3:.2f} ms" for k, v in times.items()) + f"; {card}")
        if k4_launches <= 0:
            raise RuntimeError("[pose graph] the s2m front end launched no vgicp_sweep")
        pg_check("s2m + structure factors", full, gt, PG_JAX["s2m_structure"], card)
        err = np.linalg.norm(full.odom_poses[:, :3, 3] - gt, axis=-1)
        lost = int(np.argmax(err > 1.0)) if (err > 1.0).any() else None
        log(f"[pose graph] s2m front end: first frame more than 1 m off {lost}; position error "
            f"every 16 frames {np.round(err[::16], 3).tolist()}")
    finally:
        pgo.icp_point_to_point = real_icp
    pg_solvers(torch, card)
    return dict(pose_graph_launches=k1_launches, loop_icp_launches=loop["launches"],
                loop_icp_ms=loop["ms"], loop_icp_pairs=loop["shape"][0]), \
        dict(pose_graph_launches=k4_launches)


def pg_solvers(torch, card):
    """Phase 4c's solver checks: the block solver on tests/test_graph.py's
    K = 512 long chain on the card and the CPU, one GN iteration's launches
    and host syncs, and dense against block on the card at K = 32."""
    from icp4dradar_tpu_torch.config import PoseGraphConfig
    from icp4dradar_tpu_torch.graph import (
        block_normal_equations, block_solver, optimize_pose_graph, optimize_pose_graph_block,
        split_chain_loops,
    )
    from icp4dradar_tpu_torch.interop import pose_graph_from_numpy

    # ---- the block solver at keyframe scale, on the card and the CPU ----
    gt_c, poses_c, rel_c = pg_loop_graph(torch, PG_CHAIN_K, 100.0, 8, 0.004, seed=5)
    err0 = float(np.linalg.norm(poses_c[:, :3, 3] - gt_c[:, :3, 3], axis=-1).max())
    chain_cfg = PoseGraphConfig(max_iterations=PG_CHAIN_ITERS)

    def chain(dev, c=chain_cfg):
        g = pose_graph_from_numpy({"poses": poses_c, "rel": rel_c}, device=dev)
        block_solver.GN_ITERATIONS = block_solver.PCG_ITERATIONS = 0
        if dev == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, cost = optimize_pose_graph_block(g, c)
        p = out.poses.cpu().numpy()
        return (p, float(cost), (time.perf_counter() - t0) * 1e3, block_solver.GN_ITERATIONS,
                block_solver.PCG_ITERATIONS)

    rows = {}
    for dev in ("cuda", "cpu"):
        p, cost, ms, gn, pcg = chain(dev)
        e = float(np.linalg.norm(p[:, :3, 3] - gt_c[:, :3, 3], axis=-1).max())
        rows[dev] = (p, e)
        log(f"[pose graph] block solver K={PG_CHAIN_K} on {dev}: {ms:.1f} ms wall, GN "
            f"iterations {gn}, PCG iterations {pcg} ({pcg / max(gn, 1):.1f} a GN iteration), "
            f"cost {cost:.6g}, max position error {e:.5f} m (from {err0:.3f} m); {card}")
        if not (np.isfinite(p).all() and e < PG_CHAIN_GT_TOL):
            raise RuntimeError(f"[pose graph] block solver on {dev}: max error {e} m")
    d = float(np.abs(rows["cuda"][0][:, :3, 3] - rows["cpu"][0][:, :3, 3]).max())
    log(f"[pose graph] block solver K={PG_CHAIN_K}: card against CPU max position difference "
        f"{d:.3e} m (tolerance {PG_CHAIN_CPU_TOL})")
    if not (err0 > 5.0 and d <= PG_CHAIN_CPU_TOL):
        raise RuntimeError(f"[pose graph] block solver: card and CPU {d} m apart (err0 {err0})")
    # one GN iteration profiled: its kernel launches and host syncs
    one = PoseGraphConfig(max_iterations=1)
    g1 = pose_graph_from_numpy({"poses": poses_c, "rel": rel_c}, device="cuda")
    block_solver.PCG_ITERATIONS = 0
    kern = call_kernels(torch, lambda: optimize_pose_graph_block(g1, one), calls=1)
    pcg1 = block_solver.PCG_ITERATIONS / 2             # the warm-up call and the profiled one
    launches = None if kern is None else sum(n for n, _ in kern.values())
    syncs, copies = count_syncs(torch, lambda: optimize_pose_graph_block(g1, one), calls=1)
    log(f"[pose graph] block solver K={PG_CHAIN_K}, one GN iteration (with its final cost "
        f"assembly): {launches} kernel launches (profiler; {pcg1:.0f} PCG iterations), "
        f"device time {fmt_ms(None if kern is None else call_device_ms(kern))}, host syncs "
        f"{syncs:.0f} and host-to-device copies {copies:.0f} (the GN test, one a PCG "
        f"iteration and its first test, the chain/loop split's host read); {card}")

    # ---- dense against block on the card, every factor type ----
    gt_d, poses_d, rel_d = pg_loop_graph(torch, PG_DENSE_K, 10.0, 3, 0.01, seed=3)
    g = pose_graph_from_numpy({"poses": poses_d, "rel": rel_d,
                               **pg_single_pose_factors(PG_DENSE_K, gt_d, seed=3)}, device="cuda")
    dense, _ = optimize_pose_graph(g)
    block, _ = optimize_pose_graph_block(g)
    dd = float((dense.poses[:, :3, 3] - block.poses[:, :3, 3]).abs().max())
    ne = [block_normal_equations(g, *split_chain_loops(g.rel)) for _ in range(2)]
    same = all(torch.equal(getattr(ne[0], f), getattr(ne[1], f)) for f in ("diag", "off", "U", "g"))
    log(f"[pose graph] dense against block on the card, K={PG_DENSE_K} with every factor type: "
        f"max position difference {dd:.3e} m (tolerance {PG_DENSE_TOL}); two block "
        f"assemblies bit-identical {same}")
    if not dd <= PG_DENSE_TOL:
        raise RuntimeError(f"[pose graph] dense and block solutions {dd} m apart")


def phase_s2m(torch, seq, scans):
    from icp4dradar_tpu_torch.config import PipelineConfig
    from icp4dradar_tpu_torch.io import SyntheticSequence
    from icp4dradar_tpu_torch.io.scan import stack_scans
    from icp4dradar_tpu_torch.models import scan_to_map
    from icp4dradar_tpu_torch.ops import vgicp_fused
    from icp4dradar_tpu_torch.preprocess import draw_reve_uniforms
    from icp4dradar_tpu_torch.utils import ate_rmse

    gs = importlib.import_module("icp4dradar_tpu_torch.ops.gn_step")
    cfg = PipelineConfig()
    F, B = S2M_FRAMES, S2M_BLOCK
    s2m = scans[:F]

    def run(phase_times=None):
        out = scan_to_map.run_scan_to_map_blocked(
            s2m, cfg, block=B, use_const_velocity_rot=True, phase_times=phase_times)
        torch.cuda.synchronize()
        return out

    t0 = time.perf_counter()
    run()
    log(f"[s2m] warm-up run {time.perf_counter() - t0:.3f} s")
    torch.cuda.reset_peak_memory_stats()
    scan_to_map.SEQUENTIAL_FALLBACK_BLOCKS = 0
    vgicp_fused.VGICP_SWEEP_LAUNCHES = 0
    gs.GN_STEP_LAUNCHES = 0
    k5 = vgicp_fused.VGICP_FROZEN_LAUNCHES
    t0 = time.perf_counter()
    state, out = run()
    dt = time.perf_counter() - t0
    launches = vgicp_fused.VGICP_SWEEP_LAUNCHES
    gn_launches, k5 = gs.GN_STEP_LAUNCHES, vgicp_fused.VGICP_FROZEN_LAUNCHES - k5
    fallbacks = scan_to_map.SEQUENTIAL_FALLBACK_BLOCKS
    peak = torch.cuda.max_memory_allocated() / 2**30
    repeats = []
    for _ in range(3):
        t1 = time.perf_counter()
        run()
        repeats.append(time.perf_counter() - t1)
    log(f"[s2m] {F} frames in {dt * 1e3:.2f} ms = {F / dt:.1f} scans/s (repeats: "
        f"{', '.join(f'{F / r:.1f}' for r in repeats)} scans/s); peak device "
        f"memory {peak:.2f} GiB")
    its = out.iterations.cpu().numpy()
    expected = int(its[:B].sum() + its[B:].reshape(-1, B).max(axis=1).sum())
    log(f"[s2m] vgicp_sweep launches {launches}, expected {expected} (warm-up "
        f"sweeps {int(its[:B].sum())} + per-block max {int(expected - its[:B].sum())}); "
        f"GN sweeps per frame mean {its.mean():.2f}; fallback blocks {fallbacks}")
    if launches <= 0 or launches != expected or fallbacks != 0:
        raise RuntimeError(f"[s2m] launch count {launches} != {expected} or "
                           f"{fallbacks} blocks fell back")
    log(f"[s2m] gn_step launches {gn_launches}, expected {launches + k5} (the K4 sweeps "
        f"{launches} + K5 steps {k5})")
    if gn_launches != launches + k5:
        FAILED.append(f"[s2m] gn_step launches {gn_launches} != {launches + k5}")
    for f in ("world_T", "correction", "velocity", "velocity_sigma", "fitness"):
        x = getattr(out, f)
        if x.shape[0] != F or not bool(torch.isfinite(x).all()):
            raise RuntimeError(f"[s2m] {f}: shape {tuple(x.shape)} or non-finite")
    lost = int((out.fitness >= LOST_FITNESS).sum().item())
    poses = out.world_T.cpu().numpy()
    ate = ate_rmse(poses[:, :3, 3], seq.poses[:F, :3, 3], align=False)
    log(f"[s2m] lost frames {lost}, fitness max {out.fitness.max().item():.4f}, map "
        f"voxels {int(state.vmap.num_voxels.item())}, live submap rows max "
        f"{int(out.submap_points.max().item())}, ATE (align=False) {ate:.4f} m")
    if lost:
        raise RuntimeError(f"[s2m] {lost} lost frames")
    if not abs(ate - S2M_ATE_EXPECTED) <= S2M_ATE_BAND:
        raise RuntimeError(f"[s2m] ATE {ate:.4f} m outside "
                           f"{S2M_ATE_EXPECTED} +- {S2M_ATE_BAND} m")
    phases = {}
    t0 = time.perf_counter()
    run(phase_times=phases)
    total = time.perf_counter() - t0
    log(f"[s2m] phase split (host clock, a synchronize around each phase; "
        f"{total * 1e3:.2f} ms in all): " + ", ".join(
            f"{k} {v * 1e3:.2f} ms" for k, v in sorted(phases.items(), key=lambda kv: -kv[1])))

    # small input: the CUDA path against the CPU path on the same draws
    # (a scene small enough that 256 points per scan track without a fallback:
    # at the bench scene's density 256 points walk off, and a walk-off
    # amplifies the last bit of any difference)
    small = SyntheticSequence(num_frames=24, max_points=256, num_landmarks=400,
                              world_extent=50.0, max_range=50.0, dynamic_fraction=0.05,
                              speed=1.0, turn_rate=0.02, seed=0)
    s_cpu = stack_scans([small.scan(k) for k in range(24)])
    u = draw_reve_uniforms((24,), cfg.reve, torch.Generator().manual_seed(0))
    kw = dict(block=B, use_const_velocity_rot=True)
    scan_to_map.SEQUENTIAL_FALLBACK_BLOCKS = 0
    _, o_cpu = scan_to_map.run_scan_to_map_blocked(s_cpu, cfg, uniforms=u, **kw)
    fb_cpu = scan_to_map.SEQUENTIAL_FALLBACK_BLOCKS
    _, o_gpu = scan_to_map.run_scan_to_map_blocked(s_cpu.to("cuda"), cfg,
                                                   uniforms=u.cuda(), **kw)
    fb_gpu = scan_to_map.SEQUENTIAL_FALLBACK_BLOCKS - fb_cpu
    d = (o_gpu.world_T.cpu() - o_cpu.world_T).abs().max().item()
    same_its = bool((o_gpu.iterations.cpu() == o_cpu.iterations).all())
    log(f"[s2m] 24x256 CUDA vs CPU: max |world_T| diff {d:.3e}, GN sweeps equal "
        f"{same_its}, fallback blocks {fb_gpu} / {fb_cpu}")
    if d > 1e-3 or fb_gpu != 0 or fb_cpu != 0:
        raise RuntimeError("[s2m] CUDA and CPU paths disagree on 24x256")
    return launches, state, out, s2m, F / dt, gn_launches


def batch_launches_expected(its, block):
    """K4 launches of a batched blocked run, from its (B, F) GN sweeps: a
    warm-up frame launches as often as its slowest stream sweeps, a block as
    often as its slowest frame of all streams."""
    warm = its[:, :block].max(axis=0).sum()
    blocks = its[:, block:].reshape(its.shape[0], -1, block).max(axis=(0, 2)).sum()
    return int(warm + blocks)


def phase_batch(torch, seq, scans, s2m_rate):
    """B-stream serving (`bench.py`'s third cell): 4 streams, stream b the
    frames [256 b, 256 b + 256) of the bench sequence, through
    run_scan_to_map_batch(block=8, use_const_velocity_rot=True)."""
    from icp4dradar_tpu_torch.config import PipelineConfig
    from icp4dradar_tpu_torch.models import scan_to_map
    from icp4dradar_tpu_torch.ops import vgicp_fused
    from icp4dradar_tpu_torch.preprocess import reve_hypotheses
    from icp4dradar_tpu_torch.utils import ate_rmse, reve_batch_uniforms

    gs = importlib.import_module("icp4dradar_tpu_torch.ops.gn_step")
    cfg = PipelineConfig()
    Bs, F, blk = BATCH_STREAMS, S2M_FRAMES, S2M_BLOCK
    batch = scans[:Bs * F]
    batch = type(batch)(**{k: getattr(batch, k).reshape((Bs, F) + getattr(batch, k).shape[1:])
                           for k in ("xyz", "doppler", "intensity", "mask", "time")})
    # the REVE draws of the JAX package's run of the same batch (its
    # Threefry keys, reproduced in numpy), so that each stream is held to
    # the JAX run without the spread of another generator's draws
    U = torch.from_numpy(reve_batch_uniforms(cfg.seed, Bs, F, blk,
                                             reve_hypotheses(cfg.reve))).to(scans.xyz.device)

    def run(phase_times=None):
        out = scan_to_map.run_scan_to_map_batch(batch, cfg, uniforms=U, block=blk,
                                                use_const_velocity_rot=True,
                                                phase_times=phase_times)
        torch.cuda.synchronize()
        return out

    t0 = time.perf_counter()
    run()
    log(f"[batch] warm-up run {time.perf_counter() - t0:.3f} s")
    torch.cuda.reset_peak_memory_stats()
    vgicp_fused.VGICP_SWEEP_LAUNCHES = 0
    gs.GN_STEP_LAUNCHES = 0
    t0 = time.perf_counter()
    state, out = run()
    dt = time.perf_counter() - t0
    launches, gn_launches = vgicp_fused.VGICP_SWEEP_LAUNCHES, gs.GN_STEP_LAUNCHES
    peak = torch.cuda.max_memory_allocated() / 2**30
    repeats = []
    for _ in range(3):
        t1 = time.perf_counter()
        run()
        repeats.append(time.perf_counter() - t1)
    rate = Bs * F / dt
    log(f"[batch] {Bs} streams x {F} frames in {dt * 1e3:.2f} ms = {rate:.1f} aggregate scans/s "
        f"(repeats: {', '.join(f'{Bs * F / r:.1f}' for r in repeats)}); single-stream s2m "
        f"(phase 5) {s2m_rate:.1f} scans/s, ratio {rate / s2m_rate:.2f}; peak device memory "
        f"{peak:.2f} GiB")
    its = out.iterations.cpu().numpy()
    expected = batch_launches_expected(its, blk)
    log(f"[batch] vgicp_sweep launches {launches}, expected {expected} (per warm-up frame and "
        f"per block, the largest sweep count across streams); GN sweeps per stream "
        f"{its.sum(axis=1).tolist()}, per frame mean {its.mean():.2f}")
    if launches <= 0 or launches != expected:
        raise RuntimeError(f"[batch] launch count {launches} != {expected}")
    log(f"[batch] gn_step launches {gn_launches}, expected {launches} (one a K4 sweep)")
    if gn_launches != launches:
        FAILED.append(f"[batch] gn_step launches {gn_launches} != {launches}")
    for f in ("world_T", "correction", "velocity", "velocity_sigma", "fitness"):
        x = getattr(out, f)
        if tuple(x.shape[:2]) != (Bs, F) or not bool(torch.isfinite(x).all()):
            raise RuntimeError(f"[batch] {f}: shape {tuple(x.shape)} or non-finite")
    lost = int((out.fitness >= LOST_FITNESS).sum().item())
    poses = out.world_T.cpu().numpy()
    ates = []
    for b in range(Bs):
        gt = np.linalg.inv(seq.poses[b * F]) @ seq.poses[b * F:(b + 1) * F]
        ates.append(ate_rmse(poses[b, :, :3, 3], gt[:, :3, 3], align=False))
    log(f"[batch] lost frames {lost}, map voxels {state.vmap.num_voxels.long().tolist()}, ATE "
        f"(align=False, ground truth re-anchored at each stream's first frame) "
        + ", ".join(f"{a:.4f}" for a in ates) + " m; the JAX CPU run's "
        + ", ".join(f"{a:.4f}" for a in BATCH_ATE_JAX) + f" m (+- {BATCH_ATE_BAND})")
    if lost:
        raise RuntimeError(f"[batch] {lost} lost frames")
    for b, (a, j) in enumerate(zip(ates, BATCH_ATE_JAX)):
        if not abs(a - j) <= BATCH_ATE_BAND:
            raise RuntimeError(f"[batch] stream {b}: ATE {a:.4f} m outside {j} +- "
                               f"{BATCH_ATE_BAND} m")
    phases = {}
    t0 = time.perf_counter()
    run(phase_times=phases)
    total = time.perf_counter() - t0
    log(f"[batch] phase split (host clock, a synchronize around each phase; "
        f"{total * 1e3:.2f} ms in all): " + ", ".join(
            f"{k} {v * 1e3:.2f} ms" for k, v in sorted(phases.items(), key=lambda kv: -kv[1])))

    # stream 0 alone through the single-stream runner on the same draws
    _, one = scan_to_map.run_scan_to_map_blocked(batch[0], cfg, uniforms=U[0], block=blk,
                                                 use_const_velocity_rot=True,
                                                 sequential_fallback=False)
    one_state, one = scan_to_map.run_scan_to_map_blocked(
        batch[0], cfg, uniforms=U[0], block=blk, use_const_velocity_rot=True,
        sequential_fallback=False)
    d = (out.world_T[0, :, :3, 3] - one.world_T[:, :3, 3]).abs().max().item()
    same_its = int((out.iterations[0] == one.iterations).sum().item())
    differ = [(f.name, int(torch.nonzero((getattr(out, f.name)[0] != getattr(one, f.name))
                                         .reshape(F, -1).any(dim=1))[0, 0]))
              for f in dataclasses.fields(out)
              if not torch.equal(getattr(out, f.name)[0], getattr(one, f.name))]
    tables = all(torch.equal(a, c) for a, c in zip(state.vmap.stream(0).tables(),
                                                   one_state.vmap.tables()))
    first = min(differ, key=lambda x: x[1]) if differ else None
    log(f"[batch] stream 0 against its single-stream run on the card: "
        + ("every output equal bit for bit" if not differ else
           f"outputs differ from frame {first[1]} ({first[0]}; "
           + ", ".join(n for n, _ in differ) + ")")
        + f", tables {'equal' if tables else 'differ'}; max |position| difference {d:.3e} m, "
        f"GN sweeps equal on {same_its} of {F} frames")
    if (differ or not tables) and not (d <= BATCH_SINGLE_POS_TOL and same_its == F and tables):
        raise RuntimeError(f"[batch] stream 0 and its single-stream run disagree: {d:.3e} m, "
                           f"sweeps equal on {same_its} of {F} frames, tables "
                           f"{'equal' if tables else 'differ'}")
    phase_map_cuda_cpu(torch, state, cfg)
    return dict(launches=launches, gn_launches=gn_launches, rate=rate, state=state, out=out,
                batch=batch, uniforms=U)


def phase_session(torch, seq, scans, card):
    """The streaming session at full width: the first 256 bench frames
    (2048 points, map capacity 2^18, submap 2^14). Session A: frames 0-7
    one `process` call each, then 31 `process_batch(block=8)` calls,
    checkpointed after frame 128. Session B resumes from that file and
    feeds frames 128-255: its pose, outputs and tables must equal A's bit
    for bit."""
    from icp4dradar_tpu_torch.config import PipelineConfig
    from icp4dradar_tpu_torch.models import OdometrySession, scan_to_map, streaming
    from icp4dradar_tpu_torch.ops import vgicp_fused
    from icp4dradar_tpu_torch.utils import ate_rmse

    cfg = PipelineConfig()
    F, W, blk, ck = SESSION_FRAMES, SESSION_WARM, SESSION_BLOCK, SESSION_CHECKPOINT
    s = scans[:F]
    ckdir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                         "chip_smoke_session")
    a = OdometrySession(cfg, checkpoint_dir=ckdir, checkpoint_every=0)
    scan_to_map.SEQUENTIAL_FALLBACK_BLOCKS = 0
    vgicp_fused.VGICP_SWEEP_LAUNCHES = 0
    # K4 launches against the sweeps the outputs report: a process frame
    # launches once a sweep, a healthy batch (one block) as often as its
    # slowest frame; a batch that falls back to the sequential re-track
    # reports the re-track's sweeps, after a joint GN of 1 to
    # gicp.max_iterations sweeps that no output reports
    outs, t_proc, t_batch = [], 0.0, {"healthy": [], "re-track": []}
    split = {"process": 0, "healthy": 0, "re-track": 0, "joint": 0}
    bad, re_tracked = [], []
    for k in range(W):
        n0 = vgicp_fused.VGICP_SWEEP_LAUNCHES
        t0 = time.perf_counter()
        o = a.process(s[k])
        torch.cuda.synchronize()
        t_proc += time.perf_counter() - t0
        outs.append((o.world_T[None], o.iterations[None]))
        split["process"] += int(o.iterations.item())
        if vgicp_fused.VGICP_SWEEP_LAUNCHES - n0 != int(o.iterations.item()):
            bad.append(k)
    for f0 in range(W, F, blk):
        n0, fb0 = vgicp_fused.VGICP_SWEEP_LAUNCHES, scan_to_map.SEQUENTIAL_FALLBACK_BLOCKS
        t0 = time.perf_counter()
        o = a.process_batch(s[f0:f0 + blk], block=blk)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        outs.append((o.world_T, o.iterations))
        n = vgicp_fused.VGICP_SWEEP_LAUNCHES - n0
        healthy = scan_to_map.SEQUENTIAL_FALLBACK_BLOCKS == fb0
        t_batch["healthy" if healthy else "re-track"].append(dt)
        if healthy:
            split["healthy"] += int(o.iterations.max().item())
            ok = n == int(o.iterations.max().item())
        else:
            re_tracked.append(f0)
            split["re-track"] += int(o.iterations.sum().item())
            joint = n - int(o.iterations.sum().item())
            split["joint"] += joint
            ok = 1 <= joint <= cfg.gicp.max_iterations
        if not ok:
            bad.append(f0)
        if a.frame == ck:
            a.checkpoint()
    launches = vgicp_fused.VGICP_SWEEP_LAUNCHES
    fallbacks = scan_to_map.SEQUENTIAL_FALLBACK_BLOCKS
    world_T = torch.cat([x for x, _ in outs])
    its = torch.cat([x for _, x in outs]).cpu().numpy()
    poses = world_T.cpu().numpy()
    ate = ate_rmse(poses[:, :3, 3], seq.poses[:F, :3, 3], align=False)
    batch_rate = (F - W) / sum(sum(v) for v in t_batch.values())
    log(f"[session] {W} process calls at {W / t_proc:.1f} scans/s, {(F - W) // blk} "
        f"process_batch calls (block {blk}) at {batch_rate:.1f} scans/s (" + ", ".join(
            f"{len(v)} {k} at {blk * len(v) / sum(v):.1f}" for k, v in t_batch.items() if v)
        + f"; {card}); "
        f"vgicp_sweep launches {launches} = " + " + ".join(f"{v} {k}" for k, v in split.items())
        + f" (sweeps of the process frames, the healthy batches' largest, the re-tracked "
        f"batches' and their joint GN's); fallback blocks {fallbacks} of {(F - W) // blk}, the "
        f"batches from frames {re_tracked} (the session runs no rotation prior, as JAX's); "
        f"sweeps reported {int(its.sum())}; skipped "
        f"{a.skipped_frames}; ATE (align=False) {ate:.4f} m, the JAX CPU run's "
        f"{SESSION_ATE_JAX} m (scripts/port_session_reference.py, +- {SESSION_ATE_BAND})")
    if launches <= 0 or launches != sum(split.values()) or bad or a.skipped_frames:
        raise RuntimeError(f"[session] launches disagree with the sweeps at frames {bad}, or "
                           f"{a.skipped_frames} skipped frames")
    if not np.isfinite(poses).all() or not abs(ate - SESSION_ATE_JAX) <= SESSION_ATE_BAND:
        raise RuntimeError(f"[session] ATE {ate:.4f} m outside {SESSION_ATE_JAX} +- "
                           f"{SESSION_ATE_BAND} m, or non-finite poses")

    b = OdometrySession(cfg, checkpoint_dir=ckdir, checkpoint_every=0)
    if b.resume() != ck:
        raise RuntimeError(f"[session] resumed at frame {b.frame}, expected {ck}")
    t0 = time.perf_counter()
    rest = [b.process_batch(s[f0:f0 + blk], block=blk).world_T for f0 in range(ck, F, blk)]
    torch.cuda.synchronize()
    t_b = time.perf_counter() - t0
    same_out = torch.equal(torch.cat(rest), world_T[ck:])
    same_pose = torch.equal(b.state.world_T, a.state.world_T)
    same_tables = all(torch.equal(x, y) for x, y in zip(b.state.vmap.tables(),
                                                         a.state.vmap.tables()))
    log(f"[session] B resumed from A's checkpoint at frame {ck} and fed frames {ck}-{F - 1} "
        f"({(F - ck) / t_b:.1f} scans/s): poses {'equal' if same_out else 'differ'}, final pose "
        f"{'equal' if same_pose else 'differs'}, tables {'equal' if same_tables else 'differ'} "
        f"to A's, bit for bit; checkpoint file "
        f"{os.path.getsize(os.path.join(ckdir, 'session.npz')) / 2**20:.1f} MiB")
    if not (same_out and same_pose and same_tables):
        raise RuntimeError("[session] resume -> continue differs from the straight run")

    # the guard: an all-NaN scan is absorbed (REVE's gates drop its points,
    # nothing registers or inserts; as in the JAX session), a step whose pose
    # goes non-finite (injected) is skipped; the state stays bit for bit
    snap = [b.state.world_T.clone()] + [t.clone() for t in b.state.vmap.tables()]

    def kept():
        return all(torch.equal(x, y) for x, y in
                   zip([b.state.world_T] + list(b.state.vmap.tables()), snap))

    nan = s[0].replace(xyz=torch.full_like(s[0].xyz, float("nan")),
                       doppler=torch.full_like(s[0].doppler, float("nan")))
    b.process(nan)
    absorbed = b.skipped_frames == 0 and kept()
    real = streaming.scan_to_map_step

    def blown(*args, **kw):
        st, out = real(*args, **kw)
        return dataclasses.replace(st, world_T=st.world_T * float("nan")), out

    streaming.scan_to_map_step = blown
    try:
        b.process(s[F - 1])
    finally:
        streaming.scan_to_map_step = real
    skipped = b.skipped_frames == 1 and kept()
    log(f"[session] all-NaN scan: skipped_frames {0 if absorbed else b.skipped_frames}, state "
        f"{'kept' if absorbed else 'changed'}; a non-finite step: skipped_frames "
        f"{b.skipped_frames}, state {'kept' if skipped else 'changed'} bit for bit")
    if not (absorbed and skipped):
        raise RuntimeError("[session] the non-finite guard did not keep the state")
    return dict(session_launches=launches, session_process_rate=W / t_proc,
                session_batch_rate=batch_rate)


def phase_map_api(torch, state):
    """The ikd-Tree-style map API on phase 5's final map (capacity 2^18), on
    the card and on the CPU: tables, points, masks and counts equal."""
    from icp4dradar_tpu_torch.mapping import (
        voxel_map_add_box, voxel_map_box_search, voxel_map_delete_box,
        voxel_map_delete_box_acquire, voxel_map_delete_points, voxel_map_maybe_rehash,
        voxel_map_radius_search,
    )

    c = state.world_T[:3, 3]
    lo, hi = c - torch.tensor([30.0, 30.0, 5.0], device=c.device), c + 30.0
    probe = torch.cat([state.vmap.points[state.vmap.occupied > 0.5][:3000],
                       c + torch.rand((500, 3), device=c.device) * 500.0 + 200.0])
    pmask = (torch.arange(probe.shape[0], device=c.device) % 3 != 0).float()

    def run(dev):
        vm = state.vmap.with_tables(t.to(dev) for t in state.vmap.tables())
        cd, lod, hid = c.to(dev), lo.to(dev), hi.to(dev)
        deleted = voxel_map_delete_box(vm, lod, hid)
        acq = voxel_map_delete_box_acquire(vm, lod, hid, 1 << 14)
        added = voxel_map_add_box(deleted, lod, cd)
        outs = {
            "radius_search": voxel_map_radius_search(vm, cd, 40.0, 1 << 14),
            "box_search": voxel_map_box_search(vm, lod, hid, 1 << 14),
            "delete_box": deleted.tables(),
            "delete_box_acquire": acq[0].tables() + acq[1:],
            "add_box": added.tables(),
            "delete_points": voxel_map_delete_points(vm, probe.to(dev), pmask.to(dev)).tables(),
            "maybe_rehash": voxel_map_maybe_rehash(deleted, 0.001).tables(),
        }
        torch.cuda.synchronize()
        return outs

    t0 = time.perf_counter()
    gpu = run(c.device)
    ms = (time.perf_counter() - t0) * 1e3
    cpu = run("cpu")
    bad = [k for k in gpu if not all(torch.equal(a.cpu(), b) for a, b in zip(gpu[k], cpu[k]))]
    log(f"[s2m] map API on the final map (capacity {state.vmap.capacity}): radius search "
        f"{int(gpu['radius_search'][2])} points, box search {int(gpu['box_search'][2])}, box "
        f"delete {int(gpu['delete_box_acquire'][-1])} removed; CUDA equal to CPU for "
        f"{len(gpu) - len(bad)} of {len(gpu)} ({', '.join(bad) or 'all'}"
        f"{' differ' if bad else ''}); {ms:.2f} ms on the card")
    if bad:
        raise RuntimeError(f"[s2m] map API: CUDA and CPU differ in {bad}")


def phase_map_cuda_cpu(torch, state, cfg):
    """Forget and rehash on the batch's final maps, on the card and on the
    CPU: the tables must be equal."""
    from icp4dradar_tpu_torch.mapping import voxel_map_forget_far, voxel_map_maybe_rehash

    radius = 40.0
    res = {}
    for dev in ("cuda", "cpu"):
        vm = state.vmap if dev == "cuda" else state.vmap.with_tables(
            t.cpu() for t in state.vmap.tables())
        center = state.world_T[:, :3, 3].to(dev)
        t0 = time.perf_counter()
        f = voxel_map_forget_far(vm, center, radius)
        r = voxel_map_maybe_rehash(f, cfg.voxel_map.rehash_tombstone_fraction)
        if dev == "cuda":
            torch.cuda.synchronize()
        res[dev] = (f, r, time.perf_counter() - t0)
    same = all(torch.equal(a.cpu(), b) for k in (0, 1)
               for a, b in zip(res["cuda"][k].tables(), res["cpu"][k].tables()))
    kept = res["cuda"][1].num_voxels.long().tolist()
    log(f"[batch] forget ({radius} m around the final poses) + maybe_rehash on the final maps: "
        f"CUDA equal to CPU {same}; voxels {state.vmap.num_voxels.long().tolist()} -> {kept}; "
        f"{res['cuda'][2] * 1e3:.2f} ms on the card, {res['cpu'][2] * 1e3:.2f} ms on the CPU")
    if not same:
        raise RuntimeError("[batch] forget/rehash: CUDA and CPU tables differ")


def phase_vgicp(torch, state, out, s2m):
    from icp4dradar_tpu_torch.config import PipelineConfig
    from icp4dradar_tpu_torch.geom import matrix_to_rpy, se3_exp
    from icp4dradar_tpu_torch.mapping import voxel_map_sector_search_with_stats
    from icp4dradar_tpu_torch.models.scan_to_map import (
        _sort_scans_by_sensor_x, _sort_submap_by_axis,
    )
    from icp4dradar_tpu_torch.ops import vgicp_fused as vf
    from icp4dradar_tpu_torch.ops.vgicp_fused import (
        radar_point_covariances_packed, vgicp_iteration, vgicp_iteration_batch,
        vgicp_iteration_plain,
    )

    cfg = PipelineConfig()
    vm, g = cfg.voxel_map, cfg.gicp
    dev = s2m.xyz.device
    rng = np.random.default_rng(1)
    names = ("H", "g", "cost", "wsum", "d2sum", "best")
    max_err = 0.0

    def both(name, *args, batch=False, **kw):
        kw = dict(kw, max_correspondence_dist=g.max_correspondence_dist,
                  cov_eps=g.cov_epsilon, return_best=True)
        if batch:
            Bn, Nn = args[1].shape[:2]
            kw["ts"] = min(kw.get("ts", 2048), max(8, Nn))    # one block per frame
            k = vgicp_iteration_batch(*args, **kw)
            flat = (args[0], args[1].reshape(Bn * Nn, 3), args[2].reshape(Bn * Nn),
                    args[3].reshape(Bn * Nn, 6)) + args[4:]
            torch.cuda.synchronize()
            p = vgicp_iteration_plain(*flat, _acc_groups=Bn, **kw)
        else:
            k = vgicp_iteration(*args, **kw)
            torch.cuda.synchronize()
            p = vgicp_iteration_plain(*args, **kw)
        errs = []
        for n, a, b in zip(names, k, p):
            a, b = a.double().cpu(), b.double().cpu()
            if not (bool(torch.isfinite(a).all()) and bool(torch.isfinite(b).all())):
                raise RuntimeError(f"[vgicp] {name}: non-finite {n}")
            bad = (a - b).abs() > VG_ATOL + VG_RTOL * b.abs()
            errs.append((n, (a - b).abs().max().item(), int(bad.sum())))
        log(f"[vgicp] {name}: " + "; ".join(f"{n} abs {e:.3e}" for n, e, _ in errs))
        if any(nb for _, _, nb in errs):
            raise RuntimeError(f"[vgicp] {name}: beyond rtol {VG_RTOL} / atol {VG_ATOL}: "
                               + ", ".join(f"{n} {nb}" for n, _, nb in errs if nb))
        return max(e for n, e, _ in errs if n != "best"), k

    # the bench block: the last 8 frames, sorted as the tracker sorts them,
    # at their tracked poses, against the warm map's sector submap
    B = S2M_BLOCK
    scans_b = _sort_scans_by_sensor_x(s2m[-B:])
    T = out.world_T[-B:].contiguous()
    pose0 = state.world_T
    heading = matrix_to_rpy(pose0[:3, :3])[2]
    _, submask, sub_n, sub_mean, sub_cov = voxel_map_sector_search_with_stats(
        state.vmap, pose0[:3, 3], vm.sector_radius, heading, vm.sector_half_angle_deg,
        vm.submap_max_points, min_count=vm.stats_min_count,
        fallback_var=vm.stats_fallback_var)
    hrad = heading * (np.pi / 180.0)
    axis2 = torch.stack([torch.cos(hrad), torch.sin(hrad)])
    sub_mean, sub_cov, submask = _sort_submap_by_axis(sub_mean, sub_cov, submask, axis2)
    center = T[0, :3, 3].clone()
    Tc = T.clone()
    Tc[:, :3, 3] -= center
    src, sm = scans_b.xyz.contiguous(), scans_b.mask.contiguous()
    scov = radar_point_covariances_packed(src, g.sigma_range, g.sigma_azimuth,
                                          g.sigma_elevation).contiguous()
    tgt = (sub_mean - center).contiguous()
    count = int(sub_n.item())
    P = tgt.shape[0]
    bench = (Tc, src, sm, scov, tgt, sub_cov.contiguous(), submask.contiguous())
    err, _ = both(f"bench B={B} 2048 x {P} rows ({count} live)", *bench, batch=True,
                  tgt_count=sub_n, gate_axis=axis2)
    max_err = max(max_err, err)

    # every row of a 16,384-row submap live: the live rows jittered over the
    # whole table, and voxel-like covariances
    reps = -(-P // max(count, 1))
    full = torch.cat([sub_mean[:count]] * reps)[:P] - center
    full = full + torch.from_numpy(rng.normal(0, 0.3, (P, 3)).astype(np.float32)).to(dev)
    fcov = torch.cat([sub_cov[:count]] * reps)[:P].contiguous()
    ones = torch.ones(P, device=dev)
    err, _ = both(f"fully live B={B} 2048 x {P}", Tc, src, sm, scov, full.contiguous(),
                  fcov, ones, batch=True, tgt_count=torch.tensor(P, device=dev))
    max_err = max(max_err, err)

    # ragged: one frame of 1000 points with random masks against 5000 rows
    # of which 70% are masked in at random (no live count: every tile swept)
    n, m = 1000, 5000
    rsrc = torch.from_numpy(rng.uniform(-40, 40, (n, 3)).astype(np.float32)).to(dev)
    rsm = torch.from_numpy((rng.uniform(size=n) > 0.2).astype(np.float32)).to(dev)
    rtgt = torch.from_numpy(rng.uniform(-40, 40, (m, 3)).astype(np.float32)).to(dev)
    rtm = torch.from_numpy((rng.uniform(size=m) > 0.3).astype(np.float32)).to(dev)
    rcov = fcov[:m]
    err, _ = both("ragged 1000 x 5000 masked", Tc[0], rsrc, rsm,
                  radar_point_covariances_packed(rsrc), rtgt, rcov, rtm)
    max_err = max(max_err, err)

    # exact ties: rows 3 and 700 of tile 0 at d2 = 5 average to (1, 0, 0);
    # row 1500 of tile 1 at the same d2 does not replace them; rows 1100
    # and 1800 of tile 1 at d2 = 2 replace tile 0's d2 = 9 and average
    tt = torch.full((2048, 3), 90.0, device=dev)
    for row, v in ((3, (1., 2., 0.)), (700, (1., -2., 0.)), (1500, (-1., 2., 0.)),
                   (5, (20., 3., 0.)), (1100, (21., 0., 1.)), (1800, (19., 0., -1.))):
        tt[row] = torch.tensor(v, device=dev)
    tsrc = torch.tensor([[0.0, 0.0, 0.0], [20.0, 0.0, 0.0]], device=dev)
    _, k = both("exact ties", torch.eye(4, device=dev), tsrc, torch.ones(2, device=dev),
                radar_point_covariances_packed(tsrc), tt, fcov[:2048],
                torch.ones(2048, device=dev), ts=8)
    best = k[5][0].cpu()
    if best[:4, 0].tolist() != [5.0, 1.0, 0.0, 0.0] or \
            best[:4, 1].tolist() != [2.0, 20.0, 0.0, 0.0]:
        raise RuntimeError(f"[vgicp] exact ties: payloads {best[:4, :2].T.tolist()}")

    # three rows of one 1024-row tile at d2 = 5 from source 0, in three of
    # the kernel's eight row ranges with 200 masked rows before the second,
    # average in row order (dyadic covariances: every order sums alike)
    tt = torch.full((1024, 3), 90.0, device=dev)
    for row, v in ((3, (2., 1., 0.)), (400, (1., 2., 0.)), (1000, (-2., 1., 0.))):
        tt[row] = torch.tensor(v, device=dev)
    tcov = torch.zeros((1024, 6), device=dev)
    tcov[:, :3] = torch.arange(1024, dtype=torch.float32, device=dev)[:, None] / 64.0
    tmask3 = torch.ones(1024, device=dev)
    tmask3[100:300] = 0.0
    _, k = both("three-way ties across row ranges", torch.eye(4, device=dev), tsrc,
                torch.ones(2, device=dev), radar_point_covariances_packed(tsrc), tt, tcov,
                tmask3, ts=8)
    three = np.float32(3.0)
    want = [5.0, float(np.float32(1.0) / three), float(np.float32(4.0) / three), 0.0,
            float(np.float32(1403 / 64.0) / three)]
    if k[5][0, :5, 0].tolist() != want:
        raise RuntimeError(f"[vgicp] three-way ties: payload {k[5][0, :5, 0].tolist()}, "
                           f"expected {want}")

    # an empty submap: nothing matches, every sum is zero
    _, k = both("empty submap", Tc, src, sm, scov, tgt, sub_cov.contiguous(),
                torch.zeros(P, device=dev), batch=True,
                tgt_count=torch.tensor(0, device=dev))
    if float(k[3].abs().sum()) != 0.0:
        raise RuntimeError("[vgicp] empty submap matched something")

    # operands prepared once, as the GN loop prepares them, against the
    # per-call path at two transforms: equal
    kw = dict(max_correspondence_dist=g.max_correspondence_dist, cov_eps=g.cov_epsilon)
    ops = vf.vgicp_prepare(*bench[1:], tgt_count=sub_n, gate_axis=axis2)
    for step in (0.0, 0.02):
        Ts = (se3_exp(torch.full((B, 6), step, device=dev)) @ Tc).contiguous()
        a = vf.vgicp_sweep(Ts, ops, return_best=True, _acc_groups=B, **kw)
        b = vgicp_iteration_batch(Ts, *bench[1:], tgt_count=sub_n, gate_axis=axis2,
                                  return_best=True, **kw)
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            raise RuntimeError(f"[vgicp] prepared operands and the per-call path differ "
                               f"(step {step})")
    log("[vgicp] prepared operands: equal to the per-call path at two transforms")

    # time the bench block in turns; 20 calls per event window (one call
    # is a few microseconds of device work, below the events' resolution)
    flat = (Tc, src.reshape(-1, 3), sm.reshape(-1), scov.reshape(-1, 6)) + bench[4:]
    calls = 20
    gate, eps = vf.sweep_gate(g.max_correspondence_dist), float(np.float32(g.cov_epsilon))
    lib = vf._lib()
    part = torch.empty((B, -(-ops.per_frame // lib.vgicp_sweep_sources_per_block()),
                        vf.NUM_ACC), dtype=torch.float64, device=dev)
    launch_args = (Tc.data_ptr(), ops.src.data_ptr(), ops.tgt.data_ptr(), ops.tgt_cov.data_ptr(),
                   ops.tile_live.data_ptr(), ops.count.data_ptr(), B, ops.per_frame, 0, 0, B,
                   ops.rows, ops.tm, ops.ts, gate, eps, part.data_ptr(), None,
                   torch.cuda.current_stream().cuda_stream)

    def per_call():
        for _ in range(calls):
            vgicp_iteration_batch(*bench, tgt_count=sub_n, gate_axis=axis2, **kw)

    def prepared():
        for _ in range(calls):
            vf.vgicp_sweep(Tc, ops, _acc_groups=B, **kw)

    def launch_only():
        # the kernel alone, on arguments made once: no allocation, no
        # Python around it
        for _ in range(calls):
            rc = lib.vgicp_sweep_launch(*launch_args)
            if rc != 0:
                raise RuntimeError(f"[vgicp] launch failed: CUDA error {rc}")

    def plain():
        for _ in range(calls):
            vgicp_iteration_plain(*flat, _acc_groups=B, ts=min(2048, src.shape[1]),
                                  tgt_count=sub_n, gate_axis=axis2, **kw)

    order = (plain, per_call, prepared, launch_only, launch_only, prepared, per_call, plain)
    p1, w1, c1, l1, l2, c2, w2, p2 = (time_cuda(torch, f) / calls for f in order)
    dev_ms = kernel_device_ms(torch, prepared, ("vgicp_sweep_kernel",))
    ms, plain_ms = (c1 + c2) / 2, (p1 + p2) / 2
    N = src.shape[1]
    live_rows = min(P, count)
    # inputs read once: T, the sources (xyz, mask, cov6), the live target
    # rows (mean, cov6, mask), the count; (B, 30) sums out
    from icp4dradar_tpu_torch.utils import roofline as rl

    bound_ms, bound_by = rl.vgicp_sweep_bound(B, N, [live_rows]).bound()
    log(f"[vgicp] time at B={B} x {N} x {P} rows ({count} live): the call on prepared "
        f"operands {c1:.4f} / {c2:.4f} ms, the launch alone {l1:.4f} / {l2:.4f} ms (device "
        f"time {fmt_ms(dev_ms)} a launch, profiler), the "
        f"per-call wrapper (packing included) {w1:.4f} / {w2:.4f} ms, plain {p1:.4f} / "
        f"{p2:.4f} ms; bound {bound_ms:.5f} ms ({bound_by})")
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None), (Tc, ops, bench, sub_n, axis2)


def phase_vgicp_streams(torch, batch):
    """K4 with its stream axis at the batch cell's block shape: the last 8
    frames of each of the 4 streams at their tracked poses against the 4
    streams' real submaps (the batch's final maps), and with stream 2's
    submap empty. Each against the plain version (rtol 1e-5 / atol 1e-4)
    and against 4 single-target calls (bit for bit expected; any difference
    is printed and must stay below 1e-6 relative). The batched call on
    prepared operands must be one vgicp_sweep_kernel launch with no host
    sync; it is timed against the 4 single-target calls, in turns."""
    from icp4dradar_tpu_torch.config import PipelineConfig
    from icp4dradar_tpu_torch.geom import matrix_to_rpy
    from icp4dradar_tpu_torch.mapping import voxel_map_sector_search_with_stats
    from icp4dradar_tpu_torch.models.scan_to_map import (
        _sort_scans_by_sensor_x, _sort_submap_by_axis,
    )
    from icp4dradar_tpu_torch.ops import vgicp_fused as vf
    from icp4dradar_tpu_torch.ops.vgicp_fused import (
        radar_point_covariances_packed, vgicp_iteration_batch, vgicp_iteration_plain,
    )

    cfg = PipelineConfig()
    vm, g = cfg.voxel_map, cfg.gicp
    kw = dict(max_correspondence_dist=g.max_correspondence_dist, cov_eps=g.cov_epsilon)
    state, out, scans = batch["state"], batch["out"], batch["batch"]
    S, B = BATCH_STREAMS, S2M_BLOCK
    sc = _sort_scans_by_sensor_x(scans[:, -B:])
    N = sc.xyz.shape[-2]
    T = out.world_T[:, -B:]
    pose0 = state.world_T
    heading = matrix_to_rpy(pose0[:, :3, :3])[:, 2]
    _, submask, sub_n, sub_mean, sub_cov = voxel_map_sector_search_with_stats(
        state.vmap, pose0[:, :3, 3], vm.sector_radius, heading, vm.sector_half_angle_deg,
        vm.submap_max_points, min_count=vm.stats_min_count, fallback_var=vm.stats_fallback_var)
    hrad = heading * (np.pi / 180.0)
    axis2 = torch.stack([torch.cos(hrad), torch.sin(hrad)], dim=-1)
    sub_mean, sub_cov, submask = _sort_submap_by_axis(sub_mean, sub_cov, submask, axis2)
    center = T[:, 0, :3, 3].clone()
    Tc = T.clone()
    Tc[..., :3, 3] -= center[:, None]
    Tc = Tc.reshape(S * B, 4, 4).contiguous()
    src, sm = sc.xyz.reshape(S * B, N, 3).contiguous(), sc.mask.reshape(S * B, N).contiguous()
    scov = radar_point_covariances_packed(src, g.sigma_range, g.sigma_azimuth,
                                          g.sigma_elevation).contiguous()
    tgt = (sub_mean - center[:, None]).contiguous()
    P = tgt.shape[1]
    names = ("H", "g", "cost", "wsum", "d2sum", "best")
    max_err = 0.0

    def check(name, tmask, cnt):
        nonlocal max_err
        ops = vf.vgicp_prepare(src, sm, scov, tgt, sub_cov, tmask, tgt_count=cnt,
                               gate_axis=axis2)
        k = vf.vgicp_sweep(Tc, ops, return_best=True, _acc_groups=S * B, **kw)
        torch.cuda.synchronize()
        p = vgicp_iteration_plain(Tc, src.reshape(-1, 3), sm.reshape(-1), scov.reshape(-1, 6),
                                  tgt, sub_cov, tmask, tgt_count=cnt, gate_axis=axis2,
                                  return_best=True, ts=ops.ts, _acc_groups=S * B, **kw)
        errs, rel, equal = [], 0.0, True
        nb = B * N // ops.ts
        for n, a, b in zip(names, k, p):
            a, b = a.double().cpu(), b.double().cpu()
            if not (bool(torch.isfinite(a).all()) and bool(torch.isfinite(b).all())):
                raise RuntimeError(f"[vgicp] {name}: non-finite {n}")
            if bool(((a - b).abs() > VG_ATOL + VG_RTOL * b.abs()).any()):
                raise RuntimeError(f"[vgicp] {name}: {n} beyond rtol {VG_RTOL} / atol "
                                   f"{VG_ATOL} of the plain version")
            errs.append((n, (a - b).abs().max().item()))
        for st in range(S):
            fs = slice(st * B, (st + 1) * B)
            one = vgicp_iteration_batch(Tc[fs], src[fs], sm[fs], scov[fs], tgt[st], sub_cov[st],
                                        tmask[st], tgt_count=cnt[st], gate_axis=axis2[st],
                                        return_best=True, **kw)
            pairs = [(k[i][fs], one[i]) for i in range(5)]
            pairs.append((k[5][st * nb:(st + 1) * nb], one[5]))
            for a, b in pairs:
                equal &= torch.equal(a, b)
                d = (a.double() - b.double()).abs()
                rel = max(rel, (d / b.double().abs().clamp(min=1e-30)).max().item())
        log(f"[vgicp] {name}: against plain " + "; ".join(f"{n} abs {e:.3e}" for n, e in errs)
            + f"; against {S} single-target calls: bit for bit {equal}, largest relative "
            f"difference {rel:.3e}")
        if rel > 1e-6:
            raise RuntimeError(f"[vgicp] {name}: {rel:.3e} relative from the single-target calls")
        max_err = max([max_err] + [e for n, e in errs if n != "best"])
        return ops, k

    counts = sub_n.tolist()
    ops, _ = check(f"streams S={S} x B={B} x {N} against {P}-row submaps ({counts} live)",
                   submask.contiguous(), sub_n)
    empty_mask, empty_n = submask.clone(), sub_n.clone()
    empty_mask[2], empty_n[2] = 0.0, 0
    _, k = check(f"streams S={S} x B={B}, stream 2's submap empty", empty_mask.contiguous(),
                 empty_n)
    if float(k[3][2 * B:3 * B].abs().sum()) != 0.0:
        raise RuntimeError("[vgicp] the empty stream matched something")

    singles = [vf.vgicp_prepare(src[st * B:(st + 1) * B], sm[st * B:(st + 1) * B],
                                scov[st * B:(st + 1) * B], tgt[st], sub_cov[st], submask[st],
                                tgt_count=sub_n[st], gate_axis=axis2[st]) for st in range(S)]
    Ts = [Tc[st * B:(st + 1) * B].contiguous() for st in range(S)]
    calls = 20

    def batched():
        for _ in range(calls):
            vf.vgicp_sweep(Tc, ops, _acc_groups=S * B, **kw)

    def separate():
        for _ in range(calls):
            for st in range(S):
                vf.vgicp_sweep(Ts[st], singles[st], _acc_groups=B, **kw)

    def plain():
        vgicp_iteration_plain(Tc, src.reshape(-1, 3), sm.reshape(-1), scov.reshape(-1, 6), tgt,
                              sub_cov, submask, tgt_count=sub_n, gate_axis=axis2, ts=ops.ts,
                              _acc_groups=S * B, **kw)

    b1, s1, s2, b2 = (time_cuda(torch, f) / calls for f in (batched, separate, separate, batched))
    p1 = time_cuda(torch, plain, reps=3, warmup=1)
    dev_ms = kernel_device_ms(torch, lambda: vf.vgicp_sweep(Tc, ops, _acc_groups=S * B, **kw),
                              ("vgicp_sweep_kernel",))
    kernels = call_kernels(torch, lambda: vf.vgicp_sweep(Tc, ops, _acc_groups=S * B, **kw))
    log(f"[vgicp] kernels of one batched call (profiler; the sweep, then _finish's sum, "
        f"cast and unpack): {fmt_kernels(kernels)}")
    if kernels is not None and not (0.5 < kernels.get("vgicp_sweep_kernel", (0, 0))[0] <= 1.0):
        raise RuntimeError(f"[vgicp] one batched call launched {fmt_kernels(kernels)}; "
                           f"expected one vgicp_sweep_kernel")
    syncs = count_syncs(torch, lambda: vf.vgicp_sweep(Tc, ops, _acc_groups=S * B, **kw))
    log(f"[vgicp] host syncs of one batched call (synchronise calls, host-to-device copies): "
        f"{syncs[0]:.2f}, {syncs[1]:.2f}")
    if syncs[0] or syncs[1]:
        raise RuntimeError(f"[vgicp] the batched call syncs the host: {syncs}")
    live = [min(P, c) for c in counts]
    from icp4dradar_tpu_torch.utils import roofline as rl

    bound_ms, bound_by = rl.vgicp_sweep_bound(B, N, live).bound()
    log(f"[vgicp] time at S={S} streams x B={B} x {N} against {P}-row submaps ({sum(live)} live "
        f"rows): the batched call on prepared operands {b1:.4f} / {b2:.4f} ms (device time "
        f"{fmt_ms(dev_ms)} a launch, profiler), {S} single-target calls {s1:.4f} / {s2:.4f} ms, "
        f"plain {p1:.4f} ms; bound {bound_ms:.5f} ms ({bound_by})")
    return dict(batch_ms=(b1 + b2) / 2, batch_device_ms=dev_ms, batch_separate_ms=(s1 + s2) / 2,
                batch_plain_ms=p1, batch_bound_ms=bound_ms, batch_max_abs_err=max_err)


def _lost(out):
    """Per-frame lost flags of a per-frame tracker's outputs: fitness 1e6 or
    non-finite, or nothing matched (fitness 0) after the first frame."""
    fit = out.fitness
    lost = (fit >= LOST_FITNESS) | ~fit.isfinite()
    lost[1:] |= fit[1:] == 0.0
    return lost


def _check_track(tag, torch, out, F):
    for f in ("world_T", "correction", "velocity", "velocity_sigma", "fitness"):
        x = getattr(out, f)
        if x.shape[0] != F or not bool(torch.isfinite(x).all()):
            raise RuntimeError(f"[{tag}] {f}: shape {tuple(x.shape)} or non-finite")
    lost = int(_lost(out).sum().item())
    if lost:
        raise RuntimeError(f"[{tag}] {lost} lost frames")


def _timed_tracker(torch, tag, run, reset):
    """One warm-up run, then one timed run with the launch counts reset
    just before it -> (outputs, seconds, peak GiB)."""
    t0 = time.perf_counter()
    run()
    log(f"[{tag}] warm-up run {time.perf_counter() - t0:.3f} s")
    torch.cuda.reset_peak_memory_stats()
    reset()
    t0 = time.perf_counter()
    res = run()
    dt = time.perf_counter() - t0
    return res, dt, torch.cuda.max_memory_allocated() / 2**30


def phase_gicp(torch, seq, scans):
    import importlib

    from icp4dradar_tpu_torch.config import PipelineConfig
    from icp4dradar_tpu_torch.io import SyntheticSequence
    from icp4dradar_tpu_torch.io.scan import stack_scans
    from icp4dradar_tpu_torch.models import scan_to_map
    from icp4dradar_tpu_torch.preprocess import draw_reve_uniforms
    from icp4dradar_tpu_torch.utils import ate_rmse

    from icp4dradar_tpu_torch.geom import matrix_to_rpy, se3_apply
    from icp4dradar_tpu_torch.mapping import voxel_map_sector_search
    from icp4dradar_tpu_torch.registration import gicp as gicp_mod
    from icp4dradar_tpu_torch.registration import gicp_align

    nn = importlib.import_module("icp4dradar_tpu_torch.ops.knn")
    cfg = PipelineConfig().override(**{"gicp.use_vgicp": False})
    F = TRACK_FRAMES
    track = scans[:F]

    def run(phase_times=None):
        res = scan_to_map.run_scan_to_map(track, cfg, use_const_velocity_rot=True,
                                          phase_times=phase_times)
        torch.cuda.synchronize()
        return res

    def reset():
        nn.NN_SEARCH_LAUNCHES = 0
        nn.NN_PACK_LAUNCHES = 0

    (state, out), dt, peak = _timed_tracker(torch, "gicp", run, reset)
    launches, packs = nn.NN_SEARCH_LAUNCHES, nn.NN_PACK_LAUNCHES
    its = out.iterations.cpu().numpy()
    log(f"[gicp] {F} frames in {dt * 1e3:.2f} ms = {F / dt:.2f} scans/s; peak device "
        f"memory {peak:.2f} GiB")
    log(f"[gicp] nn_search launches {launches}, expected {int(its.sum()) + F} (GN "
        f"iterations {int(its.sum())} + {F} fitness searches); nn_pack launches {packs}, "
        f"expected {F} (one a registration); GN iterations per frame mean "
        f"{its.mean():.2f}, max {int(its.max())}")
    if launches <= 0 or launches != int(its.sum()) + F or packs != F:
        raise RuntimeError(f"[gicp] launch counts {launches} / {packs} != iterations "
                           f"{int(its.sum())} + {F} / {F}")
    _check_track("gicp", torch, out, F)
    poses = out.world_T.cpu().numpy()
    ate = ate_rmse(poses[:, :3, 3], seq.poses[:F, :3, 3], align=False)
    log(f"[gicp] fitness max {out.fitness.max().item():.4f}, map voxels "
        f"{int(state.vmap.num_voxels.item())}, live submap rows max "
        f"{int(out.submap_points.max().item())}, ATE (align=False) {ate:.4f} m")
    if not ate <= GICP_ATE_MAX:
        raise RuntimeError(f"[gicp] ATE {ate:.4f} m above {GICP_ATE_MAX} m")
    phases = {}
    t0 = time.perf_counter()
    run(phase_times=phases)
    total = time.perf_counter() - t0
    log(f"[gicp] phase split (host clock, a synchronize around each phase; "
        f"{total * 1e3:.2f} ms in all): " + ", ".join(
            f"{k} {v * 1e3:.2f} ms" for k, v in sorted(phases.items(), key=lambda kv: -kv[1])))

    # the covariances over the live rows (what gicp_align computes) against
    # the all-rows point_covariances at the path shape: the last scan at its
    # tracked pose and the sector submap of the final map there
    vm = cfg.voxel_map
    pose = out.world_T[-1]
    sub, submask, _ = voxel_map_sector_search(
        state.vmap, pose[:3, 3], vm.sector_radius, matrix_to_rpy(pose[:3, :3])[2],
        vm.sector_half_angle_deg, vm.submap_max_points)
    diffs = []
    for what, pts, m in (("submap", sub, submask),
                         ("scan", se3_apply(pose, track.xyz[-1]), track.mask[-1])):
        full = gicp_mod.point_covariances(pts, m)
        live = gicp_mod.live_point_covariances(pts, m)
        on = m > 0.5
        diffs.append((what, int(on.sum()), pts.shape[0],
                      (full[on] - live[on]).abs().max().item() if bool(on.any()) else 0.0,
                      bool(torch.isfinite(live).all())))
    log("[gicp] live-row covariances against point_covariances at the path shape, largest "
        "|difference| on the live rows: " + ", ".join(
            f"{w} {n} live of {r} rows {d:.3e} (all finite {fin})" for w, n, r, d, fin in diffs))
    if any(d != 0.0 or not fin for _, _, _, d, fin in diffs):
        # the later phases still run and print; main fails before its result
        FAILED.append("[gicp] live-row covariances differ from point_covariances")

    # one profiled run: the device time of the covariances (the k-NN's
    # products and row sorts, the neighbourhoods and normals) inside a
    # record_function range around each live_point_covariances call
    orig_cov = gicp_mod.live_point_covariances

    def traced_cov(*a, **k):
        with torch.profiler.record_function("covariance_knn"):
            return orig_cov(*a, **k)

    gicp_mod.live_point_covariances = traced_cov
    PF = GICP_PROFILE_FRAMES

    def run_profiled():
        res = scan_to_map.run_scan_to_map(track[:PF], cfg, use_const_velocity_rot=True)
        torch.cuda.synchronize()
        return res

    try:
        prof, run_launches = profile_run(
            torch, f"gicp (first {PF} frames)", 1, run_profiled,
            expect=({"nn_search_kernel", "nn_pack_kernel"}, {"nn_merge_kernel",
                                                              "nn_split_kernel"}),
            ranges=("covariance_knn",))
    finally:
        gicp_mod.live_point_covariances = orig_cov
    if prof is not None:
        cov_ms, cov_launches, widest = range_device(torch, prof, "covariance_knn")
        sorts = [e for e in prof.key_averages() if e.device_type ==
                 torch.autograd.DeviceType.CUDA and "Sort" in e.key]
        log(f"[gicp] covariances (k-NN included) device time {cov_ms:.2f} ms over the first "
            f"{PF} frames ({cov_ms / PF:.3f} ms a frame) in {cov_launches} launches "
            f"({cov_launches / PF:.1f} a frame); the run's launches {run_launches / PF:.1f} a "
            f"frame; widest sort row in the covariances "
            f"{widest} columns; sort kernels of the run: " + ", ".join(
                f"{e.key[:60]} x{e.count} {e.self_device_time_total / 1e3:.2f} ms"
                for e in sorts))
        if widest >= vm.submap_max_points or cov_ms <= 0.0:
            raise RuntimeError(f"[gicp] covariances: widest sort row {widest} columns, "
                               f"device time {cov_ms} ms")

    # small input: the CUDA path against the CPU path on the same draws, on
    # the scene of phase 5's check, whose frames converge in 3-6 iterations.
    # World-frame kNN GICP passes a last-bit difference (the card's and the
    # CPU's reductions and elementwise kernels) on through the map: a stored point
    # that moves by an ulp may change voxel, and the next frames register
    # against a different map. So the tracks are held to the same accuracy
    # (ATE within 0.01 m, no lost frame), and the registration alone, on
    # identical inputs, to 5e-3 on every transform entry: the same four
    # registrations in float32 against float64 on the CPU differ by up to
    # 3.7e-3 (printed below: the f32 GN's own round-off at a 1e-4 stopping
    # step).
    small = SyntheticSequence(num_frames=12, max_points=256, num_landmarks=400,
                              world_extent=50.0, max_range=50.0, dynamic_fraction=0.05,
                              speed=1.0, turn_rate=0.02, seed=0)
    s_cpu = stack_scans([small.scan(k) for k in range(12)])
    u = draw_reve_uniforms((12,), cfg.reve, torch.Generator().manual_seed(0))
    scfg = cfg.override(**{"voxel_map.capacity": 1 << 14,
                           "voxel_map.submap_max_points": 1 << 12})
    kw = dict(use_const_velocity_rot=True)
    st_cpu, o_cpu = scan_to_map.run_scan_to_map(s_cpu, scfg, uniforms=u, **kw)
    _, o_gpu = scan_to_map.run_scan_to_map(s_cpu.to("cuda"), scfg, uniforms=u.cuda(), **kw)
    d = (o_gpu.world_T.cpu() - o_cpu.world_T).abs().max().item()
    a_cpu, a_gpu = (ate_rmse(o.world_T.cpu().numpy()[:, :3, 3], small.poses[:, :3, 3],
                             align=False) for o in (o_cpu, o_gpu))
    log(f"[gicp] 12x256 CUDA vs CPU tracks: max |world_T| diff {d:.3e}, ATE {a_gpu:.4f} / "
        f"{a_cpu:.4f} m, GN iterations {o_gpu.iterations.tolist()} / "
        f"{o_cpu.iterations.tolist()}")
    if abs(a_gpu - a_cpu) > 0.01 or bool(_lost(o_gpu).any()) or bool(_lost(o_cpu).any()):
        raise RuntimeError("[gicp] CUDA and CPU tracks disagree on 12x256")
    vm = scfg.voxel_map
    reg = []
    for k in range(8, 12):
        pose = o_cpu.world_T[k]
        sub, sm, _ = voxel_map_sector_search(
            st_cpu.vmap, pose[:3, 3], vm.sector_radius, matrix_to_rpy(pose[:3, :3])[2],
            vm.sector_half_angle_deg, vm.submap_max_points)
        src = se3_apply(pose, s_cpu.xyz[k]) + torch.tensor([0.3, -0.2, 0.05])
        args = (src, sub, s_cpu.mask[k], sm)
        g_cpu = gicp_align(*args, cfg=scfg.gicp)
        g_gpu = gicp_align(*(x.cuda() for x in args), cfg=scfg.gicp)
        g_f64 = gicp_align(*(x.double() for x in args), cfg=scfg.gicp)
        reg.append(((g_gpu.transform.cpu() - g_cpu.transform).abs().max().item(),
                    int(g_gpu.iterations), int(g_cpu.iterations),
                    (g_cpu.transform.double() - g_f64.transform).abs().max().item()))
    log("[gicp] 12x256 registration on identical inputs (frames 8-11, shifted "
        "0.36 m), max |T| diff CUDA vs CPU (iterations) and CPU float32 vs "
        "float64: " + ", ".join(f"{e:.2e} ({a}/{b}) and {f:.2e}" for e, a, b, f in reg))
    if max(e for e, _, _, _ in reg) > 5e-3:
        raise RuntimeError("[gicp] CUDA and CPU registrations disagree")
    return (launches, packs), state, out, track


def phase_knn(torch, state, out, track):
    import importlib

    from icp4dradar_tpu_torch.config import PipelineConfig
    from icp4dradar_tpu_torch.geom import matrix_to_rpy, se3_apply
    from icp4dradar_tpu_torch.mapping import voxel_map_sector_search

    nn = importlib.import_module("icp4dradar_tpu_torch.ops.knn")
    vm = PipelineConfig().voxel_map
    dev = track.xyz.device
    rng = np.random.default_rng(3)

    def both(name, src, tgt, mask):
        """The per-call search and coordinate search, and both on targets
        prepared once (K2, K3), against the all-rows plain version and the
        prepared plain versions: all equal."""
        ki, kd = nn.nearest_neighbor(src, tgt, mask)
        kd2, kq = nn.nearest_neighbor_with_coords(src, tgt, mask)
        ops = nn.nn_prepare(tgt, mask)
        si, sd = nn.nn_search(src, ops)
        cd, cq = nn.nn_search_coords(src, ops)
        torch.cuda.synchronize()
        pi, pd = nn.nearest_neighbor_plain(src, tgt, mask)
        qi, qd = nn.nn_search_plain(src, ops)
        pcd, pcq = nn.nn_search_coords_plain(src, ops)
        pq = tgt[pi.long()]
        packed = nn.nn_pack_plain(tgt, mask)
        eq = (torch.equal(ki, pi) and torch.equal(si, pi) and torch.equal(qi, pi),
              all(torch.equal(x, pd) for x in (kd, kd2, sd, qd, cd, pcd)),
              all(torch.equal(x, pq) for x in (kq, cq, pcq)),
              all(torch.equal(a, b) for a, b in zip((ops.rows, ops.orig, ops.count), packed)))
        log(f"[knn] {name}: indices equal {eq[0]}, d2 equal {eq[1]}, coordinates equal "
            f"{eq[2]} (K2 and K3, prepared and per call), packing equal {eq[3]}; max |d2| "
            f"diff {(sd - pd).abs().max().item():.3e}, K3 {(cd - pd).abs().max().item():.3e}")
        if not all(eq):
            raise RuntimeError(f"[knn] {name}: kernel and plain version differ")
        return ki, kd

    # the path shape: the last scan in the world frame at its tracked pose
    # against the sector submap of the final map
    pose = out.world_T[-1]
    heading = matrix_to_rpy(pose[:3, :3])[2]
    submap, submask, sub_n = voxel_map_sector_search(
        state.vmap, pose[:3, 3], vm.sector_radius, heading, vm.sector_half_angle_deg,
        vm.submap_max_points)
    src = se3_apply(pose, track.xyz[-1]).contiguous()
    submap, submask = submap.contiguous(), submask.contiguous()
    N, M, live = src.shape[0], submap.shape[0], int(sub_n.item())
    both(f"path {N} x {M} rows ({live} live)", src, submap, submask)

    # every row live: the live rows jittered over the whole table
    reps = -(-M // max(live, 1))
    full = torch.cat([submap[:live]] * reps)[:M]
    full = (full + torch.from_numpy(rng.normal(0, 0.3, (M, 3)).astype(np.float32))
            .to(dev)).contiguous()
    both(f"fully live {N} x {M}", src, full, torch.ones(M, device=dev))

    # ragged: 1000 sources against 5001 rows, 30% masked at random
    rs = torch.from_numpy(rng.uniform(-60, 60, (1000, 3)).astype(np.float32)).to(dev)
    rt = torch.from_numpy(rng.uniform(-60, 60, (5001, 3)).astype(np.float32)).to(dev)
    rm = torch.from_numpy((rng.uniform(size=5001) > 0.3).astype(np.float32)).to(dev)
    both("ragged 1000 x 5001 masked", rs, rt, rm)

    # exact ties: rows 3 and 9000 (different cluster ranks) at d2 = 5, the
    # first wins; rows 12000 and 15000 at d2 = 2 beat row 5's d2 = 9
    tt = torch.full((M, 3), 90.0, device=dev)
    for row, v in ((3, (1., 2., 0.)), (9000, (1., -2., 0.)), (5, (20., 3., 0.)),
                   (12000, (21., 0., 1.)), (15000, (19., 0., -1.))):
        tt[row] = torch.tensor(v, device=dev)
    ts_ = torch.tensor([[0.0, 0.0, 0.0], [20.0, 0.0, 0.0]], device=dev)
    ki, kd = both("exact ties", ts_, tt, torch.ones(M, device=dev))
    if ki.tolist() != [3, 12000] or kd.tolist() != [5.0, 2.0]:
        raise RuntimeError(f"[knn] exact ties: {ki.tolist()} {kd.tolist()}")
    big = torch.tensor(1e30, device=dev)
    ki, kd = both("all masked", src, submap, torch.zeros(M, device=dev))
    if bool((ki != 0).any()) or not bool((kd == big).all()):
        raise RuntimeError("[knn] all masked: expected index 0 and d2 1e30")
    # the fallback: one live row 2e15 m away, the rest masked; masked row 0
    # wins at 1e30 for every source
    far, fmask = submap.clone(), torch.zeros(M, device=dev)
    far[7] = torch.tensor([2e15, 0.0, 0.0], device=dev)
    fmask[7] = 1.0
    ki, kd = both("one live row 2e15 m away, the rest masked", src, far, fmask)
    if bool((ki != 0).any()) or not bool((kd == big).all()):
        raise RuntimeError("[knn] far live row: expected masked row 0 at d2 1e30")

    # K3's path: no pipeline calls it; it runs at the kNN-GICP path's
    # shape, once on targets prepared once and once per call, with the
    # counts set to 0 just before
    ops = nn.nn_prepare(submap, submask)
    nn.NN_COORDS_LAUNCHES = 0
    nn.nn_search_coords(src, ops)
    nn.nearest_neighbor_with_coords(src, submap, submask)
    torch.cuda.synchronize()
    coords_launches = nn.NN_COORDS_LAUNCHES
    if coords_launches != 2:
        raise RuntimeError(f"[knn] K3's path: {coords_launches} launches, expected 2")

    # time the path shape in turns; 20 calls per event window
    calls = 20
    lib = nn._lib()

    def many(fn):
        def run():
            for _ in range(calls):
                fn()
        return run

    prepared = many(lambda: nn.nn_search(src, ops))
    per_call = many(lambda: nn.nearest_neighbor(src, submap, submask))
    packing = many(lambda: nn.nn_prepare(submap, submask))
    packing_plain = many(lambda: nn.nn_pack_plain(submap, submask))
    coords_prepared = many(lambda: nn.nn_search_coords(src, ops))
    coords_per_call = many(lambda: nn.nearest_neighbor_with_coords(src, submap, submask))
    plain = many(lambda: nn.nn_search_plain(src, ops))
    plain_coords = many(lambda: nn.nn_search_coords_plain(src, ops))
    cdist = many(lambda: torch.cdist(src, submap[:live]).min(dim=1))

    # each search's one launch alone, on buffers made once
    bufs = (torch.empty(N, dtype=torch.float32, device=dev),
            torch.empty(N, dtype=torch.int32, device=dev),
            torch.empty((N, 3), dtype=torch.float32, device=dev))
    common = (src.data_ptr(), ops.rows.data_ptr(), ops.orig.data_ptr(), ops.count.data_ptr(),
              ops.tgt.data_ptr(), ops.mask.data_ptr(), 1, N, M, ops.cluster,
              bufs[0].data_ptr())
    stream = torch.cuda.current_stream().cuda_stream

    def launcher(*outs):
        def launch():
            rc = lib.nn_search_launch(*common, *outs, stream)
            if rc != 0:
                raise RuntimeError(f"[knn] launch failed: CUDA error {rc}")
        return many(launch)

    launch_only = launcher(bufs[1].data_ptr(), None)
    coords_launch_only = launcher(None, bufs[2].data_ptr())

    order = (plain, packing_plain, plain_coords, per_call, prepared, launch_only, packing,
             coords_prepared, coords_launch_only, coords_per_call,
             coords_per_call, coords_launch_only, coords_prepared,
             packing, launch_only, prepared, per_call, plain_coords, packing_plain, plain)
    (p1, b1, pc1, w1, k1, l1, a1, c1, cl1, cw1,
     cw2, cl2, c2, a2, l2, k2, w2, pc2, b2, p2) = (time_cuda(torch, f) / calls for f in order)
    cd = time_cuda(torch, cdist) / calls
    dev_ms = kernel_device_ms(torch, prepared, ("nn_search_kernel",))
    cdev_ms = kernel_device_ms(torch, coords_prepared, ("nn_search_kernel",))
    full_ops = nn.nn_prepare(full, torch.ones(M, device=dev))
    full_ms = kernel_device_ms(torch, lambda: nn.nn_search(src, full_ops), ("nn_search_kernel",))
    kernels = call_kernels(torch, lambda: nn.nn_search(src, ops))
    log(f"[knn] kernels of one prepared search (profiler): {fmt_kernels(kernels)}")
    check_one_kernel("knn", kernels, "nn_search_kernel")
    ckernels = call_kernels(torch, lambda: nn.nn_search_coords(src, ops))
    log(f"[knn] kernels of one prepared coordinate search, K3 (profiler): "
        f"{fmt_kernels(ckernels)}")
    check_one_kernel("knn", ckernels, "nn_search_kernel")
    pack_kernels = call_kernels(torch, lambda: nn.nn_prepare(submap, submask))
    log(f"[knn] kernels of one packing (profiler): {fmt_kernels(pack_kernels)}")
    check_one_kernel("knn", pack_kernels, "nn_pack_kernel")
    # bytes: sources, every target row and mask once, (index, d2) or (d2,
    # coordinates) out; work: the live rows this submap holds (masked rows
    # cannot win)
    from icp4dradar_tpu_torch.utils import roofline as rl

    bound_ms, bound_by = rl.nn_search_bound(N, M, [live]).bound()
    all_rows_ms, _ = rl.nn_search_bound(N, M, [M]).bound()
    cbound_ms, cbound_by = rl.nn_search_bound(N, M, [live], coords=True).bound()
    # the packing: tgt and mask read once, rows, orig and count written
    pbound_ms, pbound_by = rl.nn_pack_bound(M).bound()
    log(f"[knn] K2 at {N} x {M} rows ({live} live, a cluster of {ops.cluster}): the "
        f"call on prepared targets {k1:.4f} / {k2:.4f} ms, its one launch alone "
        f"{l1:.4f} / {l2:.4f} ms (device time {fmt_ms(dev_ms)} a search, profiler; "
        f"{fmt_ms(full_ms)} against {M} live rows), the per-call nearest_neighbor "
        f"{w1:.4f} / {w2:.4f} ms, plain (prepared) {p1:.4f} / {p2:.4f} ms; bound "
        f"{bound_ms:.5f} ms ({bound_by}, live rows; {all_rows_ms:.5f} ms over all {M} rows)")
    log(f"[knn] K3 at {N} x {M} rows ({live} live): the call on prepared targets "
        f"(nn_search_coords) {c1:.4f} / {c2:.4f} ms, its one launch alone {cl1:.4f} / "
        f"{cl2:.4f} ms (device time {fmt_ms(cdev_ms)} a search, profiler), the per-call "
        f"nearest_neighbor_with_coords {cw1:.4f} / {cw2:.4f} ms, plain (prepared) "
        f"{pc1:.4f} / {pc2:.4f} ms; bound {cbound_ms:.5f} ms ({cbound_by}, live rows)")
    log(f"[knn] packing at {M} rows: the call {a1:.4f} / {a2:.4f} ms (device time "
        f"{fmt_ms(kernel_device_ms(torch, packing, ('nn_pack_kernel',)))} a launch), plain "
        f"(a stable sort) {b1:.4f} / {b2:.4f} ms; bound {pbound_ms:.5f} ms ({pbound_by})")
    log(f"[knn] context, not a port path: torch.cdist(src, live rows).min(dim=1) "
        f"{cd:.4f} ms per call")
    return (dict(max_abs_err=0.0, ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2, bound_ms=bound_ms,
                 bound_by=bound_by, library_ms=None),
            coords_launches,
            dict(max_abs_err=0.0, ms=(c1 + c2) / 2, plain_ms=(pc1 + pc2) / 2,
                 bound_ms=cbound_ms, bound_by=cbound_by, library_ms=None),
            dict(max_abs_err=0.0, ms=(a1 + a2) / 2, plain_ms=(b1 + b2) / 2,
                 bound_ms=pbound_ms, bound_by=pbound_by, library_ms=None),
            (src, ops, submap, submask))


def phase_inner(torch, seq, scans):
    from icp4dradar_tpu_torch.config import PipelineConfig
    from icp4dradar_tpu_torch.models import scan_to_map
    from icp4dradar_tpu_torch.ops import vgicp_fused
    from icp4dradar_tpu_torch.utils import ate_rmse

    F = TRACK_FRAMES
    track = scans[:F]

    def reset():
        vgicp_fused.VGICP_SWEEP_LAUNCHES = 0
        vgicp_fused.VGICP_FROZEN_LAUNCHES = 0

    ates, res = [], None
    for inner in (0, 1):
        cfg = PipelineConfig().override(**{"gicp.inner_gn_steps": inner})

        def run():
            r = scan_to_map.run_scan_to_map(track, cfg, use_const_velocity_rot=True)
            torch.cuda.synchronize()
            return r

        (state, out), dt, peak = _timed_tracker(torch, f"inner {inner}", run, reset)
        sweeps, frozen = vgicp_fused.VGICP_SWEEP_LAUNCHES, vgicp_fused.VGICP_FROZEN_LAUNCHES
        its = out.iterations.cpu().numpy()
        _check_track(f"inner {inner}", torch, out, F)
        ate = ate_rmse(out.world_T.cpu().numpy()[:, :3, 3], seq.poses[:F, :3, 3],
                       align=False)
        ates.append(ate)
        log(f"[inner {inner}] {F} frames in {dt * 1e3:.2f} ms = {F / dt:.2f} scans/s; "
            f"peak device memory {peak:.2f} GiB; vgicp_sweep launches {sweeps}, "
            f"vgicp_frozen launches {frozen}, GN iterations {int(its.sum())} (per frame "
            f"mean {its.mean():.2f}, max {int(its.max())}); fitness max "
            f"{out.fitness.max().item():.4f}; ATE (align=False) {ate:.4f} m")
        if inner == 0:
            if sweeps != int(its.sum()) or frozen != 0:
                raise RuntimeError(f"[inner 0] launches {sweeps} / {frozen} != "
                                   f"{int(its.sum())} / 0")
            if not abs(ate - INNER0_ATE_EXPECTED) <= INNER0_ATE_BAND:
                raise RuntimeError(f"[inner 0] ATE {ate:.4f} m outside "
                                   f"{INNER0_ATE_EXPECTED} +- {INNER0_ATE_BAND} m")
        else:
            if frozen <= 0 or frozen != sweeps or int(its.sum()) != sweeps + frozen:
                raise RuntimeError(f"[inner 1] frozen launches {frozen}, sweeps {sweeps}, "
                                   f"GN iterations {int(its.sum())}")
            if not ate <= 1.5 * ates[0] + 0.005:
                raise RuntimeError(f"[inner 1] ATE {ate:.4f} m above 1.5 x {ates[0]:.4f} "
                                   f"+ 0.005 m")
            res = (frozen, state, out, track)
    return res


def phase_frozen(torch, state, out, track):
    from icp4dradar_tpu_torch.config import PipelineConfig
    from icp4dradar_tpu_torch.geom import matrix_to_rpy, se3_exp
    from icp4dradar_tpu_torch.mapping import voxel_map_sector_search_with_stats
    from icp4dradar_tpu_torch.ops import vgicp_fused as vf
    from icp4dradar_tpu_torch.ops.vgicp_fused import (
        radar_point_covariances_packed, vgicp_iteration, vgicp_iteration_batch,
        vgicp_iteration_frozen, vgicp_iteration_frozen_plain,
    )

    cfg = PipelineConfig()
    vm, g = cfg.voxel_map, cfg.gicp
    dev = track.xyz.device
    rng = np.random.default_rng(4)
    kw = dict(max_correspondence_dist=g.max_correspondence_dist, cov_eps=g.cov_epsilon)
    names = ("H", "g", "cost", "wsum", "d2sum")
    max_err = 0.0

    def both(name, T, src, sm, scov, best, groups=1):
        nonlocal max_err
        k = vgicp_iteration_frozen(T, src, sm, scov, best, _acc_groups=groups, **kw)
        torch.cuda.synchronize()
        p = vgicp_iteration_frozen_plain(T, src, sm, scov, best, _acc_groups=groups, **kw)
        errs = []
        for n, a, b in zip(names, k, p):
            a, b = a.double().cpu(), b.double().cpu()
            if not (bool(torch.isfinite(a).all()) and bool(torch.isfinite(b).all())):
                raise RuntimeError(f"[frozen] {name}: non-finite {n}")
            bad = (a - b).abs() > VG_ATOL + VG_RTOL * b.abs()
            errs.append((n, (a - b).abs().max().item(), int(bad.sum())))
        log(f"[frozen] {name}: " + "; ".join(f"{n} abs {e:.3e}" for n, e, _ in errs))
        if any(nb for _, _, nb in errs):
            raise RuntimeError(f"[frozen] {name}: beyond rtol {VG_RTOL} / atol {VG_ATOL}")
        max_err = max(max_err, max(e for _, e, _ in errs))
        return k

    # the last 8 frames at their tracked poses against the final map's
    # sector submap, centred as vgicp_align centres it
    B = 8
    pose0 = out.world_T[-1]
    heading = matrix_to_rpy(pose0[:3, :3])[2]
    _, submask, sub_n, sub_mean, sub_cov = voxel_map_sector_search_with_stats(
        state.vmap, pose0[:3, 3], vm.sector_radius, heading, vm.sector_half_angle_deg,
        vm.submap_max_points, min_count=vm.stats_min_count, fallback_var=vm.stats_fallback_var)
    T = out.world_T[-B:].clone()
    center = T[-1, :3, 3].clone()
    T[:, :3, 3] -= center
    tgt = (sub_mean - center).contiguous()
    src, sm = track.xyz[-B:].contiguous(), track.mask[-B:].contiguous()
    scov = radar_point_covariances_packed(src, g.sigma_range, g.sigma_azimuth,
                                          g.sigma_elevation).contiguous()
    N = src.shape[1]

    def perturbed(Tb, scale):
        xi = rng.normal(0.0, [scale, scale, scale / 5, scale / 20, scale / 20, scale / 10],
                        (Tb.shape[0], 6)).astype(np.float32)
        return (se3_exp(torch.from_numpy(xi).to(dev)) @ Tb).contiguous()

    best1 = vgicp_iteration(T[-1], src[-1], sm[-1], scov[-1], tgt, sub_cov, submask,
                            tgt_count=sub_n, return_best=True, **kw)[5]
    for scale in (0.01, 0.1):
        both(f"one frame {N} points, step {scale} m", perturbed(T[-1:], scale)[0],
             src[-1], sm[-1], scov[-1], best1)
    bestB = vgicp_iteration_batch(T, src, sm, scov, tgt, sub_cov, submask, tgt_count=sub_n,
                                  return_best=True, **kw)[5]
    flat = (src.reshape(-1, 3), sm.reshape(-1), scov.reshape(-1, 6))
    TB = perturbed(T, 0.05)
    both(f"B={B} x {N} in per-frame groups", TB, *flat, bestB, groups=B)
    both(f"B={B} x {N} summed into one group", TB, *flat, bestB)
    marked = bestB.clone()
    marked[::3, 0, :] = 1e30                  # every third frame never matched
    k = both(f"B={B}, frames 0, 3, 6 never matched", TB, *flat, marked, groups=B)
    if float(k[3][::3].abs().sum()) != 0.0:
        raise RuntimeError("[frozen] never-matched rows carried weight")
    k1 = both(f"B={B}, frames 0, 3, 6 never matched, one group", TB, *flat, marked)
    if float(k1[3]) != float(k[3].sum()):
        raise RuntimeError("[frozen] one group's weight differs from the per-frame sum")
    empty = vgicp_iteration(T[-1], src[-1], sm[-1], scov[-1], tgt, sub_cov,
                            torch.zeros_like(submask), tgt_count=torch.tensor(0, device=dev),
                            return_best=True, **kw)[5]
    k = both("empty payload (a sweep against an empty submap)", T[-1], src[-1], sm[-1],
             scov[-1], empty)
    if float(k[3].abs().sum()) != 0.0:
        raise RuntimeError("[frozen] empty payload matched something")

    calls = 20
    T1 = perturbed(T[-1:], 0.01)[0]
    ops = vf.vgicp_prepare(src[-1], sm[-1], scov[-1], ts=best1.shape[2])
    # two launches on the same inputs: the same bits (fixed-order sums)
    a, b = vf.vgicp_frozen(T1, ops, best1, **kw), vf.vgicp_frozen(T1, ops, best1, **kw)
    opsB = vf.vgicp_prepare(src, sm, scov, ts=bestB.shape[2])
    aB, bB = (vf.vgicp_frozen(TB, opsB, bestB, _acc_groups=B, **kw) for _ in range(2))
    if not all(torch.equal(x, y) for x, y in zip(a + aB, b + bB)):
        raise RuntimeError("[frozen] two launches on the same inputs differ")
    log("[frozen] two launches on the same inputs: bit-identical (one frame, and B=8 "
        "in per-frame groups)")
    lib = vf._lib()
    part = torch.empty((1, vf.NUM_FROZEN_OUT), dtype=torch.float32, device=dev)
    gate, eps = vf.sweep_gate(g.max_correspondence_dist), float(np.float32(g.cov_epsilon))
    launch_args = (T1.data_ptr(), ops.src.data_ptr(), best1.data_ptr(), 1, 1, ops.per_frame,
                   ops.ts, gate, eps, part.data_ptr(), torch.cuda.current_stream().cuda_stream)

    def kernel():
        for _ in range(calls):
            vgicp_iteration_frozen(T1, src[-1], sm[-1], scov[-1], best1, **kw)

    def plain():
        for _ in range(calls):
            vgicp_iteration_frozen_plain(T1, src[-1], sm[-1], scov[-1], best1, **kw)

    def prepared():
        for _ in range(calls):
            vf.vgicp_frozen(T1, ops, best1, **kw)

    def launch_only():
        for _ in range(calls):
            rc = lib.vgicp_frozen_launch(*launch_args)
            if rc != 0:
                raise RuntimeError(f"[frozen] launch failed: CUDA error {rc}")

    p1, k1, c1, l1, l2, c2, k2, p2 = (
        time_cuda(torch, f) / calls for f in
        (plain, kernel, prepared, launch_only, launch_only, prepared, kernel, plain))
    dev_ms = kernel_device_ms(torch, prepared, ("vgicp_frozen_kernel",))
    kernels = call_kernels(torch, lambda: vf.vgicp_frozen(T1, ops, best1, **kw))
    log(f"[frozen] kernels of one call on prepared sources (profiler): "
        f"{fmt_kernels(kernels)}")
    check_one_kernel("frozen", kernels, "vgicp_frozen_kernel")
    # inputs read once: T, the sources (xyz, mask, cov6) and the (10, N)
    # payload; 45 finished values out
    from icp4dradar_tpu_torch.utils import roofline as rl

    assert vf.NUM_FROZEN_OUT == rl.FROZEN_OUT
    bound_ms, bound_by = rl.vgicp_frozen_bound(N).bound()
    log(f"[frozen] time at one frame of {N} points: the call on prepared sources "
        f"{c1:.4f} / {c2:.4f} ms, the launch alone {l1:.4f} / {l2:.4f} ms (device time "
        f"{fmt_ms(dev_ms)} a launch, profiler), the per-call "
        f"wrapper (packing included) {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms; "
        f"bound {bound_ms:.6f} ms ({bound_by})")
    return dict(max_abs_err=max_err, ms=(c1 + c2) / 2, plain_ms=(p1 + p2) / 2,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None), (T1, ops, best1)


def count_syncs(torch, fn, calls=20):
    """Host synchronisations per call of fn, from a torch.profiler trace:
    (stream / device / event synchronise calls, host-to-device copies), less
    those of an empty window (the profiler's own)."""
    from torch.profiler import ProfilerActivity, profile

    def window(n):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
        names = [e.name for e in prof.events()]
        return (sum("Synchronize" in n for n in names),
                sum(n.startswith("Memcpy HtoD") or n == "cudaMemcpy" for n in names))

    fn()
    torch.cuda.synchronize()
    base, full = window(0), window(calls)
    return tuple((f - b) / calls for f, b in zip(full, base))


def phase_syncs(torch, sweep, frozen, search):
    """K4, K5, K2 and K3 calls on prepared operands copy nothing from the
    host and never wait for the device; the per-call K4 wrapper is measured
    beside."""
    import importlib

    from icp4dradar_tpu_torch.config import PipelineConfig
    from icp4dradar_tpu_torch.ops import vgicp_fused as vf

    nn = importlib.import_module("icp4dradar_tpu_torch.ops.knn")

    g = PipelineConfig().gicp
    kw = dict(max_correspondence_dist=g.max_correspondence_dist, cov_eps=g.cov_epsilon)
    Tc, ops, bench, sub_n, axis2 = sweep
    T1, fops, best1 = frozen
    nsrc, nops, ntgt, nmask = search
    B = Tc.shape[0]
    res = {
        "K2 call on prepared operands": count_syncs(torch, lambda: nn.nn_search(nsrc, nops)),
        "K3 call on prepared operands": count_syncs(
            torch, lambda: nn.nn_search_coords(nsrc, nops)),
        "K2 packing": count_syncs(torch, lambda: nn.nn_prepare(ntgt, nmask)),
        "K4 call on prepared operands": count_syncs(
            torch, lambda: vf.vgicp_sweep(Tc, ops, _acc_groups=B, **kw)),
        "K4 call with the payload": count_syncs(
            torch, lambda: vf.vgicp_sweep(Tc, ops, return_best=True, _acc_groups=B, **kw)),
        "K5 call on prepared sources": count_syncs(
            torch, lambda: vf.vgicp_frozen(T1, fops, best1, **kw)),
        "K4 per-call wrapper": count_syncs(
            torch, lambda: vf.vgicp_iteration_batch(*bench, tgt_count=sub_n,
                                                    gate_axis=axis2, **kw)),
    }
    log("[profile] host syncs per call (synchronise calls, host-to-device copies): " +
        "; ".join(f"{k} {a:.2f}, {c:.2f}" for k, (a, c) in res.items()))
    for k, (a, c) in list(res.items())[:-1]:
        if a or c:
            raise RuntimeError(f"[profile] {k}: {a} synchronise calls and {c} host-to-device "
                               f"copies per call, expected none")


def profile_run(torch, name, n_walls, fn, expect=None, ranges=()):
    """One profiled run of fn after `n_walls` unprofiled ones: device kernel
    time and launches from torch.profiler, the idle share against the
    median unprofiled run, the top kernels; with `expect` = (kernels it
    must launch, kernels it must not), every kernel it launched. `ranges`
    names the record_function ranges fn opens: the profiler also lists
    them on the device's timeline, and they are no kernels. Returns the
    profile (None when the profiler saw no device time) and the
    launches."""
    from torch.profiler import ProfilerActivity, profile

    walls = []
    for _ in range(n_walls):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    # the host ops are recorded only where a range must be found among them:
    # summing their events costs the profiler ~0.1 ms each (a minute for a
    # run of ~100,000 launches), and the device's activity alone gives the
    # kernels' time and count
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if ranges else [])
    with profile(activities=acts, record_shapes=bool(ranges)) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
    cuda_type = torch.autograd.DeviceType.CUDA
    kern = [e for e in prof.key_averages()
            if e.device_type == cuda_type and e.key not in ranges]
    busy = sum(e.self_device_time_total for e in kern) / 1e3     # ms
    launches = sum(e.count for e in kern)
    if busy <= 0.0:
        log(f"[profile] {name}: the profiler saw no device time (not measured)")
        return None, launches
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:6]
    log(f"[profile] {name}: run {wall * 1e3:.2f} ms unprofiled (median of {n_walls}), "
        f"{pwall * 1e3:.2f} ms profiled; device kernel time {busy:.2f} ms in "
        f"{launches} kernel launches; idle share {max(0.0, 1 - busy / (wall * 1e3)):.3f}")
    for e in top:
        log(f"[profile] {name}:   {e.self_device_time_total / 1e3:9.3f} ms "
            f"x{e.count:<6d} {e.key[:90]}")
    if expect is not None:
        counts = {}
        for e in kern:
            k = kernel_name(e.key)
            counts[k] = counts.get(k, 0) + e.count
        log(f"[profile] {name}: kernels launched: " + ", ".join(
            f"{k} x{n}" for k, n in sorted(counts.items(), key=lambda kv: -kv[1])))
        need, banned = expect
        if not need <= set(counts) or banned & set(counts):
            raise RuntimeError(f"[profile] {name}: expected {sorted(need)} and none of "
                               f"{sorted(banned)} among the kernels launched")
    return prof, launches


def range_device(torch, prof, name):
    """(device ms, kernel launches) of the kernels launched inside the
    record_function ranges called `name`, and the widest row (columns) of
    the aten::sort calls inside them (2-D, or with a stream axis)."""
    def kernels(e):
        return len(e.kernels) + sum(kernels(c) for c in e.cpu_children)

    def inside(e):
        while e is not None:
            if e.name == name:
                return True
            e = e.cpu_parent
        return False

    events = prof.events()
    cpu = torch.autograd.DeviceType.CPU
    ranges = [e for e in events if e.name == name and e.device_type == cpu]
    widest = max((e.input_shapes[0][-1] for e in events
                  if e.name == "aten::sort" and e.input_shapes and len(e.input_shapes[0]) >= 2
                  and inside(e)), default=0)
    return (sum(e.device_time_total for e in ranges) / 1e3,
            sum(kernels(e) for e in ranges), widest)


def phase_profile(torch, scans, s2m, track, batch):
    """One profiled run of the s2s, s2m and inner-step trackers
    (`profile_run`; the kNN-GICP tracker's is in phase 7): three unprofiled
    runs for the idle share, one for the inner-step run, the longest. The
    inner-step run lists every kernel it launched: K5's step is one
    vgicp_frozen_kernel."""
    from icp4dradar_tpu_torch.config import PipelineConfig
    from icp4dradar_tpu_torch.models import (
        run_scan_to_map, run_scan_to_map_batch, run_scan_to_map_blocked, run_scan_to_scan,
    )

    cfg = PipelineConfig()
    inner_cfg = cfg.override(**{"gicp.inner_gn_steps": 1})
    profile_run(torch, "s2s", 3, lambda: run_scan_to_scan(scans, cfg, use_doppler_prior=True))
    _, s2m_launches = profile_run(torch, "s2m", 3, lambda: run_scan_to_map_blocked(
        s2m, cfg, block=S2M_BLOCK, use_const_velocity_rot=True))
    _, batch_launches = profile_run(torch, "batch", 3, lambda: run_scan_to_map_batch(
        batch["batch"], cfg, uniforms=batch["uniforms"], block=S2M_BLOCK,
        use_const_velocity_rot=True))
    ratio = batch_launches / max(s2m_launches, 1)
    log(f"[profile] batch of {BATCH_STREAMS} streams: {batch_launches} kernel launches against "
        f"the single-stream s2m run's {s2m_launches}, ratio {ratio:.3f} (at most "
        f"{BATCH_LAUNCH_RATIO_MAX}: nothing loops over the streams)")
    if not ratio < BATCH_LAUNCH_RATIO_MAX:
        raise RuntimeError(f"[profile] the batch launches {ratio:.3f} x the single stream's")
    profile_run(torch, "inner", 1, lambda: run_scan_to_map(
        track, inner_cfg, use_const_velocity_rot=True),
        expect=({"vgicp_sweep_kernel", "vgicp_frozen_kernel"}, set()))


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _same_messages(a, b):
    """Raises unless two read_messages lists hold the same topics, stamps
    and arrays."""
    if [(t, bt) for t, _, bt in a] != [(t, bt) for t, _, bt in b]:
        raise RuntimeError("[host] the readers give different topics or stamps")
    for (_, x, _), (_, y, _) in zip(a, b):
        xs = x.columns if hasattr(x, "columns") else vars(x)
        ys = y.columns if hasattr(y, "columns") else vars(y)
        if list(xs) != list(ys) or not all(np.array_equal(xs[k], ys[k]) for k in xs):
            raise RuntimeError("[host] the native and Python readers give different arrays")


def phase_host(torch, scans, s2s_out):
    """The host side on the card (phase 13): the s2m cell's 256 x 2048
    frames as a ROS1 bag, read back through the native streamer and the
    Python walk, IMU priors into the blocked tracker on K4 (JAX's draws),
    the CLI's bag run, the replay of phase 4's track, PCD and the native
    .bin loader. Returns the K4 and K1 launches of its library runs."""
    import contextlib
    import io as pyio
    import shutil

    from icp4dradar_tpu_torch.config import PipelineConfig
    from icp4dradar_tpu_torch.io import (
        BinSequenceDataset, RadarBagDataset, RosbagReader, SyntheticSequence, lz4f,
        write_pcd, write_radar_bin, write_synthetic_bag,
    )
    from icp4dradar_tpu_torch.models import run_odometry, run_scan_to_scan_replay, scan_to_map
    from icp4dradar_tpu_torch.ops import icp_fused, vgicp_fused
    from icp4dradar_tpu_torch.preprocess import imu_prior_deltas, reve_hypotheses
    from icp4dradar_tpu_torch.utils import (
        ate_rmse, read_result_csv, reve_uniforms, write_result_csv,
    )

    t_phase = time.perf_counter()
    cfg = PipelineConfig()
    dev = scans.device
    F, B = S2M_FRAMES, S2M_BLOCK
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_host")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)

    # ---- the bag: written, then read by the native streamer and in Python ----
    seq = SyntheticSequence(num_frames=F, max_points=BENCH_POINTS, num_landmarks=5000,
                            world_extent=120.0, max_range=80.0, dynamic_fraction=0.1,
                            speed=1.0, turn_rate=0.02, seed=0)
    bag = os.path.join(work, "bench.bag")
    t0 = time.perf_counter()
    write_synthetic_bag(bag, seq)
    mb = os.path.getsize(bag) / 1e6
    log(f"[host] bag of {F} x {BENCH_POINTS} (ColoRadar fields, /gt, /imu, no compression): "
        f"{mb:.2f} MB written in {time.perf_counter() - t0:.3f} s")
    # both walks on the same bag written with each chunk compression,
    # interleaved, BAG_READS times each
    for comp in ("none", "bz2", "lz4"):
        if comp == "lz4" and not lz4f.available():
            log("[host] liblz4 does not load: no lz4 bag")
            continue
        path = bag if comp == "none" else os.path.join(work, f"bench_{comp}.bag")
        if comp != "none":
            t0 = time.perf_counter()
            write_synthetic_bag(path, seq, compression=comp)
            log(f"[host] the same bag with {comp} chunks: {os.path.getsize(path) / 1e6:.2f} MB "
                f"written in {time.perf_counter() - t0:.3f} s")
        secs, msgs, used = {True: [], False: []}, {}, False
        for _ in range(BAG_READS):
            for use_native in (True, False):
                reader = RosbagReader(path, use_native=use_native)
                t0 = time.perf_counter()
                msgs[use_native] = list(reader.read_messages())
                secs[use_native].append(time.perf_counter() - t0)
                used |= reader.native_used
        size = os.path.getsize(path) / 1e6
        n_s, p_s = statistics.median(secs[True]), statistics.median(secs[False])
        log(f"[host] read {comp} bag ({len(msgs[True])} messages, {size:.2f} MB), median of "
            f"{BAG_READS}: native {n_s:.4f} s = {size / n_s:.1f} MB/s, Python {p_s:.4f} s = "
            f"{size / p_s:.1f} MB/s (native {p_s / n_s:.2f} x; native "
            f"{', '.join(f'{x:.4f}' for x in secs[True])}, Python "
            f"{', '.join(f'{x:.4f}' for x in secs[False])})")
        if not used or len(msgs[True]) != 3 * F:
            raise RuntimeError(f"[host] {comp} bag: native_used {used}, "
                               f"{len(msgs[True])} messages")
        _same_messages(msgs[True], msgs[False])

    # ---- RadarBagDataset -> IMU priors -> the blocked tracker on K4 ----
    t0 = time.perf_counter()
    ds = RadarBagDataset(bag, "/radar", "/gt", "/imu", max_points=BENCH_POINTS, use_native=True)
    bag_scans = ds.stacked_scans(dev)
    _sync(torch, dev)
    load_s = time.perf_counter() - t0
    priors = torch.from_numpy(imu_prior_deltas(ds.frames)).to(dev)
    log(f"[host] RadarBagDataset {len(ds)} frames loaded and on the card in {load_s:.3f} s "
        f"(native_used {ds.native_used})")
    if not ds.native_used or len(ds) != F:
        raise RuntimeError("[host] the dataset did not read the bag natively")
    # the bag holds the bench sequence's points; its last frame's Doppler
    # differs (a sequence's last frame takes the velocity of the frame pair
    # before it)
    for f in ("xyz", "doppler", "intensity", "mask"):
        k = F - 1 if f == "doppler" else F
        if not torch.equal(getattr(bag_scans, f)[:k], getattr(scans, f)[:k]):
            raise RuntimeError(f"[host] the bag's {f} differs from the sequence's")
    # the JAX package's draws (its run's key(cfg.seed)), as the reference run's
    u = torch.from_numpy(reve_uniforms(cfg.seed, F, B, reve_hypotheses(cfg.reve))).to(dev)
    runs = {}
    for name, pd in (("prior", priors), ("no prior", None)):
        scan_to_map.SEQUENTIAL_FALLBACK_BLOCKS = 0
        vgicp_fused.VGICP_SWEEP_LAUNCHES = 0
        _sync(torch, dev)
        t0 = time.perf_counter()
        _, out = scan_to_map.run_scan_to_map_blocked(
            bag_scans, cfg, uniforms=u, block=B, use_const_velocity_rot=True, prior_deltas=pd)
        _sync(torch, dev)
        dt = time.perf_counter() - t0
        its = out.iterations.cpu().numpy()
        lost = int((out.fitness >= LOST_FITNESS).sum().item())
        ate = ate_rmse(out.world_T.cpu().numpy()[:, :3, 3], seq.poses[:, :3, 3], align=False)
        runs[name] = (vgicp_fused.VGICP_SWEEP_LAUNCHES, ate, out.world_T, its)
        log(f"[host] bag path, {name}: {F / dt:.1f} scans/s ({dt * 1e3:.2f} ms), GN sweeps "
            f"per frame {its.mean():.3f}, vgicp_sweep launches {runs[name][0]}, fallback "
            f"blocks {scan_to_map.SEQUENTIAL_FALLBACK_BLOCKS}, lost {lost}, ATE (align=False) "
            f"{ate:.5f} m")
        if runs[name][0] <= 0 or lost or not bool(torch.isfinite(out.world_T).all()):
            raise RuntimeError(f"[host] bag path, {name}: no K4 launch, a lost frame or a "
                               f"non-finite pose")
    moved = (runs["prior"][2] - runs["no prior"][2]).abs().max().item()
    log(f"[host] the prior moves the track by up to {moved:.4f} m; GN sweeps differ on "
        f"{int((runs['prior'][3] != runs['no prior'][3]).sum())} of {F} frames")
    if not moved > 0 or np.array_equal(runs["prior"][3], runs["no prior"][3]):
        raise RuntimeError("[host] the run with IMU priors tracks as the run without them")
    if not abs(runs["prior"][1] - BAG_ATE_JAX) <= BAG_ATE_BAND:
        raise RuntimeError(f"[host] bag path ATE {runs['prior'][1]:.5f} m outside the JAX CPU "
                           f"run's {BAG_ATE_JAX} +- {BAG_ATE_BAND} m")

    # ---- the same path through the CLI ----
    out_dir = os.path.join(work, "cli")
    buf = pyio.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = run_odometry.main([
            "--bag", bag, "--topic-radar", "/radar", "--topic-gt", "/gt", "--topic-imu", "/imu",
            "--imu-prior", "--mode", "scan_to_map", "--map-interval", str(B), "--cv-rot",
            "--viz", "--steady-state", "--device", dev.type, "--max-points", str(BENCH_POINTS),
            "--out", out_dir])
    rec = json.loads(buf.getvalue().strip().splitlines()[-1])
    files = sorted(os.listdir(out_dir))
    log(f"[host] CLI --bag --imu-prior --viz --steady-state: rc {rc}, files {files}, record "
        f"{json.dumps(rec)}")
    want = ["map.ply", "metrics.jsonl", "odom_tum.txt", "pcl_info.txt", "radar_odometry.txt",
            "velocity.txt", "viewer.html"]
    steady = {"steady_s", "steady_scans_per_sec", "compile_overhead_s"}
    if rc != 0 or files != want or not steady <= set(rec) or rec["frames"] != F:
        raise RuntimeError("[host] the CLI's bag run did not write its files or its record")
    # the CLI draws from a seeded torch.Generator, the library run JAX's
    # draws; its record's ATE is aligned, so read its poses back
    cli_poses = np.loadtxt(os.path.join(out_dir, "radar_odometry.txt")).reshape(-1, 3, 4)
    cli_ate = ate_rmse(cli_poses[:, :, 3], seq.poses[:, :3, 3], align=False)
    log(f"[host] the CLI's track: ATE (align=False) {cli_ate:.5f} m")
    # a CLI that dropped --imu-prior would track as the run without priors
    if not (abs(cli_ate - runs["prior"][1]) <= BAG_ATE_BAND
            and abs(cli_ate - runs["prior"][1]) < abs(cli_ate - runs["no prior"][1])):
        raise RuntimeError(f"[host] the CLI's ATE {cli_ate:.5f} m is not within "
                           f"{BAG_ATE_BAND} m of the library run's with priors, or is nearer "
                           f"the run's without them")

    # ---- the replay of phase 4's track ----
    csv = os.path.join(work, "output_result.csv")
    write_result_csv(csv, s2s_out.icp_transform.cpu().numpy(), s2s_out.fitness.cpu().numpy(),
                     s2s_out.sine_A.cpu().numpy(), s2s_out.sine_b.cpu().numpy())
    _, T_rec, scores, _, _ = read_result_csv(csv)
    T_csv = torch.from_numpy(T_rec).float().to(dev)
    icp_fused.ICP_MOMENTS_LAUNCHES = 0
    rep = run_scan_to_scan_replay(scans, T_csv, cfg, recorded_fitness=scores)
    exact = run_scan_to_scan_replay(scans, s2s_out.icp_transform, cfg)
    replay_k1 = icp_fused.ICP_MOMENTS_LAUNCHES
    _sync(torch, dev)
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        run_scan_to_scan_replay(scans, T_csv, cfg, recorded_fitness=scores)
        _sync(torch, dev)
        times.append((time.perf_counter() - t0) * 1e3)
    from icp4dradar_tpu_torch.models.scan_to_scan import _prefix_products

    chain_cpu = _prefix_products(T_csv.cpu())
    d_cpu = (rep.world_T.cpu() - chain_cpu).abs().max().item()
    d_csv = (rep.world_T - s2s_out.world_T).abs().max().item()
    same_vel = torch.equal(rep.velocity, s2s_out.velocity)
    same_exact = torch.equal(exact.world_T, s2s_out.world_T)
    log(f"[host] replay of phase 4's {scans.xyz.shape[0]} x {scans.xyz.shape[1]} track: "
        f"{statistics.median(times):.2f} ms median of 5 ({', '.join(f'{t:.2f}' for t in times)}); "
        f"icp_moments launches {replay_k1}; velocity bit for bit {same_vel}; in-memory "
        f"transforms: world_T bit for bit {same_exact}; through the CSV: max |world_T| diff "
        f"{d_cpu:.3e} from the CPU prefix product of the file, {d_csv:.3e} from phase 4's "
        f"(the file's six decimals)")
    if (replay_k1 != 0 or not same_vel or not same_exact or d_cpu > REPLAY_CPU_TOL
            or d_csv > REPLAY_CSV_TOL):
        raise RuntimeError("[host] the replay does not reproduce phase 4's track")

    # ---- PCD through the CLI's sniff, and the native .bin loader ----
    pcd_dir, bin_dir = os.path.join(work, "pcd_seq"), os.path.join(work, "bin_seq")
    for k in range(PCD_FRAMES):
        rec5 = scans[k].to_numpy_valid()
        write_pcd(os.path.join(pcd_dir, "pcd", f"{k:05d}.pcd"), {
            "x": rec5[:, 0], "y": rec5[:, 1], "z": rec5[:, 2], "intensity": rec5[:, 3],
            "doppler": rec5[:, 4]})
        write_radar_bin(os.path.join(bin_dir, "data", f"radar_pointcloud_{k}.bin"), rec5)
    buf = pyio.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = run_odometry.main(["--mode", "scan_to_scan", "--dataset", pcd_dir, "--doppler-prior",
                                "--max-points", str(BENCH_POINTS), "--device", dev.type,
                                "--out", os.path.join(work, "pcd_out")])
    rec = json.loads(buf.getvalue().strip().splitlines()[-1])
    tum = np.loadtxt(os.path.join(work, "pcd_out", "odom_tum.txt"))
    counts = np.loadtxt(os.path.join(work, "pcd_out", "pcl_info.txt"))
    ok_pcd = (rc == 0 and rec["frames"] == PCD_FRAMES and np.isfinite(tum).all()
              and counts.tolist() == scans.mask[:PCD_FRAMES].sum(dim=-1).cpu().tolist())
    native = BinSequenceDataset(bin_dir, max_points=BENCH_POINTS)
    plain = BinSequenceDataset(bin_dir, max_points=BENCH_POINTS, use_native=False)
    t0 = time.perf_counter()
    nat = [native[k] for k in range(PCD_FRAMES)]
    nat_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    npy = [plain[k] for k in range(PCD_FRAMES)]
    npy_s = time.perf_counter() - t0
    ok_bin = native.native_used and all(
        torch.equal(getattr(a, f), getattr(b, f))
        and torch.equal(getattr(a, f).to(dev), getattr(scans[k], f))
        for k, (a, b) in enumerate(zip(nat, npy)) for f in ("xyz", "doppler", "intensity", "mask"))
    log(f"[host] PCD sniff: {PCD_FRAMES} frames through the CLI's PCD reader on the card, rc "
        f"{rc}, point counts equal, poses finite: {ok_pcd}; native .bin loader equal to the "
        f"numpy reads and the sequence: {ok_bin} ({PCD_FRAMES} frames in {nat_s:.3f} s against "
        f"{npy_s:.3f} s)")
    if not (ok_pcd and ok_bin):
        raise RuntimeError("[host] the PCD run or the native .bin loader failed")
    secs = time.perf_counter() - t_phase
    log(f"[host] phase seconds {secs:.1f} (budget {HOST_BUDGET_S} s)")
    if secs > HOST_BUDGET_S:
        FAILED.append(f"[host] the phase took {secs:.1f} s, over its {HOST_BUDGET_S} s")
    return {"bag_launches": runs["prior"][0]}, {"replay_launches": replay_k1}


KNN_BATCH_FRAMES = 16
# the NCCL world-1 phase: the pose graph's and the batch's results against
# their single-device runs (the distributed sums add the loop closures'
# and the single-pose factors' blocks in another order)
PAR_POSE_TOL = 1e-4
PAR_COLLECTIVE_REPS = 20


def phase_knn_batch(torch, seq, scans):
    """Phase 14: kNN GICP inside a batch at full width: 4 streams x 16
    frames x 2048 points (stream b the frames [256 b, 256 b + 16) of the
    bench sequence) through the per-frame run_scan_to_map_batch with
    gicp.use_vgicp=False on the JAX package's draws, K2's and the
    packing's counts set to 0 just before; each stream against its
    single-stream run (bit for bit), the launches against the sum of the
    4 single-stream runs'; K2 and its packing with the stream axis against
    their plain versions and against 4 single-target calls on the batch's
    own packed targets (the last frame's sector submaps)."""
    import importlib

    from icp4dradar_tpu_torch.config import PipelineConfig
    from icp4dradar_tpu_torch.geom import matrix_to_rpy, se3_apply
    from icp4dradar_tpu_torch.mapping import voxel_map_sector_search
    from icp4dradar_tpu_torch.models import scan_to_map
    from icp4dradar_tpu_torch.preprocess import reve_hypotheses
    from icp4dradar_tpu_torch.utils import reve_batch_uniforms

    nn = importlib.import_module("icp4dradar_tpu_torch.ops.knn")
    cfg = PipelineConfig().override(**{"gicp.use_vgicp": False})
    Bs, F = BATCH_STREAMS, KNN_BATCH_FRAMES
    idx = torch.cat([torch.arange(b * S2M_FRAMES, b * S2M_FRAMES + F) for b in range(Bs)])
    batch = scans[idx.to(scans.xyz.device)]
    batch = type(batch)(**{k: getattr(batch, k).reshape((Bs, F) + getattr(batch, k).shape[1:])
                           for k in ("xyz", "doppler", "intensity", "mask", "time")})
    U = torch.from_numpy(reve_batch_uniforms(cfg.seed, Bs, F, 0, reve_hypotheses(cfg.reve))
                         ).to(scans.xyz.device)

    def reset():
        torch.cuda.synchronize()
        nn.NN_SEARCH_LAUNCHES = 0
        nn.NN_PACK_LAUNCHES = 0

    def run_batch():
        res = scan_to_map.run_scan_to_map_batch(batch, cfg, uniforms=U,
                                                use_const_velocity_rot=True)
        torch.cuda.synchronize()
        return res

    def run_one(b):
        res = scan_to_map.run_scan_to_map(batch[b], cfg, uniforms=U[b],
                                          use_const_velocity_rot=True)
        torch.cuda.synchronize()
        return res

    run_batch()                                        # warm-up
    reset()
    t0 = time.perf_counter()
    state, out = run_batch()
    dt_batch = time.perf_counter() - t0
    launches, packs = nn.NN_SEARCH_LAUNCHES, nn.NN_PACK_LAUNCHES
    its = out.iterations.cpu().numpy()                 # (Bs, F)
    singles, dt_one, one_launches, one_packs = [], 0.0, 0, 0
    for b in range(Bs):
        reset()
        t0 = time.perf_counter()
        singles.append(run_one(b))
        dt_one += time.perf_counter() - t0
        one_launches += nn.NN_SEARCH_LAUNCHES
        one_packs += nn.NN_PACK_LAUNCHES
    expected = int(its.max(axis=0).sum()) + F
    log(f"[knn batch] {Bs} streams x {F} frames x {scans.xyz.shape[1]} points, kNN GICP "
        f"(per-frame batch): {dt_batch * 1e3:.2f} ms = {Bs * F / dt_batch:.1f} aggregate "
        f"scans/s; the {Bs} single-stream runs {dt_one * 1e3:.2f} ms = "
        f"{Bs * F / dt_one:.1f} scans/s; ratio {dt_one / dt_batch:.2f}")
    log(f"[knn batch] nn_search launches {launches} (expected {expected}: per frame the "
        f"largest GN iteration count across streams, plus one fitness search), nn_pack "
        f"launches {packs} (expected {F}); the single-stream runs' {one_launches} and "
        f"{one_packs}; GN iterations per stream {its.sum(axis=1).tolist()}")
    if launches != expected or packs != F or one_packs != Bs * F:
        raise RuntimeError(f"[knn batch] launch counts {launches} / {packs} against "
                           f"{expected} / {F}")
    if one_launches != int(its.sum()) + Bs * F:
        raise RuntimeError(f"[knn batch] single-stream launches {one_launches} != "
                           f"{int(its.sum()) + Bs * F}")
    lost = int((out.fitness >= LOST_FITNESS).sum().item())
    if lost or not bool(torch.isfinite(out.world_T).all()):
        raise RuntimeError(f"[knn batch] {lost} lost frames or non-finite poses")
    differ = []
    for b, (one_state, one) in enumerate(singles):
        for f in dataclasses.fields(out):
            if not torch.equal(getattr(out, f.name)[b], getattr(one, f.name)):
                differ.append(f"stream {b} {f.name}")
        if not all(torch.equal(a, c) for a, c in zip(state.vmap.stream(b).tables(),
                                                     one_state.vmap.tables())):
            differ.append(f"stream {b} tables")
    log(f"[knn batch] each stream against its single-stream run on the card: "
        + ("every output and table equal bit for bit" if not differ else ", ".join(differ)))
    if differ:
        FAILED.append("[knn batch] streams differ from their single-stream runs: "
                      + ", ".join(differ))

    # K2 and the packing with the stream axis on the batch's own targets:
    # the last frame's sector submaps, the last scans in the world frame
    vm = cfg.voxel_map
    pose = out.world_T[:, -1]
    heading = matrix_to_rpy(pose[:, :3, :3])[:, 2]
    submap, submask, sub_n = voxel_map_sector_search(
        state.vmap, pose[:, :3, 3], vm.sector_radius, heading, vm.sector_half_angle_deg,
        vm.submap_max_points)
    submap, submask = submap.contiguous(), submask.contiguous()
    src = se3_apply(pose, batch.xyz[:, -1]).contiguous()
    ops = nn.nn_prepare(submap, submask)
    ki, kd = nn.nn_search(src, ops)
    torch.cuda.synchronize()
    packed = nn.nn_pack_plain(submap, submask)
    pi, pd = nn.nn_search_plain(src, ops)
    sep = [nn.nn_search(src[b].contiguous(), nn.nn_prepare(submap[b], submask[b]))
           for b in range(Bs)]
    pack_eq = all(torch.equal(a, c) for a, c in zip((ops.rows, ops.orig, ops.count), packed))
    plain_eq = torch.equal(ki, pi) and torch.equal(kd, pd)
    sep_eq = all(torch.equal(ki[b], i) and torch.equal(kd[b], d) for b, (i, d) in enumerate(sep))
    err = float((kd - pd).abs().max())
    N, M = src.shape[1], submap.shape[1]
    live = sub_n.long().tolist()
    log(f"[knn batch] K2 with the stream axis, {Bs} x {N} sources against {Bs} x {M} rows "
        f"({live} live): packing equal to the plain version {pack_eq}, indices and d2 equal "
        f"to the plain version {plain_eq} (max |d2| diff {err:.3e}), to {Bs} single-target "
        f"calls {sep_eq}")
    if not (pack_eq and plain_eq and sep_eq):
        raise RuntimeError("[knn batch] the stream-axis K2 or its packing disagrees")
    calls = 20

    def many(fn):
        def go():
            for _ in range(calls):
                fn()
        return go

    sep_ops = [nn.nn_prepare(submap[b], submask[b]) for b in range(Bs)]
    srcs = [src[b].contiguous() for b in range(Bs)]

    def separate():
        for b in range(Bs):
            nn.nn_search(srcs[b], sep_ops[b])

    order = (lambda: nn.nn_search_plain(src, ops), lambda: nn.nn_search(src, ops), separate,
             lambda: nn.nn_prepare(submap, submask), lambda: nn.nn_pack_plain(submap, submask))
    t = [time_cuda(torch, many(f)) / calls for f in order + order[::-1]]
    plain_ms, k_ms, sep_ms, pk_ms, ppk_ms = [(a + c) / 2 for a, c in zip(t[:5], t[::-1][:5])]
    dev_ms = kernel_device_ms(torch, lambda: nn.nn_search(src, ops), ("nn_search_kernel",))
    from icp4dradar_tpu_torch.utils import roofline as rl

    bound_ms, bound_by = rl.nn_search_bound(N, M, live).bound()
    pbound_ms, _ = rl.nn_pack_bound(M, Bs).bound()
    log(f"[knn batch] K2 call on prepared targets {k_ms:.4f} ms for {Bs} streams (one "
        f"launch; device {fmt_ms(dev_ms)}), {Bs} single-target calls {sep_ms:.4f} ms, plain "
        f"version {plain_ms:.4f} ms, bound {bound_ms:.6f} ms ({bound_by}, {Bs} x {N} x live "
        f"rows); packing {pk_ms:.4f} ms (one launch), plain {ppk_ms:.4f} ms, bound "
        f"{pbound_ms:.6f} ms (bytes)")
    return (dict(batch_launches=launches, single_stream_launches=one_launches,
                 batch_ms=k_ms, batch_device_ms=dev_ms, batch_separate_ms=sep_ms,
                 batch_plain_ms=plain_ms, batch_bound_ms=bound_ms, batch_max_abs_err=err),
            dict(batch_launches=packs, single_stream_launches=one_packs, batch_ms=pk_ms,
                 batch_plain_ms=ppk_ms, batch_bound_ms=pbound_ms))


def phase_parallel(torch, seq, scans, batch, card):
    """Phase 15: the data-parallel layer under NCCL at world size 1 (one
    rank on this card, a FileStore in a temp dir): make_mesh; the batch
    cell's 4 x 256 VGICP streams through sharded_scan_to_map_batch against
    phase 9's run_scan_to_map_batch (bit for bit), both timed;
    batched_preprocess and batched_icp_pairs against their single-device
    functions; distributed_optimize_pose_graph_block at the pose-graph
    phase's K = 32 (every factor type) and run_pose_graph_odometry(mesh=...)
    on the figure-eight against the single-device solves; the all-reduce
    and all-gather times; then dryrun_multichip(1) in a spawned rank."""
    import tempfile

    import torch.distributed as dist

    from icp4dradar_tpu_torch.config import PipelineConfig
    from icp4dradar_tpu_torch.graph import optimize_pose_graph_block
    from icp4dradar_tpu_torch.interop import pose_graph_from_numpy
    from icp4dradar_tpu_torch.io.scan import stack_scans
    from icp4dradar_tpu_torch.models import run_pose_graph_odometry, scan_to_map
    from icp4dradar_tpu_torch.parallel import (
        batched_icp_pairs,
        batched_preprocess,
        device_count,
        distributed_optimize_pose_graph_block,
        make_mesh,
        shard_scan_batch,
        sharded_scan_to_map_batch,
    )
    from icp4dradar_tpu_torch.parallel import batch as pbatch
    from icp4dradar_tpu_torch.parallel import distributed_gn as pdgn
    from icp4dradar_tpu_torch.parallel.dryrun import dryrun_multichip
    from icp4dradar_tpu_torch.preprocess import estimate_ego_velocity, reve_hypotheses
    from icp4dradar_tpu_torch.registration import icp_point_to_point
    from icp4dradar_tpu_torch.utils import doppler_uniforms, threefry

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_pg_")
    t0 = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"file://{tmp}/store", rank=0, world_size=1)
    mesh = make_mesh()
    init_s = time.perf_counter() - t0
    log(f"[parallel] NCCL process group of {device_count()} rank, mesh {mesh.mesh_dim_names} "
        f"{tuple(mesh.shape)} in {init_s:.2f} s; {card}")
    try:
        cfg = PipelineConfig()
        dev = scans.xyz.device

        def timed(fn):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            return res, (time.perf_counter() - t1) * 1e3

        def in_turns(dist_fn, ref_fn):
            """Both runs in turns (single-device, distributed, distributed,
            single-device): (distributed result, single-device result,
            distributed ms (two), single-device ms (two))."""
            r1, a = timed(ref_fn)
            d1, b = timed(dist_fn)
            _, c = timed(dist_fn)
            _, e = timed(ref_fn)
            return d1, r1, (b, c), (a, e)

        def ms2(x):
            return f"{x[0]:.2f} / {x[1]:.2f} ms"

        # ---- the batch cell's streams, sharded over the mesh ----
        kw = dict(block=S2M_BLOCK, use_const_velocity_rot=True, sequential_fallback=False)
        (_, first_ms) = timed(lambda: sharded_scan_to_map_batch(batch["batch"], mesh, cfg, **kw))
        (st, so), (rst, ro), sh_ms, ref_ms = in_turns(
            lambda: sharded_scan_to_map_batch(batch["batch"], mesh, cfg, **kw),
            lambda: scan_to_map.run_scan_to_map_batch(batch["batch"], cfg,
                                                      uniforms=batch["uniforms"], **kw))
        same = (all(torch.equal(getattr(so, f.name), getattr(ro, f.name))
                    for f in dataclasses.fields(so))
                and torch.equal(st.world_T, rst.world_T)
                and all(torch.equal(a, c) for a, c in zip(st.vmap.tables(), rst.vmap.tables())))
        Bs, F = so.world_T.shape[:2]
        log(f"[parallel] sharded_scan_to_map_batch, {Bs} streams x {F} frames (VGICP, block "
            f"{S2M_BLOCK}): first call {first_ms:.2f} ms (the group's first collectives), then "
            f"{ms2(sh_ms)} ({Bs * F / max(sh_ms) * 1e3:.1f}-{Bs * F / min(sh_ms) * 1e3:.1f} "
            f"scans/s) against run_scan_to_map_batch {ms2(ref_ms)} "
            f"({Bs * F / max(ref_ms) * 1e3:.1f}-{Bs * F / min(ref_ms) * 1e3:.1f} scans/s), in "
            f"turns; every output, pose and table equal bit for bit: {same}")
        if not same:
            raise RuntimeError("[parallel] the sharded batch differs from run_scan_to_map_batch")

        # ---- dp REVE and pairwise ICP over the bench frames ----
        Fp = S2M_FRAMES
        H = reve_hypotheses(cfg.reve)
        key = threefry.key(0)

        def draws():
            return torch.from_numpy(threefry.uniform(threefry.split(key, Fp), 3 * H)).to(dev)

        # the single-device call makes the same draws the same way, so the
        # two differ by the layer alone (sharding, the all-gather)
        _, draw_ms = timed(draws)
        est, ref, pre_ms, pre_ref_ms = in_turns(
            lambda: batched_preprocess(shard_scan_batch(scans[:Fp], mesh), key, mesh, cfg),
            lambda: estimate_ego_velocity(scans[:Fp], draws(), cfg.reve))
        same_pre = all(torch.equal(getattr(est, f.name), getattr(ref, f.name))
                       for f in dataclasses.fields(est))
        src, tgt = scans[1:Fp + 1], scans[:Fp]
        T, Tr, icp_ms, icp_ref_ms = in_turns(
            lambda: batched_icp_pairs(shard_scan_batch(src, mesh), shard_scan_batch(tgt, mesh),
                                      mesh, cfg),
            lambda: icp_point_to_point(src.xyz, tgt.xyz, src.mask, tgt.mask,
                                       cfg=cfg.icp).transform)
        same_icp = torch.equal(T, Tr)
        log(f"[parallel] batched_preprocess, {Fp} frames (its draws made on the host, "
            f"{draw_ms:.2f} ms alone): {ms2(pre_ms)} against estimate_ego_velocity on the "
            f"same draws made the same way {ms2(pre_ref_ms)}, equal {same_pre}; "
            f"batched_icp_pairs, {Fp} pairs: {ms2(icp_ms)} against icp_point_to_point "
            f"{ms2(icp_ref_ms)}, equal {same_icp} (in turns)")
        if not (same_pre and same_icp):
            raise RuntimeError("[parallel] dp REVE or dp ICP differs from single-device")

        # ---- the distributed block GN at the pose-graph phase's K ----
        gt_d, poses_d, rel_d = pg_loop_graph(torch, PG_DENSE_K, 10.0, 3, 0.01, seed=3)
        g = pose_graph_from_numpy({"poses": poses_d, "rel": rel_d,
                                   **pg_single_pose_factors(PG_DENSE_K, gt_d, seed=3)},
                                  device="cuda")
        (gd, cd), (gs, cs), d_ms, s_ms = in_turns(
            lambda: distributed_optimize_pose_graph_block(g, mesh),
            lambda: optimize_pose_graph_block(g))
        dd = float((gd.poses - gs.poses).abs().max())
        log(f"[parallel] distributed_optimize_pose_graph_block, K={PG_DENSE_K} with every "
            f"factor type: {ms2(d_ms)} against optimize_pose_graph_block {ms2(s_ms)} (in "
            f"turns); max "
            f"pose entry difference {dd:.3e} (tolerance {PAR_POSE_TOL}), cost {float(cd):.6f} "
            f"against {float(cs):.6f}")
        if not dd <= PAR_POSE_TOL:
            raise RuntimeError(f"[parallel] the distributed block GN is {dd} off")

        # ---- run_pose_graph_odometry(mesh=...) on the figure-eight ----
        fseq = figure_eight(PG_FRAMES)
        fscans = stack_scans([fseq.scan(k) for k in range(PG_FRAMES)]).to("cuda")
        u_s2s = torch.from_numpy(doppler_uniforms(cfg.seed, PG_FRAMES,
                                                  cfg.doppler.num_hypotheses)).cuda()
        rm, rs, m_ms, r_ms = in_turns(
            lambda: run_pose_graph_odometry(fscans, cfg, uniforms=u_s2s, mesh=mesh, **PG_KW),
            lambda: run_pose_graph_odometry(fscans, cfg, uniforms=u_s2s, **PG_KW))
        dp = float(np.abs(rm.poses - rs.poses).max())
        log(f"[parallel] run_pose_graph_odometry(mesh=...) on the figure-eight ({PG_FRAMES} "
            f"frames, K = {len(rm.keyframe_indices)}): {ms2(m_ms)} against {ms2(r_ms)} "
            f"without a mesh (in turns); closures {rm.num_loop_closures} against "
            f"{rs.num_loop_closures}; "
            f"max pose entry difference {dp:.3e} (tolerance {PAR_POSE_TOL})")
        if rm.num_loop_closures != rs.num_loop_closures or not dp <= PAR_POSE_TOL:
            raise RuntimeError(f"[parallel] the pipeline with a mesh is {dp} off")

        # ---- the collectives alone, at this phase's payloads ----
        ne = [torch.zeros(n, device="cuda") for n in
              (PG_DENSE_K * 36, (PG_DENSE_K - 1) * 36, PG_DENSE_K * 6, 1)]
        tables = [st.world_T] + list(st.vmap.tables())
        reps = PAR_COLLECTIVE_REPS
        ar_ms = time_cuda(torch, lambda: [pdgn._all_reduce_sum(ne, mesh, "dp")
                                          for _ in range(reps)]) / reps
        ag_ms = time_cuda(torch, lambda: [pbatch._all_gather_rows(tables, mesh, "dp")
                                          for _ in range(reps)]) / reps
        nbytes = sum(t.numel() * t.element_size() for t in tables)
        log(f"[parallel] collectives at world size 1 (NCCL, CUDA events, {reps} calls): the "
            f"block normal equations' all-reduce ({sum(t.numel() for t in ne) * 4} bytes) "
            f"{ar_ms:.4f} ms a call (one a GN iteration); the batch state's all-gather "
            f"({nbytes / 2**20:.1f} MiB, packed as bytes) {ag_ms:.4f} ms a call; {card}")
    finally:
        dist.destroy_process_group()

    t0 = time.perf_counter()
    res = dryrun_multichip(1)
    log(f"[parallel] dryrun_multichip(1): a spawned NCCL rank, {time.perf_counter() - t0:.2f} s "
        f"with its start-up; cost {float(res['cost']):.4f}, block poses finite "
        f"{bool(np.isfinite(res['block_poses']).all())}; stage 3 sector rows "
        f"{int(res['sub_n'])}, stage 3b ring wsum {float(res['ring'][3]):.1f}, stage 3c "
        f"{res['pipeline']['world_T'].shape[0]} frames, poses finite "
        f"{bool(np.isfinite(res['pipeline']['world_T']).all())}, map voxels "
        f"{res['pipeline_voxels']}")
    log(f"[parallel] phase seconds {time.perf_counter() - t_phase:.1f}")


# phase 16 (distributed): the s2m cell through the map-sharded pipeline at
# NCCL world size 1; its ATE against the JAX package's CPU run of the same
# call on a 1-device mesh (scripts/port_distributed_reference.py), within
# phase 5's band (0.04153 m, 11.53 GN iterations a frame, 3,865 voxels)
DIST_ATE_JAX = 0.04153
DIST_ATE_BAND = 0.01
DIST_BUDGET_S = 60.0
DIST_RING_RTOL = 1e-4
DIST_CLI_FRAMES = 16
DIST_PROFILE_FRAMES = 24


def phase_distributed(torch, seq, scans, card):
    """Phase 16: `run_scan_to_map_distributed` over the s2m cell (256 x
    2048, capacity 2^18, submap 2^14, block 8, cv-rot, JAX's draws) under
    NCCL at world size 1 (a FileStore in a temp dir): a warm-up run of its
    first 24 frames, then runs in turns with `run_scan_to_map_blocked`
    (single-device, distributed, single-device), K4's and K5's counts set
    to 0 just before the distributed run of the turns and read just after
    (both > 0, each the run's GN iterations: one ring step a GN iteration
    at world 1), its ATE against DIST_ATE_JAX; the layers
    against their single-device counterparts (the final sharded map
    against `voxel_map_insert` of the recorded batches, content equal; the
    distributed rehash of the map with tombstones against
    `voxel_map_rehash`, tables equal; one ring normal-equation pass against
    `vgicp_iteration` on the gathered submap; a save/load round trip); a
    profiled window of the run (its first 24 frames); then the CLI's
    `--distributed 1 --device cuda` in a process of its own. Returns K4's
    and K5's launch counts."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from icp4dradar_tpu_torch.config import PipelineConfig
    from icp4dradar_tpu_torch.geom.so3 import matrix_to_rpy
    from icp4dradar_tpu_torch.mapping import voxel_map_create, voxel_map_insert
    from icp4dradar_tpu_torch.mapping.voxel_hash import voxel_map_rehash
    from icp4dradar_tpu_torch.models import scan_to_map
    from icp4dradar_tpu_torch.ops import vgicp_fused
    from icp4dradar_tpu_torch.parallel import (
        load_distributed_state,
        make_mesh,
        ring_vgicp_normal_equations,
        run_scan_to_map_distributed,
        save_distributed_state,
        sharded_map_rehash,
    )
    from icp4dradar_tpu_torch.parallel import distributed_pipeline as dpipe
    from icp4dradar_tpu_torch.parallel.sharded_map import forget_far, shard_local_sector_stats
    from icp4dradar_tpu_torch.utils import ate_rmse

    t_phase = time.perf_counter()
    F, B = S2M_FRAMES, S2M_BLOCK
    s2m = scans[:F]
    cfg = PipelineConfig()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    dist.init_process_group("nccl", init_method=f"file://{tmp}/store", rank=0, world_size=1)
    try:
        mesh = make_mesh()

        def run(frames=F):
            out = run_scan_to_map_distributed(s2m[:frames], mesh, cfg, block=B,
                                              use_const_velocity_rot=True)
            torch.cuda.synchronize()
            return out

        def single():
            out = scan_to_map.run_scan_to_map_blocked(s2m, cfg, block=B,
                                                      use_const_velocity_rot=True)
            torch.cuda.synchronize()
            return out

        def timed(fn):
            t1 = time.perf_counter()
            res = fn()
            return res, time.perf_counter() - t1

        # warm-up: the warm-up frames and two blocks (the communicator's
        # first collective, every kernel and op of the path)
        _, warm = timed(lambda: run(DIST_PROFILE_FRAMES))
        _, s_a = timed(single)
        # the distributed run of the turns is the counted one; it records
        # every batch it inserts (a list append a batch)
        batches = []
        insert = dpipe.shard_local_insert
        dpipe.shard_local_insert = lambda sm, *a: (batches.append(a), insert(sm, *a))[1]
        vgicp_fused.VGICP_SWEEP_LAUNCHES = 0
        vgicp_fused.VGICP_FROZEN_LAUNCHES = 0
        try:
            (smap, out), d_a = timed(run)
        finally:
            dpipe.shard_local_insert = insert
        k4, k5 = vgicp_fused.VGICP_SWEEP_LAUNCHES, vgicp_fused.VGICP_FROZEN_LAUNCHES
        _, s_b = timed(single)
        t_turns = warm + s_a + d_a + s_b
        its = out["iterations"].cpu().numpy()
        log(f"[distributed] {F} frames x {s2m.xyz.shape[1]} points, block {B}, cv-rot, NCCL "
            f"world 1 (the map sharded over 1 rank, the ring one step): warm-up "
            f"({DIST_PROFILE_FRAMES} frames) {warm:.2f} s; "
            f"in turns run_scan_to_map_blocked {F / s_a:.1f} scans/s, distributed "
            f"{F / d_a:.1f} scans/s, run_scan_to_map_blocked {F / s_b:.1f} scans/s; {card}")
        log(f"[distributed] launches over the distributed run of the turns: vgicp_sweep "
            f"{k4}, vgicp_frozen {k5}; GN iterations {int(its.sum())} ({its.mean():.2f} a "
            f"frame, warm-up {its[:B].mean():.2f}, blocks {its[B:].mean():.2f})")
        if not (k4 > 0 and k5 > 0 and k4 == k5 == int(its.sum())):
            raise RuntimeError(f"[distributed] K4 {k4} / K5 {k5} launches, "
                               f"{int(its.sum())} GN iterations")
        for name, x in out.items():
            if x.shape[0] != F or not bool(torch.isfinite(x.float()).all()):
                raise RuntimeError(f"[distributed] {name}: shape {tuple(x.shape)} or non-finite")
        poses = out["world_T"].cpu().numpy()
        ate = ate_rmse(poses[:, :3, 3], seq.poses[:F, :3, 3], align=False)
        lost = int((out["fitness"] >= LOST_FITNESS).sum())
        sub = out["submap_points"].cpu().numpy()
        log(f"[distributed] ATE (align=False) {ate:.5f} m against the JAX CPU run's "
            f"{DIST_ATE_JAX} (band {DIST_ATE_BAND}); lost frames {lost}; submap rows "
            f"{int(sub[1:].min())}-{int(sub.max())} (mean {sub.mean():.1f}); map voxels "
            f"{int(smap.num_voxels)}")
        if lost or not abs(ate - DIST_ATE_JAX) <= DIST_ATE_BAND:
            raise RuntimeError(f"[distributed] ATE {ate:.5f} m, {lost} lost frames")

        # ---- the layers against their single-device counterparts ----
        t_layers = time.perf_counter()
        ref = voxel_map_create(cfg.voxel_map.capacity, device="cuda")
        for xyz, mask, inten in batches:
            ref = voxel_map_insert(ref, xyz, mask, inten)
        table = smap.gather()

        def content(m):
            occ = m.occupied.cpu().numpy() > 0.5
            return dict(zip(map(tuple, m.keys.cpu().numpy()[occ]),
                            zip(map(tuple, np.round(m.points.cpu().numpy()[occ], 5)),
                                m.stat_n.cpu().numpy()[occ])))

        same_map = content(table) == content(ref)
        forgotten = forget_far(smap, out["world_T"][-1, :3, 3], 40.0)
        tombs = int(((forgotten.local.keys[:, 0] != 0x7FFFFFFF)
                     & (forgotten.local.occupied <= 0.5)).sum())
        rehashed = sharded_map_rehash(forgotten, mesh).gather()
        single_rehash = voxel_map_rehash(forgotten.gather())
        same_rehash = all(torch.equal(a, b) for a, b in zip(rehashed.tables(),
                                                           single_rehash.tables()))
        pose = out["world_T"][-1]
        center = pose[:3, 3]
        heading = matrix_to_rpy(pose[:3, :3])[2]
        _, tmask, cnt, tm, tc = shard_local_sector_stats(
            smap, center, cfg.voxel_map.sector_radius, heading,
            cfg.voxel_map.sector_half_angle_deg, cfg.voxel_map.submap_max_points)
        T = pose.clone()
        T[:3, 3] = 0.0
        last = s2m[F - 1]
        scov = vgicp_fused.radar_point_covariances_packed(last.xyz)
        ring = ring_vgicp_normal_equations(T, last.xyz, last.mask, scov, tm - center, tc, tmask,
                                           mesh)
        plain = vgicp_fused.vgicp_iteration(T, last.xyz, last.mask, scov, tm - center, tc, tmask)
        ring_err = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                       for a, b in zip(ring[:3], plain[:3]))
        path = os.path.join(tmp, "state")
        save_distributed_state(path, smap, pose, frame=F)
        loaded, lpose, lframe = load_distributed_state(path, mesh)
        same_ckpt = (all(torch.equal(a, b) for a, b in zip(loaded.gather().tables(),
                                                            table.tables()))
                     and torch.equal(lpose, pose) and lframe == F)
        log(f"[distributed] layers against single-device: the final sharded map against "
            f"voxel_map_insert of its {len(batches)} recorded batches, content equal "
            f"{same_map}; forget at 40 m ({tombs} tombstones) then the distributed rehash "
            f"against voxel_map_rehash, tables equal {same_rehash}; one ring pass (K4 with "
            f"return_best, K5) against vgicp_iteration on the final pose's submap "
            f"({int(cnt)} live rows): largest difference {ring_err:.3e} of the largest entry "
            f"(H, g, cost; tolerance {DIST_RING_RTOL}), wsum {float(ring[3]):.1f} against "
            f"{float(plain[3]):.1f}; save/load round trip equal {same_ckpt}; "
            f"{time.perf_counter() - t_layers:.1f} s")
        if not (same_map and same_rehash and same_ckpt and ring_err <= DIST_RING_RTOL
                and float(ring[3]) == float(plain[3]) and tombs > 0):
            raise RuntimeError("[distributed] a layer differs from its single-device "
                               "counterpart")
        t_layers = time.perf_counter() - t_layers
        # a profiled window of the run (the warm-up frames and two blocks),
        # the device's activity alone, read from the trace's raw events:
        # building the profiler's per-event records for key_averages costs
        # seconds at ~27,000 launches
        from torch.profiler import ProfilerActivity, profile

        t_prof = time.perf_counter()
        _, wall = timed(lambda: run(DIST_PROFILE_FRAMES))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run(DIST_PROFILE_FRAMES)
        t_read = time.perf_counter()
        kern = {}
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                n, ns = kern.get(e.name(), (0, 0))
                kern[e.name()] = (n + 1, ns + e.duration_ns())
        busy = sum(ns for _, ns in kern.values()) / 1e6
        launches = sum(n for n, _ in kern.values())
        top = sorted(kern.items(), key=lambda kv: -kv[1][1])[:4]
        t_read = time.perf_counter() - t_read
        t_prof = time.perf_counter() - t_prof
        log(f"[distributed] profiled window, the first {DIST_PROFILE_FRAMES} frames: run "
            f"{wall * 1e3:.2f} ms unprofiled, device kernel time {busy:.2f} ms in {launches} "
            f"kernel launches ({launches / DIST_PROFILE_FRAMES:.0f} a frame), idle share "
            f"{max(0.0, 1 - busy / (wall * 1e3)):.3f}; top: " + "; ".join(
                f"{ns / 1e6:.3f} ms x{n} {kernel_name(name)}" for name, (n, ns) in top)
            + f"; {t_prof:.1f} s, {t_read:.2f} s of it reading the trace")
    finally:
        dist.destroy_process_group()

    # ---- the CLI: --distributed 1 --device cuda, a rank of its own ----
    out_dir = os.path.join(tmp, "cli")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "icp4dradar_tpu_torch.models.run_odometry", "--mode",
         "scan_to_map", "--synthetic", str(DIST_CLI_FRAMES), "--map-interval", str(B),
         "--cv-rot", "--viz", "--distributed", "1", "--device", "cuda", "--out", out_dir],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True,
        timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"[distributed] the CLI exited {proc.returncode}: "
                           f"{proc.stderr[-2000:]}")
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    files = sorted(os.listdir(out_dir))
    t_cli = time.perf_counter() - t0
    log(f"[distributed] CLI --distributed 1 --device cuda, {DIST_CLI_FRAMES} frames: "
        f"{t_cli:.2f} s with its process and rank start-up; record "
        f"{json.dumps(rec)}; files {files}")
    want = ["map.ply", "metrics.jsonl", "odom_tum.txt", "pcl_info.txt", "radar_odometry.txt",
            "velocity.txt", "viewer.html"]
    if files != want or rec["frames"] != DIST_CLI_FRAMES or rec["device"] != "cuda":
        raise RuntimeError("[distributed] the CLI's files or record differ")
    shutil.rmtree(tmp, ignore_errors=True)
    secs = time.perf_counter() - t_phase
    log(f"[distributed] phase seconds {secs:.1f} (budget {DIST_BUDGET_S} s): warm-up and "
        f"turns {t_turns:.1f}, layers {t_layers:.1f}, profiled window {t_prof:.1f}, CLI "
        f"{t_cli:.1f}")
    if secs > DIST_BUDGET_S:
        FAILED.append(f"[distributed] the phase took {secs:.1f} s, over its {DIST_BUDGET_S} s")
    return {"k4": k4, "k5": k5, "launches": launches}


# phase 17 (accumulate): the sparse-vendor tracking paths at the s2m cell's
# width, on JAX's draws; each run's ATE against the JAX package's CPU run of
# the same path (scripts/port_accumulate_reference.py)
ACC_BUDGET_S = 60.0
ACC_WINDOW_FRAMES, ACC_KNN_FRAMES, ACC_TI_FRAMES = 64, 16, 64
ACC_ATE_JAX = {"window": 1.43391, "knn": 0.10195, "union": 0.07048, "ti_window": 3.73635,
               "ti_union": 1.79970}
# kNN GICP with a window as the other s2m cells (0.01 m); the runs whose
# ATE is metres (past scans rigid to the prediction pull the track, the
# JAX package's record: 3.1-18 m) within a tenth of JAX's ATE
ACC_ATE_BAND = {"knn": 0.01, "union": 0.01}
ACC_REL_BAND = 0.1
# the union over the bench scene is chaotic after its first blocks: three
# runs of the same semantics (JAX's CPU, the port's CPU and card) part by
# >1e-2 m from frame ~48 and end at 6.98, 43.0 and 24.5 m of ATE (PERF.md
# section 6); its first 64 frames (8 blocks, the warm-up and 7 unions) agree
# within 4e-3 m, so their ATE is what is held (JAX CPU 0.07048 m), the
# whole run's printed beside JAX's 6.97589 m
ACC_UNION_HELD_FRAMES = 64
ACC_UNION_ATE_JAX_ALL = 6.97589
# the eval suite's matched covariances for the ti_mmwave profile
ACC_TI_COV = {"gicp.sigma_azimuth": 0.0175, "gicp.sigma_elevation": 0.0175,
              "gicp.sigma_range": 0.12}


def phase_accumulate(torch, seq, scans, card):
    """Phase 17: scan accumulation and the rigid block union, the port's
    last slice, at the s2m cell's full width (2048 points, capacity 2^18,
    submap 2^14) on JAX's REVE draws. Runs, each with its kernel counts set
    to 0 just before and read just after (K4 launches = the GN sweeps run:
    one a GN iteration a frame, one a block for the union; K2 launches =
    the GN iterations plus one fitness search a frame): (1) the bench
    sequence's first 64 frames through `run_scan_to_map` with
    `accumulate_scans=4` (K4 at 4 x 2048 = 8,192 sources), (2) 16 frames of
    kNN GICP with `accumulate_scans=2` (K2 at 4,096 sources), (3) the s2m
    cell's 256 frames through `run_scan_to_map_blocked(block=8,
    use_const_velocity_rot=True, rigid_union=True)` (K4 at 16,384 sources a
    block), (4) the eval suite's ti_mmwave sequence (64 frames, matched
    covariances) through (1) and (3); each run's ATE against ACC_ATE_JAX
    and its scans/s. Then K4 on a 16,384-row union and on an 8,192-row
    window, and K2 on 4,096 sources, each against its plain version on the
    same inputs (one call each, timed in turns), the roofline module's
    hot-kernel reports with the card's launch floor, and the phase's
    seconds (at most ACC_BUDGET_S). Returns the kernel-row fields."""
    import importlib

    from icp4dradar_tpu_torch.config import PipelineConfig
    from icp4dradar_tpu_torch.geom import se3_apply, se3_inverse
    from icp4dradar_tpu_torch.geom.so3 import matrix_to_rpy
    from icp4dradar_tpu_torch.io import SyntheticSequence
    from icp4dradar_tpu_torch.io.scan import stack_scans
    from icp4dradar_tpu_torch.mapping import (
        voxel_map_sector_search, voxel_map_sector_search_with_stats,
    )
    from icp4dradar_tpu_torch.models import scan_to_map
    from icp4dradar_tpu_torch.ops import vgicp_fused as vf
    from icp4dradar_tpu_torch.ops.vgicp_fused import (
        radar_point_covariances_packed, vgicp_iteration_plain,
    )
    from icp4dradar_tpu_torch.preprocess.reve import reve_hypotheses
    from icp4dradar_tpu_torch.utils import ate_rmse, reve_uniforms
    from icp4dradar_tpu_torch.utils import roofline as rl

    nn = importlib.import_module("icp4dradar_tpu_torch.ops.knn")
    t_phase = time.perf_counter()
    base = PipelineConfig()
    H = reve_hypotheses(base.reve)
    ti_seq = SyntheticSequence(
        num_frames=ACC_TI_FRAMES, max_points=BENCH_POINTS, num_landmarks=8000,
        world_extent=150.0, max_range=80.0, seed=0, speed=1.0, turn_rate=0.03,
        dynamic_fraction=0.1, pos_noise=0.02, vendor_profile="ti_mmwave")
    ti_scans = stack_scans([ti_seq.scan(k) for k in range(ACC_TI_FRAMES)]).to("cuda")
    ti_cfg = base.override(**ACC_TI_COV)

    def window(sc, cfg, k=4):
        F = sc.xyz.shape[0]
        u = torch.from_numpy(reve_uniforms(cfg.seed, F, 0, H)).cuda()
        return scan_to_map.run_scan_to_map(sc, cfg.override(accumulate_scans=k), uniforms=u)

    def union(sc, cfg):
        F = sc.xyz.shape[0]
        u = torch.from_numpy(reve_uniforms(cfg.seed, F, S2M_BLOCK, H)).cuda()
        return scan_to_map.run_scan_to_map_blocked(sc, cfg, uniforms=u, block=S2M_BLOCK,
                                                   use_const_velocity_rot=True,
                                                   rigid_union=True)

    runs = (
        ("window", lambda: window(scans[:ACC_WINDOW_FRAMES], base), seq),
        ("knn", lambda: window(scans[:ACC_KNN_FRAMES],
                               base.override(**{"gicp.use_vgicp": False}), k=2), seq),
        ("union", lambda: union(scans[:S2M_FRAMES], base), seq),
        ("ti_window", lambda: window(ti_scans, ti_cfg), ti_seq),
        ("ti_union", lambda: union(ti_scans, ti_cfg), ti_seq),
    )
    results, k4_total, k2_total = {}, 0, 0
    for name, run, sq in runs:
        vf.VGICP_SWEEP_LAUNCHES = 0
        nn.NN_SEARCH_LAUNCHES = 0
        t0 = time.perf_counter()
        state, out = run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        k4, k2 = vf.VGICP_SWEEP_LAUNCHES, nn.NN_SEARCH_LAUNCHES
        F = out.world_T.shape[0]
        its = out.iterations.cpu().numpy()
        if name.endswith("union"):
            # the warm-up frames one sweep a GN iteration, then one union a
            # block: its sweeps are every frame's of the block
            sweeps = int(its[:S2M_BLOCK].sum() + its[S2M_BLOCK::S2M_BLOCK].sum())
            blocks = its[S2M_BLOCK:].reshape(-1, S2M_BLOCK)
            if not (blocks == blocks[:, :1]).all():
                raise RuntimeError(f"[accumulate] {name}: a block's frames report "
                                   f"different sweeps")
        else:
            sweeps = int(its.sum())
        expect_k4, expect_k2 = (0, sweeps + F) if name == "knn" else (sweeps, 0)
        if k4 != expect_k4 or k2 != expect_k2 or (k4 + k2) <= 0:
            raise RuntimeError(f"[accumulate] {name}: launches K4 {k4} / K2 {k2}, expected "
                               f"{expect_k4} / {expect_k2}")
        k4_total, k2_total = k4_total + k4, k2_total + k2
        P = out.world_T.cpu().numpy()
        if not np.isfinite(P).all():
            raise RuntimeError(f"[accumulate] {name}: non-finite poses")
        ate = ate_rmse(P[:, :3, 3], sq.poses[:F, :3, 3], align=False)
        ref = ACC_ATE_JAX[name]
        whole = ""
        if name == "union":
            whole = (f"; the whole run's ATE {ate:.5f} m (JAX CPU {ACC_UNION_ATE_JAX_ALL}, "
                     f"chaotic: not held), the first {ACC_UNION_HELD_FRAMES} frames' held")
            n = ACC_UNION_HELD_FRAMES
            ate = ate_rmse(P[:n, :3, 3], sq.poses[:n, :3, 3], align=False)
        band = ACC_ATE_BAND.get(name, ACC_REL_BAND * (ref or 0.0))
        lost = int((out.fitness >= LOST_FITNESS).sum())
        pts = (ti_scans if name.startswith("ti_") else scans).mask[:F].sum(dim=1).float().mean()
        log(f"[accumulate] {name}: {F} frames ({pts:.1f} points a scan) in {dt:.3f} s = "
            f"{F / dt:.1f} scans/s; K4 launches {k4}, K2 launches {k2} (expected "
            f"{expect_k4} / {expect_k2}: GN sweeps {sweeps}){whole}; ATE (align=False) "
            f"{ate:.5f} m against the JAX CPU run's {ref} (band {band:.4f}); lost frames {lost}; "
            f"map voxels {int(state.vmap.num_voxels)}; {card}")
        if lost or not abs(ate - ref) <= band:
            FAILED.append(f"[accumulate] {name}: ATE {ate:.5f} m against {ref} +- {band:.4f}, "
                          f"{lost} lost frames")
        results[name] = (state, out)

    # ---- the kernels at the new shapes against their plain versions ----
    g = base.gicp
    kw = dict(max_correspondence_dist=g.max_correspondence_dist, cov_eps=g.cov_epsilon)

    def frozen_submap(state, pose):
        vm = base.voxel_map
        heading = matrix_to_rpy(pose[:3, :3])[2]
        return voxel_map_sector_search_with_stats(
            state.vmap, pose[:3, 3], vm.sector_radius, heading, vm.sector_half_angle_deg,
            vm.submap_max_points, min_count=vm.stats_min_count,
            fallback_var=vm.stats_fallback_var)

    def sweep_case(tag, frames, state, out, sc):
        """K4 on one cloud of `frames` scans (the last ones of the run, in
        the last frame's tracked sensor frame) against the final map's
        submap at the last pose, one transform, vs the plain version."""
        last = out.world_T[-1]
        rel = se3_inverse(last)[None] @ out.world_T[-frames:]
        src = se3_apply(rel, sc.xyz[-frames:]).reshape(-1, 3).contiguous()
        sm = out.insert_mask[-frames:].reshape(-1).contiguous()
        scov = radar_point_covariances_packed(src, g.sigma_range, g.sigma_azimuth,
                                              g.sigma_elevation).contiguous()
        _, tmask, cnt, tmean, tcov = frozen_submap(state, last)
        center = last[:3, 3]
        T = last.clone()
        T[:3, 3] = 0.0
        args = (T, src, sm, scov, (tmean - center).contiguous(), tcov.contiguous(),
                tmask.contiguous())
        # prepared once, as a registration prepares its operands
        ops = vf.vgicp_prepare(*args[1:], tgt_count=cnt)
        k = vf.vgicp_sweep(T, ops, **kw)
        p = vgicp_iteration_plain(*args, tgt_count=cnt, **kw)
        err = 0.0
        for n, a, b in zip(("H", "g", "cost", "wsum", "d2sum"), k, p):
            a, b = a.double().cpu(), b.double().cpu()
            if bool(((a - b).abs() > VG_ATOL + VG_RTOL * b.abs()).any()) or \
                    not bool(torch.isfinite(a).all()):
                raise RuntimeError(f"[accumulate] {tag}: K4 {n} beyond rtol {VG_RTOL} / "
                                   f"atol {VG_ATOL} of the plain version")
            err = max(err, (a - b).abs().max().item())
        p1, k1, k2_, p2 = (time_cuda(torch, f, reps=5, warmup=1) for f in (
            lambda: vgicp_iteration_plain(*args, tgt_count=cnt, **kw),
            lambda: vf.vgicp_sweep(T, ops, **kw), lambda: vf.vgicp_sweep(T, ops, **kw),
            lambda: vgicp_iteration_plain(*args, tgt_count=cnt, **kw)))
        live = int(cnt.item())
        b_ms, b_by = rl.vgicp_sweep_bound(1, src.shape[0], [live]).bound()
        log(f"[accumulate] K4 on the {tag}: {src.shape[0]} sources x {tmean.shape[0]} rows "
            f"({live} live), one transform: max abs err {err:.3e} against the plain version; "
            f"the call on prepared operands {k1:.4f} / {k2_:.4f} ms, plain {p1:.4f} / "
            f"{p2:.4f} ms, bound "
            f"{b_ms:.5f} ms ({b_by})")
        return dict(ms=(k1 + k2_) / 2, plain_ms=(p1 + p2) / 2, bound_ms=b_ms, max_abs_err=err)

    # both on the window run's final map (the union's walks off the bench
    # scene, its last submap holds ~190 live rows)
    w_state, w_out = results["window"][:2]
    union_row = sweep_case(f"union of {S2M_BLOCK} scans", S2M_BLOCK, w_state, w_out,
                           scans[:ACC_WINDOW_FRAMES])
    window_row = sweep_case("window of 4 scans", 4, w_state, w_out, scans[:ACC_WINDOW_FRAMES])

    # K2 on the kNN run's sources: the last frame and its one window scan in
    # the world frame at their tracked poses, against the final map's
    # sector submap at the last pose
    k_state, k_out = results["knn"][:2]
    sc = scans[:ACC_KNN_FRAMES]
    last = k_out.world_T[-1]
    src = se3_apply(k_out.world_T[-2:], sc.xyz[-2:]).reshape(-1, 3).contiguous()
    vm = base.voxel_map
    submap, submask, _ = voxel_map_sector_search(
        k_state.vmap, last[:3, 3], vm.sector_radius, matrix_to_rpy(last[:3, :3])[2],
        vm.sector_half_angle_deg, vm.submap_max_points)
    ops = nn.nn_prepare(submap.contiguous(), submask.contiguous())
    ki, kd = nn.nn_search(src, ops)
    pi, pd = nn.nn_search_plain(src, ops)
    same = bool(torch.equal(ki, pi)) and bool(torch.equal(kd, pd))
    nerr = (kd - pd).abs().max().item()
    p1, c1, c2, p2 = (time_cuda(torch, f, reps=5, warmup=1) for f in (
        lambda: nn.nn_search_plain(src, ops), lambda: nn.nn_search(src, ops),
        lambda: nn.nn_search(src, ops), lambda: nn.nn_search_plain(src, ops)))
    live = int((submask > 0.5).sum().item())
    nb_ms, nb_by = rl.nn_search_bound(src.shape[0], submap.shape[0], [live]).bound()
    log(f"[accumulate] K2 on {src.shape[0]} sources x {submap.shape[0]} rows ({live} live): "
        f"indices and d2 equal to the plain version: {same} (max abs err {nerr:.3e}); the "
        f"call on prepared targets {c1:.4f} / {c2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms, "
        f"bound {nb_ms:.6f} ms ({nb_by})")
    if not same:
        raise RuntimeError("[accumulate] K2 at 4,096 sources differs from its plain version")

    # ---- the roofline module's hot-kernel reports on the card ----
    for rep in rl.measure_hot_kernels("cuda", reps=32):
        log(f"[accumulate] roofline {rl.format_report(rep)} (launch floor "
            f"{rep['launch_floor_ms']} ms)")
    secs = time.perf_counter() - t_phase
    log(f"[accumulate] phase seconds {secs:.1f} (budget {ACC_BUDGET_S} s)")
    if secs > ACC_BUDGET_S:
        FAILED.append(f"[accumulate] the phase took {secs:.1f} s, over its {ACC_BUDGET_S} s")
    return (dict(accumulate_launches=k4_total,
                 **{f"union_{k}": v for k, v in union_row.items()},
                 **{f"window_{k}": v for k, v in window_row.items()}),
            dict(accumulate_launches=k2_total, accumulate_ms=(c1 + c2) / 2,
                 accumulate_plain_ms=(p1 + p2) / 2, accumulate_bound_ms=nb_ms,
                 accumulate_max_abs_err=nerr))


def gn_frames(torch, n, lm, seed):
    """n GN steps at a sweep's scale, frame f of kind GN_KINDS[f % 5]: T,
    H (SPD), g = -(H + lm I) xi for a chosen xi (theta^2 = 2.9e-9 for
    'taylor', theta = 1 rad for 'one_rad'), NaN H for 'nonfinite', inactive
    for 'inactive' -> (T, H, g, active, kind) on the card."""
    from icp4dradar_tpu_torch.geom import se3_exp

    rng = np.random.default_rng(seed)
    T = se3_exp(torch.from_numpy(rng.normal(0, [2.0, 2.0, 0.2, 0.1, 0.1, 1.0], (n, 6))
                                 .astype(np.float32)))
    J = rng.normal(0, 1, (n, 64, 6)) * [1, 1, 1, 8, 8, 8]
    H = np.einsum("nki,nkj->nij", J, J) * 20.0
    xi = rng.normal(0, [0.05, 0.05, 0.02, 0.01, 0.01, 0.02], (n, 6))
    kind = np.arange(n) % len(GN_KINDS)
    xi[kind == 3, 3:] = [3e-5, -2e-5, 4e-5]
    xi[kind == 4, 3:] = np.array([1.0, -2.0, 2.0]) / 3.0
    g = -np.einsum("nij,nj->ni", H + lm * np.eye(6), xi)
    H = torch.from_numpy(H.astype(np.float32))
    H[torch.from_numpy(kind == 2)] = float("nan")
    out = (T, H, torch.from_numpy(g.astype(np.float32)), torch.from_numpy(kind != 1),
           torch.from_numpy(kind))
    return tuple(x.to("cuda") for x in out)


def phase_gn_step(torch, s2m_launches, batch_launches):
    """The GN step kernel against `gn_step_plain` on the card: equal bits,
    held frames unchanged, one launch and no host sync a call; the call and
    the plain version timed (CUDA events, plain / kernel / kernel / plain)
    with the kernel's device time and its bound."""
    from icp4dradar_tpu_torch.config import GicpConfig
    from icp4dradar_tpu_torch.utils import roofline as rl

    gs = importlib.import_module("icp4dradar_tpu_torch.ops.gn_step")
    lm = GicpConfig().lm_lambda
    gs.GN_STEP_LAUNCHES = 0
    calls, differ, max_err = 0, [], 0.0
    for n in GN_STEP_FRAMES:
        T, H, g, active, kind = gn_frames(torch, n, lm, seed=n)
        for mask in (active, None):
            Tk, dk = gs.gn_step(T, H, g, lm, mask)
            calls += 1
            Tp, dp = gs.gn_step_plain(T, H, g, lm, mask)
            held = (kind == 2) | ((kind == 1) & (mask is not None))
            bad_T, bad_d = int((Tk != Tp).sum()), int((dk != dp).sum())
            max_err = max(max_err, (Tk - Tp).abs().max().item(), (dk - dp).abs().max().item())
            held_ok = bool(torch.equal(Tk[held], T[held])) and not bool(dk[held].any())
            if bad_T or bad_d or not held_ok:
                differ.append(f"n={n} mask={mask is not None}: T entries {bad_T} of "
                              f"{Tk.numel()} (max {(Tk - Tp).abs().max().item():.3e}), dlt "
                              f"{bad_d} of {n} (max {(dk - dp).abs().max().item():.3e}), held "
                              f"frames {'unchanged' if held_ok else 'moved'}")
    log(f"[gn step] kernel against gn_step_plain at n = {list(GN_STEP_FRAMES)}, with and "
        f"without the mask: " + ("T and dlt equal bit for bit, held frames unchanged"
                                 if not differ else "; ".join(differ)))
    if differ:
        FAILED.append("[gn step] the kernel differs from gn_step_plain")
    if gs.GN_STEP_LAUNCHES != calls:
        raise RuntimeError(f"[gn step] {gs.GN_STEP_LAUNCHES} launches for {calls} calls")

    row = dict(launches=s2m_launches, batch_launches=batch_launches, library_ms=None,
               max_abs_err=max_err)
    reps = 20
    for n in GN_STEP_TIMED:
        T, H, g, active, _ = gn_frames(torch, n, lm, seed=7 * n)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            gs.gn_step(T, H, g, lm, active)
        finally:
            torch.cuda.set_sync_debug_mode("default")

        def kernel():
            for _ in range(reps):
                gs.gn_step(T, H, g, lm, active)

        def plain():
            for _ in range(reps):
                gs.gn_step_plain(T, H, g, lm, active)

        p1, k1, k2, p2 = (time_cuda(torch, f) / reps for f in (plain, kernel, kernel, plain))
        dev_ms = kernel_device_ms(torch, kernel, ("gn_step_kernel",))
        kernels = call_kernels(torch, lambda: gs.gn_step(T, H, g, lm, active))
        check_one_kernel("gn step", kernels, "gn_step_kernel")
        plain_kernels = call_kernels(torch, lambda: gs.gn_step_plain(T, H, g, lm, active))
        plain_launches = (None if plain_kernels is None
                          else sum(max(1, round(c)) for c, _ in plain_kernels.values()))
        bound_ms, bound_by = rl.gn_step_bound(n).bound()
        log(f"[gn step] {n} frames: the call {k1:.4f} / {k2:.4f} ms (device time a launch "
            f"{fmt_ms(dev_ms)}, profiler; no host sync), plain {p1:.4f} / {p2:.4f} ms "
            f"({plain_launches} launches a call); bound {bound_ms:.3e} ms ({bound_by})")
        key = "" if n == 128 else f"n{n}_"
        row.update({f"{key}frames": n, f"{key}ms": (k1 + k2) / 2, f"{key}plain_ms": (p1 + p2) / 2,
                    f"{key}device_ms": dev_ms, f"{key}plain_launches": plain_launches,
                    f"{key}bound_ms": bound_ms, f"{key}bound_by": bound_by})
    return row


def ab_child(tree):
    """Times the K2, K3, K5 and K4 calls of the package in `tree` (this tree
    or the parent commit's) at the path shapes, on inputs made from a seed,
    and prints one JSON line. K2 and K3: 2048 sources against 16,384 rows
    whose first 542 are live (the sector query front-packs them); K5: one
    2048-point frame on a sweep's payload; K4: the s2m block (8 frames of
    2048 sources, one 16,384-row submap, 801 rows live). A tree without
    `nn_search_coords` times K3 through its per-call
    `nearest_neighbor_with_coords` alone. Then the gicp-64 cell end to end
    (phase 7's run: the per-frame kNN-GICP tracker over the bench
    sequence's first TRACK_FRAMES frames), one warm-up and two timed runs."""
    import importlib

    sys.path.insert(0, os.path.abspath(tree))
    import torch

    nn = importlib.import_module("icp4dradar_tpu_torch.ops.knn")
    vf = importlib.import_module("icp4dradar_tpu_torch.ops.vgicp_fused")
    if not nn.__file__.startswith(os.path.abspath(tree)):
        raise RuntimeError(f"[ab] imported {nn.__file__}, not the package in {tree}")
    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    M, live, N, calls = 16384, 542, 2048, 20
    rows = rng.uniform([-60, -60, -2], [60, 60, 4], (live, 3)).astype(np.float32)
    src = (rows[rng.integers(live, size=N)] + rng.normal(0, 0.5, (N, 3))).astype(np.float32)
    tgt = np.zeros((M, 3), np.float32)
    tgt[:live] = rows
    mask = (np.arange(M) < live).astype(np.float32)
    src, tgt, mask = (torch.from_numpy(x).to(dev) for x in (src, tgt, mask))
    res = {"tree": tree, "package": os.path.dirname(nn.__file__)}
    def per_call():
        return nn.nearest_neighbor(src, tgt, mask)

    ops = nn.nn_prepare(tgt, mask)

    def k2():
        return nn.nn_search(src, ops)

    def k3_per_call():
        return nn.nearest_neighbor_with_coords(src, tgt, mask)

    if hasattr(nn, "nn_search_coords"):
        def k3():
            return nn.nn_search_coords(src, ops)
    else:
        k3 = k3_per_call

    # K5: one frame of 2048 sources near 800 voxels, a sweep's payload
    vox = rng.uniform([-40, -40, -2], [40, 40, 3], (800, 3)).astype(np.float32)
    fsrc = (vox[rng.integers(800, size=N)] + rng.normal(0, 0.3, (N, 3))).astype(np.float32)
    vcov = np.zeros((800, 6), np.float32)
    vcov[:, :3] = np.abs(rng.normal(0.05, 0.02, (800, 3))) + 0.01
    fsrc, vox, vcov = (torch.from_numpy(x).to(dev) for x in (fsrc, vox, vcov))
    fsm = torch.ones(N, device=dev)
    scov = vf.radar_point_covariances_packed(fsrc).contiguous()
    T = torch.eye(4, device=dev)
    best = vf.vgicp_iteration(T, fsrc, fsm, scov, vox, vcov, torch.ones(800, device=dev),
                              return_best=True)[5]
    fops = vf.vgicp_prepare(fsrc, fsm, scov, ts=best.shape[2])
    T1 = T.clone()
    T1[:3, 3] = torch.tensor([0.05, -0.03, 0.01], device=dev)

    def k5():
        return vf.vgicp_frozen(T1, fops, best)

    # K4: the s2m block, 8 frames of 2048 sources against one 16,384-row
    # submap whose first 801 rows are live, operands prepared once
    B4, P4, L4 = 8, 16384, 801
    vox4 = rng.uniform([-60, -60, -2], [60, 60, 4], (L4, 3)).astype(np.float32)
    tgt4 = np.zeros((P4, 3), np.float32)
    tgt4[:L4] = vox4
    tcov4 = np.zeros((P4, 6), np.float32)
    tcov4[:, :3] = np.abs(rng.normal(0.05, 0.02, (P4, 3))) + 0.01
    src4 = (vox4[rng.integers(L4, size=(B4, N))] + rng.normal(0, 0.3, (B4, N, 3))
            ).astype(np.float32)
    src4, tgt4, tcov4 = (torch.from_numpy(x).to(dev) for x in (src4, tgt4, tcov4))
    ops4 = vf.vgicp_prepare(src4, torch.ones((B4, N), device=dev),
                            vf.radar_point_covariances_packed(src4).contiguous(), tgt4, tcov4,
                            (torch.arange(P4, device=dev) < L4).float(),
                            tgt_count=torch.tensor(L4, device=dev))
    T4 = torch.eye(4, device=dev).repeat(B4, 1, 1)

    def k4():
        return vf.vgicp_sweep(T4, ops4, _acc_groups=B4)

    def many(fn):
        def run():
            for _ in range(calls):
                fn()
        return run

    fns = (k2, per_call, k3, k3_per_call, k5, k4)
    t = [time_cuda(torch, many(f)) / calls for f in fns + fns[::-1]]
    ms = [(a + b) / 2 for a, b in zip(t[:6], t[::-1][:6])]
    res.update(k2_call_ms=ms[0], k2_per_call_ms=ms[1], k3_call_ms=ms[2],
               k3_per_call_ms=ms[3], k5_call_ms=ms[4], k4_call_ms=ms[5],
               k2_kernels=call_kernels(torch, k2), k3_kernels=call_kernels(torch, k3),
               k5_kernels=call_kernels(torch, k5), k4_kernels=call_kernels(torch, k4))

    from icp4dradar_tpu_torch.config import PipelineConfig
    from icp4dradar_tpu_torch.io import SyntheticSequence
    from icp4dradar_tpu_torch.io.scan import stack_scans
    from icp4dradar_tpu_torch.models import scan_to_map

    seq = SyntheticSequence(
        num_frames=BENCH_FRAMES, max_points=BENCH_POINTS, num_landmarks=5000,
        world_extent=120.0, max_range=80.0, dynamic_fraction=0.1,
        speed=1.0, turn_rate=0.02, seed=0,
    )
    track = stack_scans([seq.scan(k) for k in range(TRACK_FRAMES)]).to(dev)
    gcfg = PipelineConfig().override(**{"gicp.use_vgicp": False})

    def gicp64():
        out = scan_to_map.run_scan_to_map(track, gcfg, use_const_velocity_rot=True)[1]
        torch.cuda.synchronize()
        return out

    gicp64()
    secs = []
    for _ in range(2):
        nn.NN_SEARCH_LAUNCHES = 0
        t0 = time.perf_counter()
        out = gicp64()
        secs.append(time.perf_counter() - t0)
    res.update(gicp64_s=secs, gicp64_iterations=int(out.iterations.sum()),
               gicp64_k2_launches=nn.NN_SEARCH_LAUNCHES,
               gicp64_world_T=out.world_T[-1].cpu().numpy().tolist())
    print(json.dumps(res), flush=True)
    return 0


def phase_ab(parent):
    """A/B of the K2, K3, K5 and K4 calls and of the gicp-64 cell end to end
    against the parent commit's tree (a `git archive` unpacked at
    `parent`), each tree in its own process, in turns: parent, this tree,
    this tree, parent."""
    here = os.path.dirname(os.path.abspath(__file__))
    runs = []
    for tree in (parent, here, here, parent):
        r = subprocess.run([sys.executable, os.path.abspath(__file__), "--ab-tree", tree],
                           capture_output=True, text=True, timeout=600)
        if r.returncode != 0:
            raise RuntimeError(f"[ab] {tree} failed:\n{r.stdout[-2000:]}\n{r.stderr[-4000:]}")
        res = json.loads(r.stdout.strip().splitlines()[-1])
        runs.append(res)
        dev = {k: call_device_ms(res[k] or {})
               for k in ("k2_kernels", "k3_kernels", "k5_kernels", "k4_kernels")}
        log(f"[ab] {'parent' if tree == parent else 'this tree'} ({res['package']}): K2 call "
            f"{res['k2_call_ms']:.4f} ms (per-call nearest_neighbor "
            f"{res['k2_per_call_ms']:.4f} ms), device {dev['k2_kernels']:.4f} ms "
            f"({fmt_kernels(res['k2_kernels'])}); K3 call {res['k3_call_ms']:.4f} ms "
            f"(per-call nearest_neighbor_with_coords {res['k3_per_call_ms']:.4f} ms), device "
            f"{dev['k3_kernels']:.4f} ms ({fmt_kernels(res['k3_kernels'])}); K5 call "
            f"{res['k5_call_ms']:.4f} ms, device {dev['k5_kernels']:.4f} ms "
            f"({fmt_kernels(res['k5_kernels'])}); K4 call (the s2m block, one target "
            f"set) {res['k4_call_ms']:.4f} ms, device {dev['k4_kernels']:.4f} ms "
            f"({fmt_kernels(res['k4_kernels'])}); gicp-64 end to end "
            + " / ".join(f"{TRACK_FRAMES / t:.2f}" for t in res["gicp64_s"])
            + f" scans/s ({res['gicp64_iterations']} GN iterations, "
            f"{res['gicp64_k2_launches']} K2 launches a run)")
    this = [r for r, tree in zip(runs, (parent, here, here, parent)) if tree == here]
    if any(r["gicp64_world_T"] != this[0]["gicp64_world_T"] for r in this):
        raise RuntimeError("[ab] this tree's gicp-64 runs end at different poses")
    return runs


def main(argv) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="a tree of the parent commit: time its K2, K3, K5 "
                                     "and K4 calls and the gicp-64 cell beside this "
                                     "tree's (A/B, phase 12)")
    ap.add_argument("--ab-tree", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.ab_tree:
        return ab_child(args.ab_tree)
    parent = args.parent

    import torch

    card = phase_device(torch)

    from icp4dradar_tpu_torch.io import SyntheticSequence
    from icp4dradar_tpu_torch.io.scan import stack_scans

    phase_build()

    t0 = time.perf_counter()
    seq = SyntheticSequence(
        num_frames=BENCH_FRAMES, max_points=BENCH_POINTS, num_landmarks=5000,
        world_extent=120.0, max_range=80.0, dynamic_fraction=0.1,
        speed=1.0, turn_rate=0.02, seed=0,
    )
    scans = stack_scans([seq.scan(k) for k in range(BENCH_FRAMES)]).to("cuda")
    torch.cuda.synchronize()
    log(f"[data] bench sequence {BENCH_FRAMES} x {BENCH_POINTS} in "
        f"{time.perf_counter() - t0:.2f} s")

    t_start = time.perf_counter()

    def mark(name):
        """The smoke's seconds so far, after each phase (where a trim pays)."""
        log(f"[time] {name} done at {time.perf_counter() - t_start:.1f} s")

    icp = phase_kernel(torch, scans)
    mark("kernel")
    icp_launches, scans_per_s, ate, s2s_out = phase_slice(torch, seq, scans)
    local_map = phase_local_map(torch, scans, s2s_out.world_T.cpu().numpy())
    mark("slice, local map")
    vg_launches, state, out, s2m, s2m_rate, s2m_gn = phase_s2m(torch, seq, scans)
    mark("s2m")
    pg_k1, pg_k4 = phase_pose_graph(torch, card)     # 4c, after 5: the s2m path is warm
    mark("pose graph")
    phase_map_api(torch, state)
    session = phase_session(torch, seq, scans, card)
    mark("map API, session")
    batch = phase_batch(torch, seq, scans, s2m_rate)
    mark("batch")
    vg, sweep_ops = phase_vgicp(torch, state, out, s2m)
    vg_streams = phase_vgicp_streams(torch, batch)
    mark("vgicp")
    (nn_launches, pack_launches), state, out, track = phase_gicp(torch, seq, scans)
    mark("gicp")
    nn, coords_launches, coords, pack, search_ops = phase_knn(torch, state, out, track)
    frozen_launches, state, out, track = phase_inner(torch, seq, scans)
    frozen, frozen_ops = phase_frozen(torch, state, out, track)
    mark("knn, inner, frozen")
    phase_profile(torch, scans, s2m, track, batch)
    phase_syncs(torch, sweep_ops, frozen_ops, search_ops)
    mark("profile, syncs")
    host_k4, host_k1 = phase_host(torch, scans, s2s_out)
    knn_batch, pack_batch = phase_knn_batch(torch, seq, scans)
    mark("host, knn batch")
    phase_parallel(torch, seq, scans, batch, card)
    mark("parallel")
    dist16 = phase_distributed(torch, seq, scans, card)
    mark("distributed")
    acc_k4, acc_k2 = phase_accumulate(torch, seq, scans, card)
    mark("accumulate")
    gn_step = phase_gn_step(torch, s2m_gn, batch["gn_launches"])
    mark("gn step")
    if parent is not None:
        phase_ab(parent)
    if FAILED:
        raise RuntimeError("; ".join(FAILED))

    log(json.dumps({"kernels": [
        {"name": "icp_moments", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": KERNEL_REPLACES, "launches": icp_launches, **icp, **local_map,
         **pg_k1, **host_k1},
        {"name": "vgicp_sweep", "route": "cuda", "source": VGICP_SOURCE,
         "replaces": VGICP_REPLACES, "launches": vg_launches, **vg,
         "batch_launches": batch["launches"], **vg_streams,
         "session_launches": session["session_launches"], **pg_k4, **host_k4,
         "distributed_launches": dist16["k4"], **acc_k4},
        {"name": "nn_search", "route": "cuda", "source": NN_SOURCE,
         "replaces": NN_REPLACES, "launches": nn_launches, **nn, **knn_batch, **acc_k2},
        {"name": "nn_pack", "route": "cuda", "source": NN_SOURCE,
         "replaces": NN_REPLACES, "launches": pack_launches, **pack, **pack_batch},
        {"name": "nn_coords", "route": "cuda", "source": NN_SOURCE,
         "replaces": NN_COORDS_REPLACES, "launches": coords_launches, **coords},
        {"name": "vgicp_frozen", "route": "cuda", "source": VGICP_SOURCE,
         "replaces": FROZEN_REPLACES, "launches": frozen_launches, **frozen,
         "distributed_launches": dist16["k5"]},
        {"name": "gn_step", "route": "cuda", "source": GN_STEP_SOURCE,
         "replaces": GN_STEP_REPLACES, **gn_step},
    ]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
