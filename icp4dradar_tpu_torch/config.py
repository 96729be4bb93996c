"""Typed configuration tree for the whole engine (PyTorch port).

A copy of `icp4dradar_tpu/config.py`, which is numpy-free and jax-free but
cannot be imported without running `icp4dradar_tpu/__init__.py` (which
imports jax). Defaults must stay identical to the JAX package's; the
parity test `tests/test_torch_config.py` compares the two `to_dict()`s.

Replaces the reference's three config mechanisms with one dataclass tree
(ROS launch params `launch/radar_odometry.launch:5-14`, compile-time
`#define` forks `src/iterative_closest_point.cpp:28-33`, and the hard-coded
REVE config struct `src/radar_odometry.cpp:574-611`). All values default to
the reference's behavioral constants so a default-constructed config
reproduces the reference pipeline semantics.

Configs are plain frozen dataclasses, hashable and immutable.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple


@dataclass(frozen=True)
class DopplerRansacConfig:
    """Doppler sine-model RANSAC (ref `fitSineRansac`,
    src/iterative_closest_point.cpp:85-128).

    Model: v_r * cos(beta) = A * cos(alpha + b). The reference draws
    0.2*N sequential 2-point hypotheses (:389); here hypotheses are a fixed
    batch scored in one shot on the VPU/MXU.
    """

    num_hypotheses: int = 256          # ref: 0.2*N sequential iterations (:389)
    inlier_sigma: float = 0.5          # ref sigma=0.5 (:89)
    static_threshold: float = 0.2      # ref delta > 0.2 -> dynamic (:396)
    refine_iters: int = 2              # IRLS polish rounds (0 = raw 2-pt fit)
    # The reference's split is one-sided (only delta > +0.2 is dynamic,
    # :394-403). Keep that quirk by default for behavioral parity.
    two_sided_split: bool = False


@dataclass(frozen=True)
class ReveConfig:
    """REVE-style radar ego-velocity estimator gates (ref config_init,
    src/radar_odometry.cpp:574-611)."""

    min_dist: float = 0.25
    max_dist: float = 100.0
    min_db: float = 0.0
    elevation_thresh_deg: float = 60.0
    azimuth_thresh_deg: float = 60.0
    filter_min_z: float = -3.0
    filter_max_z: float = 3.0
    doppler_velocity_correction_factor: float = 1.0
    thresh_zero_velocity: float = 0.05
    allowed_outlier_percentage: float = 0.25
    sigma_zero_velocity_x: float = 0.025
    sigma_zero_velocity_y: float = 0.025
    sigma_zero_velocity_z: float = 0.025
    max_sigma_x: float = 0.2
    max_sigma_y: float = 0.2
    max_sigma_z: float = 0.2
    max_r_cond: float = 1000.0
    use_ransac: bool = True
    outlier_prob: float = 0.4
    success_prob: float = 0.9999
    n_ransac_points: int = 3
    inlier_thresh: float = 0.15
    sigma_v_d: float = 0.125

    @property
    def ransac_iterations(self) -> int:
        """Iteration count from (outlier_prob, success_prob, N_ransac_points),
        the standard RANSAC trial formula REVE uses."""
        import math

        denom = math.log(1.0 - (1.0 - self.outlier_prob) ** self.n_ransac_points)
        return max(1, int(math.ceil(math.log(1.0 - self.success_prob) / denom)))


@dataclass(frozen=True)
class IcpConfig:
    """Point-to-point ICP (ref pcl::IterativeClosestPoint usage,
    src/iterative_closest_point.cpp:508-521; PCL defaults apply since the
    reference sets nothing: max 10 iterations, no correspondence gating)."""

    max_iterations: int = 10            # PCL default (setMaximumIterations commented, :513)
    max_correspondence_dist: float = 1e8  # PCL default: effectively ungated
    # Convergence epsilon on sum|xi| of the 6-dim incremental twist. PCL's
    # default is 0.0 (all 10 iterations always run); ours is 1e-3 — the
    # frame-parallel batch iterates in lockstep, so the whole batch exits
    # once EVERY pair's step is sub-millimeter. On the 1024-frame bench
    # sequence the JAX package measured ATE 1.9761 -> 1.9764 m for this
    # change (identical to noise). Set 0.0 for bit-level PCL parity; 1e-2
    # costs +1% ATE.
    transformation_epsilon: float = 1e-3
    fitness_epsilon: float = -1.0         # disabled, like PCL default


@dataclass(frozen=True)
class GicpConfig:
    """GICP scan-to-submap registration (ref FastGICPSingleThread usage,
    src/radar_odometry.cpp:399-411)."""

    k_correspondences: int = 5       # ref setCorrespondenceRandomness(5) (:404)
    max_iterations: int = 64         # FastGICP default
    max_correspondence_dist: float = 2.0  # ref MAX_SEARCH_RADIUS (:35)
    # GN convergence: sum|xi| over the 6-dim step (NOT PCL's matrix delta).
    # Governs the kNN GICP fallback path (gicp.py).
    transformation_epsilon: float = 1e-4
    # VGICP map-tracking epsilon, measured separately in the JAX package:
    # 5e-4 converges in ~4 sweeps vs ~5 at 1e-4 with IDENTICAL ATE (0.022 m / 64-frame
    # synthetic) — sub-millimeter steps don't move radar-scale registration.
    # Kept as its own knob so loosening it never silently changes the
    # unmeasured kNN GICP path.
    vgicp_transformation_epsilon: float = 5e-4
    cov_epsilon: float = 1e-3        # plane-regularized covariance floor (GICP standard)
    lm_lambda: float = 1e-6          # Levenberg damping on the 6x6 system
    # VGICP map-tracking path (registration/vgicp.py): register against the
    # voxel distribution map with measurement-model scan covariances —
    # the fused kernel formulation. False falls back to kNN GICP (gicp.py).
    use_vgicp: bool = True
    # sweep-free GN steps between NN re-association sweeps (0 = re-associate
    # every iteration, the FastGICP behavior). 1 needs ~the same sweep
    # count in the JAX package's measurements and costs ~10% ATE — kept as
    # an option for large-submap configs where the sweep dominates.
    inner_gn_steps: int = 0
    sigma_range: float = 0.1         # radar radial std [m]
    sigma_azimuth: float = 0.01      # radar azimuth std [rad]
    sigma_elevation: float = 0.02    # radar elevation std [rad]
    # kNN GICP path only: source the submap's covariance neighborhoods from
    # the EXACT whole-map k-NN (mapping.voxel_map_knn_exact — the kd-tree
    # Nearest_Search semantics, ikd_Tree.cpp:368-398, with the
    # MAX_SEARCH_RADIUS=2.0 gate) instead of k-NN within the compacted
    # sector submap. Default False is the reference-faithful behavior:
    # fast_gicp computes target covariances over exactly the submap cloud
    # it aligns against (src/radar_odometry.cpp:399-406), and the sector
    # query already returns every in-sector voxel, so submap-local k-NN
    # sees the same neighborhoods except at sector edges. True removes
    # that edge effect at the cost of a whole-map chunked-gather sweep.
    use_exact_map_knn: bool = False


@dataclass(frozen=True)
class TrackingConfig:
    """Tracking-health gates for scan-to-map odometry.

    No reference counterpart: the reference composes every GICP result
    blindly (src/radar_odometry.cpp:411-412), so one failed registration
    both corrupts the pose AND inserts misplaced points into the map,
    making recovery impossible. These gates reject corrections that are
    implausible against the motion prior; rejected frames keep the
    predicted pose and are NOT inserted. Set all gates to inf for
    reference-parity blind composition (s2s_max_fitness already defaults
    to inf; scan-to-scan parity additionally needs the two correction
    gates inf).

    Defaults measured on a 512-frame sparse-world run (JAX package): healthy
    tracking has fitness 0.001-0.05 and sub-0.1 m corrections, while a
    degenerate-geometry walk-off shows fitness ~2 and a 28 m jump in one
    frame; gating turned that run's ATE from 241 m into 0.24 m."""

    max_fitness: float = 1.0                # accept only fitness below this
    max_correction_t: float = 5.0           # [m] translation vs prediction
    max_correction_rot_deg: float = 25.0    # [deg] rotation vs prediction
    # scan-to-scan fitness gate. P2P ICP fitness is the UNGATED mean d^2
    # over all points (PCL getFitnessScore semantics) — partially
    # overlapping 1k-point scans sit at ~1.8 even when healthy, a
    # completely different scale from VGICP's gated 0.001-0.05, and a
    # displaced-scan walk-off can have NEAR-ZERO fitness (perfect
    # alignment, wrong place). Fitness is therefore not a useful s2s
    # health signal: default off; the correction-vs-Doppler-prior gates
    # above carry the rejection (models/scan_to_scan.py::_gate_relative).
    s2s_max_fitness: float = float("inf")
    # scan-to-scan suspect-PAIR detector: ICP fitness (ungated mean d^2)
    # beyond this marks the pair corrupt (sensor glitch / interference
    # burst — a structureless cloud cannot align onto a structured one).
    # Suspect pairs get their delta replaced by the last ACCEPTED pair's
    # delta (motion hold), NOT by the Doppler prior: a corrupt frame
    # corrupts its own velocity estimate, so the prior is no safer than
    # the ICP result it would replace (measured r4: prior-fallback gating
    # made a corrupted-frame 512-run WORSE than blind, 28.3 m vs 20.6 m;
    # motion hold contains it). Separation is wide: healthy pairs measure
    # 0.03-2 across the scenario grid (including 35% dynamics), pairs
    # touching a structureless frame 33-1000+. This composes with the
    # correction gates above: fitness breach -> trust nothing from the
    # pair (motion hold); fitness fine but correction implausible ->
    # scans are structured, the Doppler prior is credible (prior
    # fallback). inf disables (reference parity).
    s2s_suspect_fitness: float = 25.0


@dataclass(frozen=True)
class VoxelMapConfig:
    """Device-resident voxel-hash map (replaces ikd-Tree,
    third_party/ikd-Tree/ikd_Tree.{h,cpp}; semantics: keep the point nearest
    the voxel center per 0.5 m voxel, ikd_Tree.cpp:422-497)."""

    voxel_size: float = 0.5           # ref set_downsample_param(0.5), radar_odometry.cpp:348
    capacity: int = 1 << 18           # hash table slots (voxels)
    # linear-probe bound: at <15% load factor probe chains are short, and
    # each extra probe round costs another capacity-sized scatter
    max_probes: int = 8
    submap_max_points: int = 1 << 14  # fixed-size sector-query output
    sector_radius: float = 80.0       # ref RADAR_RADIUS (radar_odometry.cpp:36)
    sector_half_angle_deg: float = 60.0  # ref ikd_Tree.cpp:1114-1117 heading window
    # long-run memory maintenance: tombstone voxels farther than this from
    # the vehicle (inf = never forget, matching the reference, whose map
    # also grows without bound). Queries only ever reach sector_radius, so
    # anything comfortably beyond it is dead weight in the hash table.
    forget_radius: float = float("inf")
    # rehash (rebuild the table from live voxels) once tombstoned slots
    # exceed this fraction of capacity — tombstones keep their keys to
    # preserve probe chains, so without rehashing a long forgetful run
    # permanently consumes slots and new territory stops inserting
    rehash_tombstone_fraction: float = 0.1
    # distributed pipeline only: per-shard sector-query rows are
    # slack * submap_max_points / n_devices. Voxels hash-distribute
    # ~uniformly but not exactly, so at quota saturation a hot shard
    # truncates while others have slack (measured 0.39 -> 0.88 m ATE at a
    # fully saturated budget, tests/test_distributed_pipeline.py). slack=2
    # absorbs the imbalance — and keeps MORE total sector rows than the
    # single-device global budget at saturation — at proportionally more
    # ring-sweep work per frame.
    shard_quota_slack: float = 1.0
    # voxel-Gaussian fallback: voxels with fewer than stats_min_count
    # routed points register with an isotropic stats_fallback_var
    # covariance instead of their (rank-deficient) sample covariance.
    # Sparse noisy vendors (ti_mmwave: ~41 pts/scan, 1 deg angular noise)
    # should RAISE the fallback toward the true point-placement variance —
    # an overconfident thin-voxel map biases the Mahalanobis GN (r5).
    stats_min_count: float = 3.0
    stats_fallback_var: float = 0.01
    # blocked runners only: unique-voxel budget per multi-frame batch
    # insert. Scatter time scales linearly with update rows in the JAX
    # package's measurements, so compacting the deduped leaders to a fixed budget makes the block insert pay for the
    # voxels it actually touches — consecutive scans revisit mostly the
    # same voxels, so leaders ~ unique voxels ~ one scan's worth, not
    # block * scan. Overflow leaders drop for ONE block (hash-order
    # unbiased; later overlapping blocks re-insert). 0 disables.
    block_insert_leader_budget: int = 4096


@dataclass(frozen=True)
class SubmapConfig:
    """Scan-accumulating submap assembly (ref
    src/iterative_closest_point.cpp:577-633)."""

    scans_per_submap: int = 20        # ref submap_cnt == 20 (:590)


@dataclass(frozen=True)
class PoseGraphConfig:
    """Keyframe pose-graph Gauss-Newton back-end (activates the factors the
    reference left dormant, include/radarFactor.hpp:11-171)."""

    max_iterations: int = 10
    damping: float = 1e-6
    huber_delta: float = 1.0
    convergence_eps: float = 1e-8
    # scan-to-map front-end block for run_pose_graph_odometry: amortizes
    # sector query + insert over this many frames (run_scan_to_map_blocked).
    # F must satisfy F > block and F % block == 0 or the front end warns and
    # falls back to the slower per-frame path; 0/1 disables blocking.
    front_end_block: int = 8


@dataclass(frozen=True)
class StructureFactorConfig:
    """Keyframe-to-map line/plane factor mining (graph/structure_factors.py):
    the correspondence-production stage the reference's dormant edge/plane
    functors (include/radarFactor.hpp:11-137) never got."""

    plane_ratio: float = 0.25      # lam0 < ratio * lam1  -> surfel cell
    line_ratio: float = 0.25       # lam1 < ratio * lam2  -> edge cell
    min_voxel_points: float = 6.0  # spectrum of fewer points is noise
    max_dist: float = 2.0          # gate vs Gaussian mean (MAX_SEARCH_RADIUS)
    sigma0: float = 0.1            # sensor noise floor [m] in factor weights
    weight_scale: float = 0.1      # global balance vs between-factors
    points_per_keyframe: int = 256 # factor budget per keyframe
    # blob cells produce point-to-point factors against voxel means, which
    # carry ~voxel-size quantization bias; the reference's feature lineage
    # (A-LOAM) discards non-edge/non-surf points — measured here to slightly
    # hurt ATE, so off by default
    use_point_factors: bool = False
    # mine -> optimize -> re-mine at refined poses: re-association rounds
    # (measured: round 2 takes the structured-scene ATE from -44% to -59%)
    rounds: int = 2


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh / sharding layout (no reference counterpart; the reference
    is single-process — SURVEY.md section 2 parallelism call-out)."""

    data_axis: str = "dp"             # scans / factors / residual blocks
    map_axis: str = "map"             # spatial map shards


@dataclass(frozen=True)
class PipelineConfig:
    """Top-level engine config."""

    max_points: int = 4096            # padded per-scan point budget
    dtype: str = "float32"
    seed: int = 0
    # sparse-vendor mitigation (scan-to-map, per-frame runner): register
    # each frame on the union of the current scan and the previous
    # (accumulate_scans - 1) scans, re-expressed in the current predicted
    # frame through their REFINED world poses. Single-chip TI-class radars
    # (ti_mmwave profile: ~41 pts/scan) underconstrain the 6-DoF GN; k=4
    # quadruples the constraint count at zero sensor cost. Past scans are
    # used for REGISTRATION only (they already inserted at their own
    # frames); 1 disables (default — dense vendors don't need it).
    accumulate_scans: int = 1
    doppler: DopplerRansacConfig = field(default_factory=DopplerRansacConfig)
    reve: ReveConfig = field(default_factory=ReveConfig)
    icp: IcpConfig = field(default_factory=IcpConfig)
    gicp: GicpConfig = field(default_factory=GicpConfig)
    tracking: TrackingConfig = field(default_factory=TrackingConfig)
    voxel_map: VoxelMapConfig = field(default_factory=VoxelMapConfig)
    submap: SubmapConfig = field(default_factory=SubmapConfig)
    pose_graph: PoseGraphConfig = field(default_factory=PoseGraphConfig)
    structure: StructureFactorConfig = field(
        default_factory=StructureFactorConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    # ------------------------------------------------------------------
    # (De)serialization — YAML-free JSON round trip, CLI override support.
    # ------------------------------------------------------------------
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    @classmethod
    def from_dict(cls, d: dict) -> "PipelineConfig":
        return _from_dict(cls, d)

    @classmethod
    def from_json(cls, s: str) -> "PipelineConfig":
        return cls.from_dict(json.loads(s))

    def override(self, **kv: Any) -> "PipelineConfig":
        """Dotted-path overrides: cfg.override(**{"icp.max_iterations": 30})."""
        d = self.to_dict()
        for key, value in kv.items():
            node = d
            parts = key.split(".")
            for p in parts[:-1]:
                node = node[p]
            if parts[-1] not in node:
                raise KeyError(f"unknown config key: {key}")
            node[parts[-1]] = value
        return type(self).from_dict(d)


def _from_dict(cls, d):
    if not dataclasses.is_dataclass(cls):
        return d
    kwargs = {}
    hints = {f.name: f for f in dataclasses.fields(cls)}
    for name, value in d.items():
        if name not in hints:
            raise KeyError(f"unknown config field {cls.__name__}.{name}")
        f = hints[name]
        sub = f.type if isinstance(f.type, type) else None
        if sub is None:
            # dataclass fields carry string annotations under
            # `from __future__ import annotations`; resolve from globals.
            sub = globals().get(str(f.type).strip("'\""), None)
        if sub is not None and dataclasses.is_dataclass(sub) and isinstance(value, dict):
            kwargs[name] = _from_dict(sub, value)
        else:
            kwargs[name] = value
    return cls(**kwargs)
