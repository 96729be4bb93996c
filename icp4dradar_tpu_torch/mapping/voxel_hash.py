"""Voxel-hash incremental map: flat tensors + scatter arbitration, no
pointers (PyTorch port of `icp4dradar_tpu/mapping/voxel_hash.py`).

Replaces the reference's pthread ikd-Tree (third_party/ikd-Tree/
ikd_Tree.{h,cpp}) with an open-addressing hash grid:

- on-insert voxel downsampling keeping the point nearest the voxel center
  (`Add_Points` downsample path, ikd_Tree.cpp:422-497; 0.5 m leaf,
  src/radar_odometry.cpp:348), plus an incremental Gaussian per voxel over
  every point ever routed to it (the VGICP distribution map);
- the heading-sector search (ikd_Tree.cpp:1114-1117; 80 m, +-60 deg,
  src/radar_odometry.cpp:392-396) that also emits each voxel's Gaussian.

Insertion dedupes the batch per voxel with one lexicographic sort
((stream,) hash, voxel coords, center distance), segment-sums the batch's moments onto each
run's leader, then resolves each leader to a slot in probe rounds that look
at a window of W=4 slots at once; claims on an empty slot arbitrate by a
scatter-min on the row index. Payload writes and moment deposits happen
once after the rounds. The JAX package's `lax.while_loop` over rounds is a
Python loop here with one host sync per round (`any(alive)`); typical
batches resolve in 1-2 rounds.

Tables carry two extra rows internally while inserting: row S*C (C for a
single table) reads as empty (the JAX gathers' `mode="fill"`), row S*C+1
absorbs dropped writes (`mode="drop"`).

Lookups and k-NN on the map (the kNN-GICP path's exact whole-map
neighbourhoods): `voxel_map_lookup_slots`, `voxel_map_stencil_neighbors`,
`voxel_map_knn` and `voxel_map_knn_exact`, whose `lax.while_loop` over
pre-sorted offset chunks is a Python loop here with one host check per
chunk.

Forgetting (`voxel_map_forget_far`: tombstones that keep their keys) and
the rebuild that reclaims tombstoned slots (`voxel_map_rehash`,
`voxel_map_maybe_rehash`).

The ikd-Tree-style edits and queries, on a single table: radius and box
searches (`Radius_Search`, `Box_Search`, ikd_Tree.cpp:401-414), box and
point deletes (`Delete_by_range`, `Delete_Points`, ikd_Tree.cpp:522-564,
656-718; tombstones, as forgetting makes them), the box delete that hands
back what it removed (`acquire_removed_points`, :567-581) and the box
re-add that revives tombstones (`Add_by_range`, :500-519). They are masked
selections and writes, equal to the JAX functions bit for bit.

A batched map (`voxel_map_create(..., streams=S)`) holds one private table
per stream in (S, C, ...) tensors, the JAX package's vmapped layout: insert,
the sector queries, forget and rehash take a leading stream axis and run
every stream in the same launches; stream s of each equals the single-table
call on table s, bit for bit. The lookups, the k-NN and the ikd-Tree-style
edits and queries take single tables.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from icp4dradar_tpu_torch.ops.compaction import mask_compact
from icp4dradar_tpu_torch.ops.knn import k_smallest
from icp4dradar_tpu_torch.utils import profiling

_P1, _P2, _P3 = 73856093, 19349669, 83492791  # classic spatial-hash primes
_EMPTY = 0x7FFFFFFF


@dataclass(frozen=True)
class VoxelHashMap:
    """One point per voxel, open-addressed. All tensors lead with C
    (capacity); a batched map (one private table per stream, serving)
    leads with (S, C), the layout of the JAX package's vmapped map.

    Besides the representative point (keep-nearest-center, ikd-Tree
    semantics), every voxel keeps an incremental Gaussian over ALL points
    ever routed to it (count / sum / packed second moment)."""

    keys: torch.Tensor        # ([S,] C, 3) int32 voxel coords of occupant
    points: torch.Tensor      # ([S,] C, 3) f32 stored point (nearest voxel center)
    intensity: torch.Tensor   # ([S,] C) f32
    occupied: torch.Tensor    # ([S,] C) f32 {0, 1}
    stat_n: torch.Tensor      # ([S,] C) f32 point count
    stat_sum: torch.Tensor    # ([S,] C, 3) f32 sum of points
    stat_sq: torch.Tensor     # ([S,] C, 6) f32 sum of [xx,yy,zz,xy,xz,yz]
    voxel_size: float = 0.5
    max_probes: int = 8

    @property
    def capacity(self) -> int:
        return self.keys.shape[-2]

    @property
    def streams(self) -> Optional[int]:
        """S for a batched map, None for a single table."""
        return self.keys.shape[0] if self.keys.dim() == 3 else None

    @property
    def num_voxels(self) -> torch.Tensor:
        """() occupied slots, or (S,) per stream."""
        return torch.sum(self.occupied, dim=-1)

    def replace(self, **fields) -> "VoxelHashMap":
        return dataclasses.replace(self, **fields)

    def tables(self) -> Tuple[torch.Tensor, ...]:
        return tuple(getattr(self, f) for f in _TABLES)

    def with_tables(self, tables) -> "VoxelHashMap":
        return self.replace(**dict(zip(_TABLES, tables)))

    def stream(self, s) -> "VoxelHashMap":
        """Stream s's table (a view), or the streams of an index tensor s."""
        return self.with_tables(t[s] for t in self.tables())


_TABLES = ("keys", "points", "intensity", "occupied", "stat_n", "stat_sum", "stat_sq")


def voxel_map_create(
    capacity: int = 1 << 18, voxel_size: float = 0.5, max_probes: int = 8,
    dtype=torch.float32, device="cuda", streams: Optional[int] = None,
) -> VoxelHashMap:
    """An empty map; with `streams` = S, S private tables in one batched map
    ((S, C, ...) tensors)."""
    if capacity & (capacity - 1):
        raise ValueError("capacity must be a power of two")
    lead = () if streams is None else (int(streams),)

    def zeros(*shape):
        return torch.zeros(lead + shape, dtype=dtype, device=device)

    return VoxelHashMap(
        keys=torch.full(lead + (capacity, 3), _EMPTY, dtype=torch.int32, device=device),
        points=zeros(capacity, 3), intensity=zeros(capacity),
        occupied=zeros(capacity), stat_n=zeros(capacity),
        stat_sum=zeros(capacity, 3), stat_sq=zeros(capacity, 6),
        voxel_size=voxel_size, max_probes=max_probes,
    )


def _batched(vmap: VoxelHashMap, *tensors):
    """The map and its per-call tensors with a leading stream axis (added
    for a single table), and a function that undoes it on a result map."""
    if vmap.streams is not None:
        return (vmap,) + tensors + (lambda m: m,)
    one = vmap.with_tables(t[None] for t in vmap.tables())
    return (one,) + tuple(None if x is None else x[None] for x in tensors) + (
        lambda m: m.with_tables(t[0] for t in m.tables()),)


def _voxel_coords(xyz: torch.Tensor, voxel_size: float) -> torch.Tensor:
    return torch.floor(xyz / voxel_size).to(torch.int32)


def _hash(coords: torch.Tensor, capacity: int) -> torch.Tensor:
    """(x*P1) ^ (y*P2) ^ (z*P3) & (C-1) on the int32 coords. JAX multiplies
    in wrapping int32; the products here are int64, whose low 32 bits are
    the wrapped ones, and the mask keeps only low bits."""
    c = coords.to(torch.int64)
    h = (c[..., 0] * _P1) ^ (c[..., 1] * _P2) ^ (c[..., 2] * _P3)
    return (h & (capacity - 1)).to(torch.int32)


def _center_dist2(xyz: torch.Tensor, coords: torch.Tensor, voxel_size: float) -> torch.Tensor:
    d = xyz - (coords.to(xyz.dtype) + 0.5) * voxel_size
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]


def _lexsort_perm(keys) -> torch.Tensor:
    """Permutation that sorts rows lexicographically by `keys` (first key
    most significant), ties in original order: stable sorts from the last
    key to the first (torch has no multi-key sort)."""
    perm = torch.arange(keys[0].shape[0], device=keys[0].device)
    for k in reversed(keys):
        perm = perm[torch.sort(k[perm], stable=True).indices]
    return perm


def _reverse_segment_sum(values: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """Inclusive right-to-left segmented sum of (n, k) `values` over runs of
    equal `seg` ids (consecutive): each row gets the sum of its run from
    itself to the run's end, so the run total lands on its first row.
    Hillis-Steele doubling, ceil(log2 n) steps, no atomics: deterministic on
    every device. Never a difference of cumsums, which cancels in f32 at
    world-scale second moments."""
    n = values.shape[0]
    out = values
    shift = 1
    while shift < n:
        same = (seg[shift:] == seg[:-shift]).to(values.dtype)[:, None]
        tail = out[shift:] * same
        out = torch.cat([out[:-shift] + tail, out[-shift:]])
        shift *= 2
    return out


def voxel_map_insert(
    vmap: VoxelHashMap,
    xyz: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    intensity: Optional[torch.Tensor] = None,
    leader_budget: Optional[int] = None,
) -> VoxelHashMap:
    """Insert a padded batch of points (N, 3) with keep-nearest-center
    downsampling; returns the new map (the input map is not modified). A
    batched map takes (S, N, 3) / (S, N) / (S, N), stream s into table s.

    Per voxel, the stored point afterwards is the one nearest the voxel
    center among {previous occupant} U {batch points in that voxel}
    (ikd_Tree.cpp:442-455); every routed point adds to the voxel's
    Gaussian. Points that cannot be placed within max_probes probes are
    dropped. `leader_budget`: cap on distinct voxels per batch (per stream);
    overflow leaders (in hash order) are dropped for this batch.

    All streams run in one pass: the stream is the most significant sort
    key, stream s's slots are offset by s*C and its probes stay in its own
    range, and one `any(alive)` host read per probe round serves them all.
    Stream s of a batched insert equals the single-table insert on table s,
    bit for bit."""
    if mask is None:
        mask = torch.ones(xyz.shape[:-1], dtype=xyz.dtype, device=xyz.device)
    if intensity is None:
        intensity = torch.zeros(xyz.shape[:-1], dtype=xyz.dtype, device=xyz.device)
    vmap, xyz, mask, intensity, unbatch = _batched(vmap, xyz, mask, intensity)
    S, n = xyz.shape[:2]
    dev, ft = xyz.device, xyz.dtype
    C = vmap.capacity
    SC = S * C                                   # sentinel slot: unplaced
    L = vmap.voxel_size
    big = 1e30

    valid = mask > 0.5
    xyz = torch.where(valid[..., None], xyz, 0.0)    # padded rows may be junk
    intensity = torch.where(valid, intensity, 0.0)
    coords = _voxel_coords(xyz, L)
    h0 = _hash(coords, C)
    d2c = _center_dist2(xyz, coords, L)

    # ---- phase 1: one lexicographic sort dedupes the batch per voxel.
    # (stream, hash, voxel coords, center distance), original index
    # breaking ties; invalid rows carry the out-of-range hash C and sort
    # last in their stream. Stream and hash share one key, s*(C+1) + h.
    h_key = torch.where(valid, h0, C)
    sh_key = h_key if S == 1 else (
        h_key.long() + torch.arange(S, device=dev)[:, None] * (C + 1))
    c_key = torch.where(valid[..., None], coords, _EMPTY).reshape(S * n, 3)
    d_key = torch.where(valid, d2c, big).reshape(-1)
    perm = _lexsort_perm([sh_key.reshape(-1), c_key[:, 0], c_key[:, 1], c_key[:, 2], d_key])
    sh_s, h_s, c_s, d_s = sh_key.reshape(-1)[perm], h_key.reshape(-1)[perm], c_key[perm], \
        d_key[perm]
    st = (perm // n).to(torch.int32)              # each sorted row's stream
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    payload = torch.stack(
        [x, y, z, intensity, valid.to(ft), x * x, y * y, z * z, x * y, x * z, y * z],
        dim=-1).reshape(S * n, 11)[perm]         # (S*N, 11)
    xyz_s, int_s = payload[:, :3], payload[:, 3]

    # run leaders: first row of each (stream, hash, coords) run = the
    # per-voxel winner (min center distance, then lowest original index)
    prev_differs = (sh_s[1:] != sh_s[:-1]) | torch.any(c_s[1:] != c_s[:-1], dim=-1)
    leader = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), prev_differs])
    # moments [count, sum3, sq6] summed over each run onto its leader
    moments = torch.cat([payload[:, 4:5], payload[:, :3], payload[:, 5:]], dim=-1)
    seg = _reverse_segment_sum(moments, torch.cumsum(leader.to(torch.int32), 0))
    alive0 = leader & (h_s < C)

    if leader_budget is not None and leader_budget < n:
        # compact each stream's leaders to the budget: every later scatter
        # and gather pays O(budget) rows; coordinates stay int, so bit-exact
        Lb = int(leader_budget)
        fpay = torch.cat([xyz_s, int_s[:, None], d_s[:, None], seg], dim=-1)
        fcomp, cmask, _ = mask_compact(fpay.reshape(S, n, 15), alive0.to(ft).reshape(S, n), Lb)
        icomp, _, _ = mask_compact(torch.cat([c_s, h_s[:, None]], dim=-1).reshape(S, n, 4),
                                   alive0.to(torch.int32).reshape(S, n), Lb)
        fcomp, icomp = fcomp.reshape(S * Lb, 15), icomp.reshape(S * Lb, 4)
        xyz_s, int_s, d_s, seg = fcomp[:, :3], fcomp[:, 3], fcomp[:, 4], fcomp[:, 5:]
        c_s, h_s = icomp[:, :3], icomp[:, 3]
        alive0 = cmask.reshape(-1) > 0.5
        st = torch.arange(S, dtype=torch.int32, device=dev).repeat_interleave(Lb)
        n = Lb
    R = S * n
    base_s = st * C                               # the stream's first slot

    # ---- phase 2: probe rounds resolve each leader to its final slot:
    # its voxel's slot, or the first empty slot of its chain (claims race
    # by a scatter-min on the row index; losers re-probe from there).
    iota = torch.arange(R, dtype=torch.int32, device=dev)
    W = min(4, vmap.max_probes)
    w_iota = torch.arange(W, dtype=torch.int32, device=dev)
    mp = vmap.max_probes
    # row SC reads as empty, row SC + 1 absorbs dropped writes
    keysT = torch.cat([vmap.keys.reshape(SC, 3),
                       torch.full((2, 3), _EMPTY, dtype=torch.int32, device=dev)])
    r_slot = torch.full((R,), SC, dtype=torch.int32, device=dev)
    same = torch.zeros(R, dtype=torch.bool, device=dev)
    offset = torch.zeros(R, dtype=torch.int32, device=dev)
    alive = alive0
    rnd = 0
    while True:
        base = h_s + offset
        slots = ((base[:, None] + w_iota[None, :]) & (C - 1)) + base_s[:, None]  # (R, W)
        gk = keysT[torch.where(alive[:, None], slots, SC).long()]               # (R, W, 3)
        valid_w = (offset[:, None] + w_iota[None, :]) < mp
        used = gk[..., 0] != _EMPTY
        match = torch.all(gk == c_s[:, None, :], dim=-1) & used & valid_w
        empty = ~used & valid_w
        matchpos = torch.amin(torch.where(match, w_iota, W), dim=1)
        emptypos = torch.amin(torch.where(empty, w_iota, W), dim=1)
        # a match anywhere in the window wins (an empty slot never precedes
        # a voxel's slot in its chain)
        same_r = alive & (matchpos < W)
        wants_claim = alive & ~same_r & (emptypos < W)
        e_slot = ((base + emptypos) & (C - 1)) + base_s
        claim_idx = torch.where(wants_claim, e_slot, SC).long()
        cbuf = torch.full((SC + 1,), R, dtype=torch.int32, device=dev)
        cbuf.scatter_reduce_(0, claim_idx, torch.where(wants_claim, iota, R),
                             reduce="amin")
        claim_win = wants_claim & (cbuf[claim_idx] == iota)
        keysT[torch.where(claim_win, e_slot, SC + 1).long()] = c_s
        slot_res = torch.where(same_r, ((base + matchpos) & (C - 1)) + base_s, e_slot)
        resolved = same_r | claim_win
        r_slot = torch.where(resolved, slot_res, r_slot)
        same = same | same_r
        offset = offset + torch.where(wants_claim & ~claim_win, emptypos, W)
        alive = alive & ~resolved & (offset < mp)
        rnd += 1
        # backstop only: claim losers progress every round
        if rnd >= 2 * mp:
            break
        profiling.count("host_syncs")
        if not bool(alive.any()):
            break

    # ---- phase 3: payload writes and moment deposits, once.
    # Same-voxel competition: nearest-to-center wins against the incumbent;
    # claims always win. Every resolved leader deposits its run's moments.
    placed = r_slot < SC
    r_idx = r_slot.long()
    repT = torch.cat([torch.cat([vmap.points.reshape(SC, 3), vmap.intensity.reshape(SC, 1),
                                 vmap.occupied.reshape(SC, 1)], dim=-1),
                      torch.zeros((1, 5), dtype=ft, device=dev)])
    grep = repT[r_idx]                                 # row SC reads zeros
    incumbent = (grep[:, 4] > 0.5) & same
    inc_d2c = torch.where(incumbent, _center_dist2(grep[:, :3], c_s, L), big)
    win = (d_s < inc_d2c) & placed
    rep_new = torch.cat([xyz_s, int_s[:, None], torch.ones((R, 1), dtype=ft, device=dev)],
                        dim=-1)
    repT[torch.where(win, r_slot, SC).long()] = rep_new
    statsT = torch.cat([torch.cat([vmap.stat_n.reshape(SC, 1), vmap.stat_sum.reshape(SC, 3),
                                   vmap.stat_sq.reshape(SC, 6)], dim=-1),
                        torch.zeros((1, 10), dtype=ft, device=dev)])
    # resolved leaders hold distinct slots, so no two rows add to one slot
    # (unresolved rows all add into the dropped row SC): deterministic
    statsT.index_add_(0, r_idx, seg)
    return unbatch(vmap.replace(
        keys=keysT[:SC].reshape(S, C, 3).contiguous(), points=repT[:SC, :3].reshape(S, C, 3).contiguous(),
        intensity=repT[:SC, 3].reshape(S, C).contiguous(), occupied=repT[:SC, 4].reshape(S, C).contiguous(),
        stat_n=statsT[:SC, 0].reshape(S, C).contiguous(), stat_sum=statsT[:SC, 1:4].reshape(S, C, 3).contiguous(),
        stat_sq=statsT[:SC, 4:].reshape(S, C, 6).contiguous(),
    ))


def _sector_select(vmap: VoxelHashMap, center, radius, heading_deg, half_angle_deg):
    """Occupied slots within `radius` of `center` ([S,] 3) whose bearing is
    within +-half_angle of `heading_deg` ([S]) -> ([S,] C) bool."""
    delta = vmap.points - center[..., None, :]
    d2 = delta[..., 0] * delta[..., 0] + delta[..., 1] * delta[..., 1] + \
        delta[..., 2] * delta[..., 2]
    bearing = torch.atan2(delta[..., 1], delta[..., 0]) * 180.0 / math.pi
    heading = torch.as_tensor(heading_deg, dtype=bearing.dtype, device=bearing.device)
    diff = torch.abs(torch.remainder(bearing - heading[..., None] + 180.0, 360.0) - 180.0)
    return (vmap.occupied > 0.5) & (d2 < radius * radius) & (diff < half_angle_deg)


def voxel_map_sector_search(
    vmap: VoxelHashMap,
    center: torch.Tensor,
    radius: float,
    heading_deg: torch.Tensor,
    half_angle_deg: float,
    out_size: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Heading sector query: stored points within `radius` of `center` (3,)
    whose bearing is within +-half_angle of `heading_deg` (wrap-aware),
    compacted to (out_size, 3) + mask + count (ikd-Tree `Sector_Search`,
    ikd_Tree.cpp:1114-1117, 1434-1448). A batched map takes center (S, 3)
    and heading (S,) and returns (S, out_size, ...) results."""
    sel = _sector_select(vmap, center, radius, heading_deg, half_angle_deg)
    return mask_compact(vmap.points, sel.to(vmap.points.dtype), out_size)


def voxel_map_sector_search_with_stats(
    vmap: VoxelHashMap,
    center: torch.Tensor,
    radius: float,
    heading_deg: torch.Tensor,
    half_angle_deg: float,
    out_size: int,
    min_count: float = 3.0,
    fallback_var: float = 0.01,
):
    """Sector query that also emits each voxel's Gaussian: returns
    (points (P,3), mask (P,), count (), means (P,3), covs_packed (P,6)),
    each with a leading (S,) axis for a batched map (center (S, 3), heading
    (S,)). Voxels with fewer than `min_count` points get the isotropic
    `fallback_var` covariance. The raw accumulators are compacted first and
    the mean/cov math runs on the (out_size, ...) result."""
    sel = _sector_select(vmap, center, radius, heading_deg, half_angle_deg)
    payload = torch.cat([vmap.points, vmap.stat_n[..., None], vmap.stat_sum,
                         vmap.stat_sq], dim=-1)                       # ([S,] C, 13)
    out, mask, count = mask_compact(payload, sel.to(vmap.points.dtype), out_size)
    n = torch.clamp(out[..., 3:4], min=1.0)
    mu = out[..., 4:7] / n
    ex2 = out[..., 7:13] / n
    cov = torch.stack([
        ex2[..., 0] - mu[..., 0] * mu[..., 0],
        ex2[..., 1] - mu[..., 1] * mu[..., 1],
        ex2[..., 2] - mu[..., 2] * mu[..., 2],
        ex2[..., 3] - mu[..., 0] * mu[..., 1],
        ex2[..., 4] - mu[..., 0] * mu[..., 2],
        ex2[..., 5] - mu[..., 1] * mu[..., 2],
    ], dim=-1)
    profiling.count("host_syncs")      # a copy from the host: on a card, it waits for the stream
    iso = torch.tensor([fallback_var, fallback_var, fallback_var, 0.0, 0.0, 0.0],
                       dtype=cov.dtype, device=cov.device)
    cov = torch.where(out[..., 3:4] < min_count, iso, cov)
    return out[..., :3], mask, count, mu, cov


def _single_table(vmap: VoxelHashMap, name: str) -> None:
    if vmap.streams is not None:
        raise ValueError(f"{name} takes a single table, not a batched map of "
                         f"{vmap.streams} streams")


def _in_box(vmap: VoxelHashMap, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """(C,) bool: the stored point lies in [lo, hi] (3,) on every axis."""
    return torch.all((vmap.points >= lo) & (vmap.points <= hi), dim=-1)


def voxel_map_radius_search(
    vmap: VoxelHashMap, center: torch.Tensor, radius: float, out_size: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stored points within `radius` of `center` (3,), compacted to
    (out_size, 3) + mask + count (ikd-Tree `Radius_Search`,
    ikd_Tree.cpp:408-414). One masked pass over the table."""
    _single_table(vmap, "voxel_map_radius_search")
    d = vmap.points - center
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    sel = (vmap.occupied > 0.5) & (d2 < radius * radius)
    return mask_compact(vmap.points, sel.to(vmap.points.dtype), out_size)


def voxel_map_box_search(
    vmap: VoxelHashMap, lo: torch.Tensor, hi: torch.Tensor, out_size: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stored points in the axis-aligned box [lo, hi] (3,) each, compacted
    to (out_size, 3) + mask + count (ikd-Tree `Box_Search`,
    ikd_Tree.cpp:401-406)."""
    _single_table(vmap, "voxel_map_box_search")
    sel = (vmap.occupied > 0.5) & _in_box(vmap, lo, hi)
    return mask_compact(vmap.points, sel.to(vmap.points.dtype), out_size)


def _tombstone(vmap: VoxelHashMap, kill: torch.Tensor) -> VoxelHashMap:
    """Clear occupancy and the Gaussian accumulators where `kill`; keys stay,
    so probe chains through these slots remain intact, and an insert
    revives a slot on a key match."""
    return vmap.replace(
        occupied=torch.where(kill, 0.0, vmap.occupied),
        stat_n=torch.where(kill, 0.0, vmap.stat_n),
        stat_sum=torch.where(kill[..., None], 0.0, vmap.stat_sum),
        stat_sq=torch.where(kill[..., None], 0.0, vmap.stat_sq),
    )


def voxel_map_forget_far(vmap: VoxelHashMap, center: torch.Tensor,
                         radius: float) -> VoxelHashMap:
    """Tombstone every voxel whose stored point lies farther than `radius`
    from `center` (3,), or per stream from center (S, 3) on a batched map:
    the long-run memory policy (localization only queries the 80 m sector
    around the vehicle; the reference's analog is ikd-Tree's
    `Delete_by_range`, ikd_Tree.cpp:656-718). One masked clear over the
    tables; keys stay (tombstones)."""
    d = vmap.points - center[..., None, :]
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    return _tombstone(vmap, (vmap.occupied > 0.5) & (d2 > radius * radius))


def voxel_map_delete_box(vmap: VoxelHashMap, lo: torch.Tensor,
                         hi: torch.Tensor) -> VoxelHashMap:
    """Tombstone every voxel whose stored point lies in [lo, hi] (ikd-Tree
    `Delete_by_range`, ikd_Tree.cpp:656-718, immediate rather than lazy):
    occupancy and the Gaussian accumulators clear, keys stay, so probe
    chains stay intact and a later insert revives the slot on a key
    match."""
    _single_table(vmap, "voxel_map_delete_box")
    return _tombstone(vmap, (vmap.occupied > 0.5) & _in_box(vmap, lo, hi))


def voxel_map_delete_points(vmap: VoxelHashMap, pts: torch.Tensor,
                            mask: Optional[torch.Tensor] = None) -> VoxelHashMap:
    """Tombstone the voxels that contain the points (N, 3) whose mask (N,)
    is set (ikd-Tree `Delete_Points`, ikd_Tree.cpp:522-542). The map keeps
    one representative a voxel, so a point deletes its voxel; a point whose
    voxel is not stored within `max_probes` slots of its hash is a no-op.
    One gather a probe round, then one masked clear."""
    _single_table(vmap, "voxel_map_delete_points")
    C, dev = vmap.capacity, pts.device
    if mask is None:
        mask = torch.ones(pts.shape[0], dtype=pts.dtype, device=dev)
    coords = _voxel_coords(pts, vmap.voxel_size)
    h = _hash(coords, C)
    valid = mask > 0.5
    found = torch.full((pts.shape[0],), C, dtype=torch.int32, device=dev)
    for j in range(vmap.max_probes):
        slot = (h + j) & (C - 1)
        sl = slot.long()
        hit = (torch.all(vmap.keys[sl] == coords, dim=-1) & (vmap.occupied[sl] > 0.5)
               & valid & (found >= C))
        found = torch.where(hit, slot, found)
    kill = torch.zeros(C + 1, dtype=torch.bool, device=dev)   # row C: not found
    kill.index_fill_(0, found.long(), True)
    return _tombstone(vmap, kill[:C])


def voxel_map_add_box(vmap: VoxelHashMap, lo: torch.Tensor,
                      hi: torch.Tensor) -> VoxelHashMap:
    """Undo a box delete: revive the tombstones (keyed, unoccupied slots)
    whose stored point lies in [lo, hi] (ikd-Tree `Add_by_range`,
    ikd_Tree.cpp:500-519). A revived voxel keeps its representative point
    and intensity; its Gaussian was cleared at the delete, so it carries
    the fallback covariance until it is observed again."""
    _single_table(vmap, "voxel_map_add_box")
    revive = (vmap.keys[:, 0] != _EMPTY) & _in_box(vmap, lo, hi) & (vmap.occupied <= 0.5)
    return vmap.replace(occupied=torch.where(revive, 1.0, vmap.occupied))


def voxel_map_delete_box_acquire(
    vmap: VoxelHashMap, lo: torch.Tensor, hi: torch.Tensor, out_size: int,
) -> Tuple[VoxelHashMap, torch.Tensor, torch.Tensor, torch.Tensor]:
    """`voxel_map_delete_box` that also returns the representative points
    it removed, compacted to (out_size, 3) + mask + count: ikd-Tree's
    removed-points drain (`acquire_removed_points`, ikd_Tree.cpp:567-581)
    and the `Delete_Point_Boxes` count (:544-564), with no hidden buffer."""
    _single_table(vmap, "voxel_map_delete_box_acquire")
    kill = (vmap.occupied > 0.5) & _in_box(vmap, lo, hi)
    pts, mask, count = mask_compact(vmap.points, kill.to(vmap.points.dtype), out_size)
    return _tombstone(vmap, kill), pts, mask, count


def voxel_map_rehash(vmap: VoxelHashMap) -> VoxelHashMap:
    """Rebuild the table from its live voxels, releasing every tombstone
    (a batched map rebuilds every stream's table).

    Tombstones keep their keys so that probe chains stay intact, so a slot
    once used never hosts a different voxel; after much forgetting new
    voxels stop finding room. The live entries (unique keys: no dedupe, no
    incumbent) move into a fresh table in probe rounds: one claim scatter-
    min on the row index per round, one host read of `any(alive)` per round
    for all streams, then one payload scatter. Live entries whose fresh
    chain exceeds max_probes are dropped, as in an insert. The analog of
    ikd-Tree's rebuild (ikd_Tree.cpp:633-653)."""
    vmap, unbatch = _batched(vmap)
    S, C = vmap.keys.shape[:2]
    SC, dev = S * C, vmap.keys.device
    keys = vmap.keys.reshape(SC, 3)
    alive = vmap.occupied.reshape(SC) > 0.5
    h0 = _hash(keys, C)
    base_s = (torch.arange(SC, device=dev) // C * C).to(torch.int32)
    iota = torch.arange(SC, dtype=torch.int32, device=dev)
    # row SC reads as empty, row SC + 1 absorbs dropped writes
    keys_new = torch.full((SC + 2, 3), _EMPTY, dtype=torch.int32, device=dev)
    slot_res = torch.full((SC,), SC, dtype=torch.int32, device=dev)
    offset = torch.zeros(SC, dtype=torch.int32, device=dev)
    rnd = 0
    while rnd < vmap.max_probes:
        profiling.count("host_syncs")
        if not bool(alive.any()):
            break
        slot = ((h0 + offset) & (C - 1)) + base_s
        empty = (keys_new[torch.where(alive, slot, SC).long()][:, 0] == _EMPTY) & alive
        claim_idx = torch.where(empty, slot, SC).long()
        cbuf = torch.full((SC + 1,), SC, dtype=torch.int32, device=dev)
        cbuf.scatter_reduce_(0, claim_idx, torch.where(empty, iota, SC), reduce="amin")
        win = empty & (cbuf[claim_idx] == iota)
        keys_new[torch.where(win, slot, SC + 1).long()] = keys
        slot_res = torch.where(win, slot, slot_res)
        alive = alive & ~win
        offset = offset + alive.to(torch.int32)
        rnd += 1
    ft = vmap.points.dtype
    payload = torch.cat([vmap.points.reshape(SC, 3), vmap.intensity.reshape(SC, 1),
                         torch.ones((SC, 1), dtype=ft, device=dev), vmap.stat_n.reshape(SC, 1),
                         vmap.stat_sum.reshape(SC, 3), vmap.stat_sq.reshape(SC, 6)], dim=-1)
    buf = torch.zeros((SC + 1, 15), dtype=ft, device=dev)
    buf[slot_res.long()] = payload                     # unplaced rows land in row SC
    buf = buf[:SC].reshape(S, C, 15)
    return unbatch(vmap.replace(
        keys=keys_new[:SC].reshape(S, C, 3), points=buf[..., :3].contiguous(),
        intensity=buf[..., 3].contiguous(), occupied=buf[..., 4].contiguous(),
        stat_n=buf[..., 5].contiguous(), stat_sum=buf[..., 6:9].contiguous(),
        stat_sq=buf[..., 9:].contiguous()))


def voxel_map_maybe_rehash(vmap: VoxelHashMap,
                           tombstone_fraction: float = 0.1) -> VoxelHashMap:
    """Rehash when tombstones (keyed, unoccupied slots) exceed
    `tombstone_fraction` of the capacity; on a batched map, only the streams
    over it. One host read of the trigger."""
    tombs = torch.sum((vmap.keys[..., 0] != _EMPTY) & (vmap.occupied <= 0.5), dim=-1)
    need = tombs > tombstone_fraction * vmap.capacity
    profiling.count("host_syncs")
    if vmap.streams is None:
        return voxel_map_rehash(vmap) if bool(need) else vmap
    idx = torch.nonzero(need)[:, 0]
    if idx.numel() == 0:
        return vmap
    fresh = voxel_map_rehash(vmap.stream(idx))
    return vmap.with_tables(t.index_copy(0, idx, f)
                            for t, f in zip(vmap.tables(), fresh.tables()))


def voxel_map_lookup_slots(
    vmap: VoxelHashMap, coords: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Resolve integer voxel coordinates (..., 3) to their table slots ->
    (slot (...) int32, found (...) bool); slot is 0 where not found, so
    gate every gather through `found`. One gather per probe round over the
    whole coordinate block. A batched map takes coords (S, ..., 3), each
    stream's resolved in its own table."""
    flat, found = _lookup_flat(vmap, coords)
    return torch.where(found, flat % vmap.capacity, 0).to(torch.int32), found


def _lookup_flat(vmap: VoxelHashMap, coords: torch.Tensor):
    """(row into the tables flattened over their streams (...) int64, found
    (...) bool) of `voxel_map_lookup_slots`; the row is the stream's first
    (its slot 0) where not found."""
    C = vmap.capacity
    h = _hash(coords, C)
    if vmap.streams is None:
        keys, occupied, base = vmap.keys, vmap.occupied, 0
    else:
        keys, occupied = vmap.keys.reshape(-1, 3), vmap.occupied.reshape(-1)
        base = (torch.arange(vmap.streams, device=coords.device) * C).reshape(
            (-1,) + (1,) * (coords.dim() - 2))
    rows = torch.zeros(coords.shape[:-1], dtype=torch.int64, device=coords.device) + base
    found = torch.zeros(coords.shape[:-1], dtype=torch.bool, device=coords.device)
    for j in range(vmap.max_probes):
        row = ((h + j) & (C - 1)).to(torch.int64) + base
        hit = (torch.all(keys[row] == coords, dim=-1) & (occupied[row] > 0.5) & ~found)
        rows = torch.where(hit, row, rows)
        found = found | hit
    return rows, found


def _lookup_voxels(
    vmap: VoxelHashMap, coords: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The stored point of each integer voxel coordinate (..., 3) ->
    (points (..., 3), found (...)); points are 0 where not found. A
    batched map takes coords (S, ..., 3)."""
    rows, found = _lookup_flat(vmap, coords)
    pts = torch.where(found[..., None], vmap.points.reshape(-1, 3)[rows], 0.0)
    return pts, found


def _sq_dist(pts: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """(..., N, K, 3) candidates against (..., N, 3) queries -> (..., N, K)
    squared distances, summed over x, y, z in order."""
    d = pts - queries[..., None, :]
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]


def _k_nearest(d2: torch.Tensor, pts: torch.Tensor, k: int):
    """The k smallest distances of each row and their points, nearest first;
    among equal distances the lower column first (`lax.top_k`'s rule)."""
    order, d2 = k_smallest(d2, k)
    return d2, torch.gather(pts, -2, order[..., None].expand(order.shape + (3,)))


def voxel_map_stencil_neighbors(
    vmap: VoxelHashMap,
    queries: torch.Tensor,
    stencil_radius: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Candidate map points around each query from the (2s+1)^3 voxel
    stencil (the gather-based replacement for the kd-tree's Nearest_Search,
    ikd_Tree.cpp:368-398): queries (N, 3) -> (points (N, K, 3), valid (N,
    K)), K = (2s+1)^3, one stored point per voxel."""
    base = _voxel_coords(queries, vmap.voxel_size)
    r = torch.arange(-stencil_radius, stencil_radius + 1, dtype=torch.int32,
                     device=queries.device)
    offsets = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), dim=-1).reshape(-1, 3)
    return _lookup_voxels(vmap, base[:, None, :] + offsets[None, :, :])


def voxel_map_knn(
    vmap: VoxelHashMap,
    queries: torch.Tensor,
    k: int,
    stencil_radius: int = 1,
    max_dist: float = math.inf,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest map points per query from the voxel stencil, within
    max_dist: queries (N, 3) -> (dists2 (N, k), points (N, k, 3)); slots
    beyond the available neighbours carry +inf. Reach is bounded by the
    stencil: (stencil_radius + 0.5) * voxel_size around the query's voxel."""
    cand, valid = voxel_map_stencil_neighbors(vmap, queries, stencil_radius)
    d2 = _sq_dist(cand, queries)
    d2 = torch.where(valid & (d2 < max_dist * max_dist), d2, math.inf)
    return _k_nearest(d2, cand, k)


def voxel_map_knn_exact(
    vmap: VoxelHashMap,
    queries: torch.Tensor,
    k: int,
    max_dist: float = 2.0,
    chunk: int = 256,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """EXACT k nearest map points per query within max_dist (the whole-map
    Nearest_Search + max_dist gate, ikd_Tree.cpp:368-398; MAX_SEARCH_RADIUS
    2.0 at src/radar_odometry.cpp:35), without the stencil's reach bound.

    Candidate voxel offsets out to max_dist are sorted by a lower bound on
    their distance to the query's voxel and visited in chunks of `chunk`
    (one batched lookup each); the loop stops once every query's k-th best
    beats the next chunk's lower bound, the kd-tree's box-distance pruning,
    so the result does not depend on where it stops. queries (N, 3) ->
    (dists2 (N, k), points (N, k, 3)); missing neighbours carry +inf. A
    batched map takes queries (S, N, 3), each stream's searched in its own
    table, and returns (S, N, ...): the loop runs until every query of
    every stream has met the bound, and a stream's result is the one it
    gets alone (the chunks past its own stop change nothing)."""
    if not math.isfinite(max_dist) or max_dist <= 0:
        raise ValueError("voxel_map_knn_exact needs a finite max_dist > 0")
    L = vmap.voxel_size
    R = int(np.floor(max_dist / L)) + 1
    r = np.arange(-R, R + 1)
    offs = np.stack(np.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 3)
    # lower bound: a point of the query's voxel and one of the offset voxel
    # are at least L * (|o_i| - 1) apart along each axis
    dmin = L * np.sqrt((np.maximum(np.abs(offs) - 1, 0).astype(np.float64) ** 2).sum(-1))
    keep = dmin <= max_dist
    offs, dmin = offs[keep], dmin[keep]
    order = np.argsort(dmin, kind="stable")
    offs, dmin = offs[order], dmin[order]
    n_off = offs.shape[0]
    chunk = min(chunk, n_off)
    n_chunks = -(-n_off // chunk)
    pad = n_chunks * chunk - n_off
    dev, dt = queries.device, queries.dtype
    chunk_off = torch.tensor(np.pad(offs, ((0, pad), (0, 0))).reshape(n_chunks, chunk, 3),
                             dtype=torch.int32, device=dev)
    chunk_valid = torch.tensor(np.pad(np.ones(n_off, bool), (0, pad)).reshape(n_chunks, chunk),
                               device=dev)
    # squared lower bound of each chunk's first (closest) offset, consulted
    # before the chunk is visited
    lb2 = (dmin[::chunk] ** 2).astype(np.float32)

    lead = tuple(queries.shape[:-1])                 # ([S,] N)
    base = _voxel_coords(queries, L)
    best_d2 = torch.full(lead + (k,), math.inf, dtype=dt, device=dev)
    best_pts = torch.zeros(lead + (k, 3), dtype=dt, device=dev)
    md2 = float(np.float32(max_dist * max_dist))
    c = 0
    while c < n_chunks:
        profiling.count("host_syncs")
        if not bool(torch.any(best_d2[..., k - 1] > float(lb2[c]))):
            break
        pts, found = _lookup_voxels(vmap, base[..., None, :] + chunk_off[c])
        d2 = _sq_dist(pts, queries)
        d2 = torch.where(found & chunk_valid[c] & (d2 < md2), d2, math.inf)
        best_d2, best_pts = _k_nearest(torch.cat([best_d2, d2], dim=-1),
                                        torch.cat([best_pts, pts], dim=-2), k)
        c += 1
    return best_d2, best_pts
