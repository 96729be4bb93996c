"""Frozen copy of `icp4dradar_tpu_torch/mapping/voxel_hash.py` at commit
03a0450, part of the benchmark's reference: its plain PyTorch paths only
(the CUDA dispatch removed; what no reference path calls left out).

Voxel-hash incremental map: flat tensors + scatter arbitration, no
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

import torch

from .compaction import mask_compact

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
        if rnd >= 2 * mp or not bool(alive.any()):
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
    iso = torch.tensor([fallback_var, fallback_var, fallback_var, 0.0, 0.0, 0.0],
                       dtype=cov.dtype, device=cov.device)
    cov = torch.where(out[..., 3:4] < min_count, iso, cov)
    return out[..., :3], mask, count, mu, cov


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
    while rnd < vmap.max_probes and bool(alive.any()):
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
    if vmap.streams is None:
        return voxel_map_rehash(vmap) if bool(need) else vmap
    idx = torch.nonzero(need)[:, 0]
    if idx.numel() == 0:
        return vmap
    fresh = voxel_map_rehash(vmap.stream(idx))
    return vmap.with_tables(t.index_copy(0, idx, f)
                            for t, f in zip(vmap.tables(), fresh.tables()))


