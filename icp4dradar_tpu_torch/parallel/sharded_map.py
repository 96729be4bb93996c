"""Spatially-sharded voxel map over the ranks of a mesh (PyTorch port of
`icp4dradar_tpu/parallel/sharded_map.py`).

The hash table of global capacity C is split into contiguous slot ranges,
one a rank: rank r holds slots [r Cl, (r+1) Cl) of C = n Cl, while hashing
and probing use the global C, so the gathered table is a single-device
table. Candidate points are replicated (every rank receives the whole
batch); each rank arbitrates only the slots it owns, and the
per-candidate verdicts (advance, die) are summed over the ranks once a
probe round, in one all-reduce: the only traffic of an insert. Queries
compact per shard.

The probe-round arbitration is the JAX package's sharded insert
(keep-nearest-centre, the smallest candidate index wins a claim on an
empty slot, a tombstone is revived by a key match), not the port's
single-device sort-based insert: the two fill slots in another order, and
hold the same voxel -> (point, count) content. Each round ends with one
host read of `any(alive)`, which is the same on every rank after the
all-reduce, so every rank takes the same branch and the collectives stay
aligned.

`ShardedVoxelMap` holds a rank's slice: its local `VoxelHashMap` of Cl
rows, the global capacity, the mesh and its axis. `num_voxels` and
`gather()` are collectives (every rank of the axis calls them)."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh

from icp4dradar_tpu_torch.mapping.voxel_hash import (
    _EMPTY,
    VoxelHashMap,
    _center_dist2,
    _hash,
    _sector_select,
    _voxel_coords,
    voxel_map_create,
    voxel_map_forget_far,
)
from icp4dradar_tpu_torch.ops.compaction import mask_compact
from icp4dradar_tpu_torch.parallel.mesh import (
    all_gather_rows,
    all_reduce_sum,
    axis_rank,
    axis_size,
    mesh_device,
)

_BIG = 1e30


@dataclass(frozen=True)
class ShardedVoxelMap:
    """This rank's slice of a map sharded along `axis` of `mesh`: `local`
    holds slots [r Cl, (r+1) Cl) of the global table of `capacity` slots."""

    local: VoxelHashMap
    capacity: int
    mesh: DeviceMesh
    axis: str = "dp"

    @property
    def voxel_size(self) -> float:
        return self.local.voxel_size

    @property
    def max_probes(self) -> int:
        return self.local.max_probes

    @property
    def local_capacity(self) -> int:
        return self.local.capacity

    @property
    def slot_base(self) -> int:
        return axis_rank(self.mesh, self.axis) * self.local_capacity

    @property
    def num_voxels(self) -> torch.Tensor:
        """() occupied slots over all shards (an all-reduce)."""
        return all_reduce_sum([torch.sum(self.local.occupied)], self.mesh, self.axis)[0]

    def replace_local(self, local: VoxelHashMap) -> "ShardedVoxelMap":
        return dataclasses.replace(self, local=local)

    def gather(self) -> VoxelHashMap:
        """The whole (C, ...) table on every rank (one all-gather)."""
        return self.local.with_tables(
            all_gather_rows(list(self.local.tables()), self.mesh, self.axis))


def sharded_map_create(
    mesh: DeviceMesh,
    capacity: int = 1 << 18,
    voxel_size: float = 0.5,
    max_probes: int = 8,
    axis: str = "dp",
    dtype=torch.float32,
) -> ShardedVoxelMap:
    """An empty map of `capacity` slots sharded over the mesh axis, each
    rank's slice on its device."""
    n = axis_size(mesh, axis)
    if capacity % n:
        raise ValueError("capacity must divide the mesh size")
    if capacity & (capacity - 1):
        raise ValueError("capacity must be a power of two")
    local = voxel_map_create(capacity // n, voxel_size, max_probes, dtype=dtype,
                             device=mesh_device(mesh))
    return ShardedVoxelMap(local=local, capacity=capacity, mesh=mesh, axis=axis)


def shard_from_table(vmap: VoxelHashMap, mesh: DeviceMesh, axis: str = "dp") -> ShardedVoxelMap:
    """This rank's slice of a whole (C, ...) table (a checkpoint's, or a
    gathered map), on the rank's device; the mesh may differ from the one
    that built it."""
    n, r, C = axis_size(mesh, axis), axis_rank(mesh, axis), vmap.capacity
    if C % n:
        raise ValueError(f"capacity {C} must divide the mesh size {n}")
    Cl, dev = C // n, mesh_device(mesh)
    return ShardedVoxelMap(
        local=vmap.with_tables(t[r * Cl:(r + 1) * Cl].to(dev).contiguous()
                               for t in vmap.tables()),
        capacity=C, mesh=mesh, axis=axis)


def _drop_row(x: torch.Tensor, rows: int = 1) -> torch.Tensor:
    """x with `rows` extra zero rows at its end: rows Cl... absorb the writes
    of candidates that own no slot here (the JAX scatters' `mode="drop"`)."""
    return torch.cat([x, x.new_zeros((rows,) + tuple(x.shape[1:]))])


def shard_local_insert(
    smap: ShardedVoxelMap,
    xyz: torch.Tensor,
    mask: torch.Tensor,
    intensity: torch.Tensor,
) -> ShardedVoxelMap:
    """The probe-round insert of a replicated candidate batch (N, 3) into
    this rank's slot range. Every round: the arbitration over the slots this
    rank owns, one all-reduce of the (advance, die) verdicts of the slot
    owners, one host read of `any(alive)` (identical on every rank)."""
    vm, mesh, axis = smap.local, smap.mesh, smap.axis
    C, Cl, base = smap.capacity, smap.local_capacity, smap.slot_base
    L = vm.voxel_size
    n, dev, ft = xyz.shape[0], xyz.device, xyz.dtype
    coords = _voxel_coords(xyz, L)
    h0 = _hash(coords, C)
    d2c = _center_dist2(xyz, coords, L)
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    sq6 = torch.stack([x * x, y * y, z * z, x * y, x * z, y * z], dim=-1)
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    keys = torch.cat([vm.keys, torch.full((1, 3), _EMPTY, dtype=torch.int32, device=dev)])
    points, inten, occ = _drop_row(vm.points), _drop_row(vm.intensity), _drop_row(vm.occupied)
    # the moment sums accumulate in index order (a sorted accumulation:
    # deterministic on every device); candidate i with nothing to add here
    # adds into drop row Cl + i, so that no row gathers a long run of adds
    sn, ssum, ssq = (_drop_row(x, n) for x in (vm.stat_n, vm.stat_sum, vm.stat_sq))
    ones = torch.ones(n, dtype=ft, device=dev)

    alive = mask > 0.5
    offset = torch.zeros(n, dtype=torch.int32, device=dev)
    rnd = 0
    while rnd < vm.max_probes and bool(alive.any()):
        slot = (h0 + offset) & (C - 1)
        mine = (slot >= base) & (slot < base + Cl) & alive
        lslot = torch.clamp(slot - base, 0, Cl - 1).long()
        slot_keys = keys[lslot]
        slot_used = slot_keys[:, 0] != _EMPTY
        same = torch.all(slot_keys == coords, dim=-1) & slot_used & mine
        empty = ~slot_used & mine
        inc_d2c = torch.where(occ[lslot] > 0.5, _center_dist2(points[lslot], slot_keys, L), _BIG)

        # same voxel: the candidate nearest the centre (then the smallest
        # index) replaces the occupant if it is nearer still
        to_same = torch.where(same, lslot, Cl)
        dbuf = torch.full((Cl + 1,), _BIG, dtype=ft, device=dev)
        dbuf.scatter_reduce_(0, to_same, torch.where(same, d2c, _BIG), reduce="amin")
        cand_is_min = same & (d2c <= dbuf[lslot])
        ibuf = torch.full((Cl + 1,), n, dtype=torch.int32, device=dev)
        ibuf.scatter_reduce_(0, torch.where(cand_is_min, lslot, Cl),
                             torch.where(cand_is_min, idx, n), reduce="amin")
        cand_win = cand_is_min & (ibuf[lslot] == idx) & (d2c < inc_d2c)
        w = torch.where(cand_win, lslot, Cl)
        points[w], inten[w], occ[w] = xyz, intensity, 1.0

        # empty slot: the smallest index claims it
        cbuf = torch.full((Cl + 1,), n, dtype=torch.int32, device=dev)
        cbuf.scatter_reduce_(0, torch.where(empty, lslot, Cl), torch.where(empty, idx, n),
                             reduce="amin")
        claim_win = empty & (cbuf[lslot] == idx)
        cw = torch.where(claim_win, lslot, Cl)
        keys[cw], points[cw], inten[cw], occ[cw] = coords, xyz, intensity, 1.0

        # every resolved candidate adds to its voxel's Gaussian
        resolved = same | claim_win
        r = (torch.where(resolved, lslot, Cl + idx.long()),)
        sn.index_put_(r, ones, accumulate=True)
        ssum.index_put_(r, xyz, accumulate=True)
        ssq.index_put_(r, sq6, accumulate=True)

        winner = torch.clamp(cbuf[lslot], 0, n - 1).long()
        winner_same = torch.all(coords[winner] == coords, dim=-1)
        advance_l = (mine & ~same & ~empty) | (empty & ~claim_win & ~winner_same)
        # exactly one rank owns each live candidate's slot: the sum carries
        # the owner's verdict to every rank
        flags = torch.stack([advance_l, resolved]).to(torch.int32)
        flags = all_reduce_sum([flags], mesh, axis)[0] > 0
        alive = alive & ~flags[1]
        offset = offset + (flags[0] & alive).to(torch.int32)
        rnd += 1
    return smap.replace_local(vm.replace(
        keys=keys[:Cl], points=points[:Cl], intensity=inten[:Cl], occupied=occ[:Cl],
        stat_n=sn[:Cl], stat_sum=ssum[:Cl], stat_sq=ssq[:Cl]))


def shard_local_rehash(smap: ShardedVoxelMap) -> ShardedVoxelMap:
    """Distributed tombstone reclamation: rebuild the whole sharded table
    from its live voxels. The live rows are all-gathered once; each rank
    claims the slots it owns, arbitrated by the global old-slot index (the
    single-device `voxel_map_rehash`'s order, so the keys land slot for
    slot where it puts them); the per-round verdicts are all-reduced. Live
    entries whose fresh chain exceeds max_probes drop."""
    vm, mesh, axis = smap.local, smap.mesh, smap.axis
    C, Cl, base = smap.capacity, smap.local_capacity, smap.slot_base
    dev, ft = vm.points.device, vm.points.dtype
    payload_l = torch.cat([vm.points, vm.intensity[:, None], vm.stat_n[:, None],
                           vm.stat_sum, vm.stat_sq], dim=-1)               # (Cl, 14)
    keys_g, live_g, payload_g = all_gather_rows([vm.keys, vm.occupied > 0.5, payload_l],
                                                mesh, axis)
    h0 = _hash(keys_g, C)
    iota = torch.arange(C, dtype=torch.int32, device=dev)
    keys_new = torch.full((Cl + 1, 3), _EMPTY, dtype=torch.int32, device=dev)
    placed = torch.full((C,), Cl, dtype=torch.int64, device=dev)
    alive = live_g
    offset = torch.zeros(C, dtype=torch.int32, device=dev)
    rnd = 0
    while rnd < vm.max_probes and bool(alive.any()):
        slot = (h0 + offset) & (C - 1)
        mine = (slot >= base) & (slot < base + Cl) & alive
        lslot = torch.clamp(slot - base, 0, Cl - 1).long()
        empty = (keys_new[lslot, 0] == _EMPTY) & mine
        cbuf = torch.full((Cl + 1,), C, dtype=torch.int32, device=dev)
        cbuf.scatter_reduce_(0, torch.where(empty, lslot, Cl), torch.where(empty, iota, C),
                             reduce="amin")
        win = empty & (cbuf[lslot] == iota)
        keys_new[torch.where(win, lslot, Cl)] = keys_g
        placed = torch.where(win, lslot, placed)
        flags = torch.stack([win, mine & ~win]).to(torch.int32)
        flags = all_reduce_sum([flags], mesh, axis)[0] > 0
        alive = alive & ~flags[0]
        offset = offset + (flags[1] & alive).to(torch.int32)
        rnd += 1
    buf = torch.zeros((Cl + 1, 15), dtype=ft, device=dev)
    buf[placed] = torch.cat([payload_g, torch.ones((C, 1), dtype=ft, device=dev)], dim=-1)
    return smap.replace_local(vm.replace(
        keys=keys_new[:Cl], points=buf[:Cl, :3].contiguous(),
        intensity=buf[:Cl, 3].contiguous(), stat_n=buf[:Cl, 4].contiguous(),
        stat_sum=buf[:Cl, 5:8].contiguous(), stat_sq=buf[:Cl, 8:14].contiguous(),
        occupied=buf[:Cl, 14].contiguous()))


def shard_local_maybe_rehash(smap: ShardedVoxelMap,
                             tombstone_fraction: float = 0.1) -> ShardedVoxelMap:
    """Rehash when the tombstones of all shards exceed `tombstone_fraction`
    of the global capacity: the count is all-reduced and read once on the
    host, so every rank takes the same branch."""
    vm = smap.local
    tombs_l = torch.sum((vm.keys[:, 0] != _EMPTY) & (vm.occupied <= 0.5))
    tombs = all_reduce_sum([tombs_l], smap.mesh, smap.axis)[0]
    if float(tombs) > tombstone_fraction * smap.capacity:
        return shard_local_rehash(smap)
    return smap


def sharded_map_insert(
    smap: ShardedVoxelMap,
    mesh: DeviceMesh,
    xyz: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    intensity: Optional[torch.Tensor] = None,
    axis: str = "dp",
) -> ShardedVoxelMap:
    """Insert a replicated candidate batch (N, 3) into the sharded map."""
    _check_mesh(smap, mesh, axis)
    if mask is None:
        mask = torch.ones(xyz.shape[0], dtype=xyz.dtype, device=xyz.device)
    if intensity is None:
        intensity = torch.zeros(xyz.shape[0], dtype=xyz.dtype, device=xyz.device)
    return shard_local_insert(smap, xyz, mask, intensity)


def sharded_map_rehash(smap: ShardedVoxelMap, mesh: DeviceMesh,
                       axis: str = "dp") -> ShardedVoxelMap:
    """The distributed rehash (`shard_local_rehash`)."""
    _check_mesh(smap, mesh, axis)
    return shard_local_rehash(smap)


def _check_mesh(smap: ShardedVoxelMap, mesh: DeviceMesh, axis: str) -> None:
    if smap.axis != axis or axis_size(mesh, axis) * smap.local_capacity != smap.capacity:
        raise ValueError(f"the map is sharded along {smap.axis!r} in slices of "
                         f"{smap.local_capacity} slots, not over this mesh's {axis!r}")


def _voxel_stats(out: torch.Tensor, min_count: float, fallback_var: float):
    """Compacted raw rows [point3, n, sum3, sq6] -> (means, packed covs);
    voxels with fewer than `min_count` points get the isotropic
    `fallback_var`."""
    n = torch.clamp(out[:, 3:4], min=1.0)
    mu = out[:, 4:7] / n
    ex2 = out[:, 7:13] / n
    cov = torch.stack([
        ex2[:, 0] - mu[:, 0] * mu[:, 0],
        ex2[:, 1] - mu[:, 1] * mu[:, 1],
        ex2[:, 2] - mu[:, 2] * mu[:, 2],
        ex2[:, 3] - mu[:, 0] * mu[:, 1],
        ex2[:, 4] - mu[:, 0] * mu[:, 2],
        ex2[:, 5] - mu[:, 1] * mu[:, 2],
    ], dim=-1)
    iso = torch.tensor([fallback_var] * 3 + [0.0] * 3, dtype=cov.dtype, device=cov.device)
    return mu, torch.where(out[:, 3:4] < min_count, iso, cov)


def shard_local_sector_stats(
    smap: ShardedVoxelMap,
    center: torch.Tensor,
    radius: float,
    heading_deg: torch.Tensor,
    half_angle_deg: float,
    per: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """This shard's slice of the sector query with per-voxel Gaussians,
    compacted to `per` rows -> (points, mask, count, means, covs). No
    collective. The union of all shards' rows is the single-device query's
    row set unless a shard holds more than `per` sector voxels (it then
    drops its excess while others have slack: size `per` with headroom).

    The minimum count 3 and the fallback variance 0.01 are fixed, as in the
    JAX package's distributed query, whatever `voxel_map.stats_min_count`
    and `stats_fallback_var` say (ROADMAP.md queue 3, "Distributed sector
    stats")."""
    vm = smap.local
    sel = _sector_select(vm, center, radius, heading_deg, half_angle_deg)
    payload = torch.cat([vm.points, vm.stat_n[:, None], vm.stat_sum, vm.stat_sq], dim=-1)
    out, mask, count = mask_compact(payload, sel.to(vm.points.dtype), per)
    mu, cov = _voxel_stats(out, 3.0, 0.01)
    return out[:, :3], mask, count, mu, cov


def sharded_sector_search_with_stats(
    smap: ShardedVoxelMap,
    mesh: DeviceMesh,
    center: torch.Tensor,
    radius: float,
    heading_deg: torch.Tensor,
    half_angle_deg: float,
    out_size: int,
    axis: str = "dp",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sector query over the sharded map: each shard compacts to out_size/n
    rows, and the blocks come back in rank order, (out_size, ...) on every
    rank (one all-gather), with the count summed over the shards (one
    all-reduce). Returns (points, mask, count, means, covs_packed)."""
    _check_mesh(smap, mesh, axis)
    vm = smap.local
    per = out_size // axis_size(mesh, axis)
    sel = _sector_select(vm, center, radius, heading_deg, half_angle_deg)
    # the Gaussians of every slot, then compacted (as the JAX package's
    # query, whose rows past the count are zeros)
    mu, cov = _voxel_stats(torch.cat([vm.points, vm.stat_n[:, None], vm.stat_sum, vm.stat_sq],
                                     dim=-1), 3.0, 0.01)
    out, m, cnt = mask_compact(torch.cat([vm.points, mu, cov], dim=-1),
                               sel.to(vm.points.dtype), per)
    total = all_reduce_sum([cnt], mesh, axis)[0]
    rows, m = all_gather_rows([out, m], mesh, axis)
    return rows[:, :3], m, total, rows[:, 3:6], rows[:, 6:12]


def forget_far(smap: ShardedVoxelMap, center: torch.Tensor, radius: float) -> ShardedVoxelMap:
    """`voxel_map_forget_far` on this rank's slots (elementwise: no
    collective)."""
    return smap.replace_local(voxel_map_forget_far(smap.local, center, radius))
