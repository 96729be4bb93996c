"""Port voxel-hash map parity on the CPU: `mask_compact`, the spatial hash,
`voxel_map_insert` (sort-dedupe, windowed probe rounds with claim races,
deferred deposits, `leader_budget`) and the sector query with voxel
statistics, against the JAX package from the same starting map.

Tolerance: keys, occupied flags, stored points and intensities must be
identical, and so must the sector query's counts, masks and rows. The
Gaussian accumulators (count, sum, second moment) agree within rtol 1e-5:
the JAX package sums each voxel's batch run with an associative scan, the
port with a doubling scan, so the f32 sums of a run may round differently;
the means and covariances derived from them get the same budget, plus atol
1e-5 for covariance entries that cancel to about zero."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icp4dradar_tpu.mapping import voxel_hash as jvh
from icp4dradar_tpu.ops.compaction import mask_compact as j_mask_compact
from icp4dradar_tpu_torch.interop import (
    VOXEL_MAP_FIELDS,
    voxel_map_from_numpy,
    voxel_map_to_numpy,
)
from icp4dradar_tpu_torch.mapping import voxel_hash as pvh
from icp4dradar_tpu_torch.ops.compaction import mask_compact
from tests._torch_threads import one_torch_thread  # noqa: F401

EXACT = ("keys", "occupied", "points", "intensity")
STATS = ("stat_n", "stat_sum", "stat_sq")
RTOL = 1e-5
B = 512                      # points per inserted batch
# one compile per map capacity instead of an eager trace per call
_jinsert = jax.jit(jvh.voxel_map_insert, static_argnames="leader_budget")


def _to_port(jmap):
    return voxel_map_from_numpy({k: np.asarray(getattr(jmap, k)) for k in VOXEL_MAP_FIELDS},
                                voxel_size=jmap.voxel_size, max_probes=jmap.max_probes,
                                device="cpu")


def _assert_same_map(pmap, jmap):
    got = voxel_map_to_numpy(pmap)
    for k in EXACT:
        np.testing.assert_array_equal(got[k], np.asarray(getattr(jmap, k)), err_msg=k)
    for k in STATS:
        want = np.asarray(getattr(jmap, k))
        np.testing.assert_allclose(got[k], want, rtol=RTOL,
                                   atol=RTOL * np.abs(want).max(), err_msg=k)


@pytest.mark.parametrize("out_size", [5, 40, 300])
@pytest.mark.parametrize("int_values", [False, True])
def test_mask_compact_matches_jax(out_size, int_values):
    rng = np.random.default_rng(out_size)
    vals = rng.normal(size=(200, 4)).astype(np.float32)
    if int_values:
        vals = (vals * 1000).astype(np.int32)
    mask = (rng.uniform(size=200) > 0.6).astype(np.float32)
    want = j_mask_compact(jnp.asarray(vals), jnp.asarray(mask), out_size)
    got = mask_compact(torch.tensor(vals), torch.tensor(mask), out_size)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_hash_wraps_like_int32():
    rng = np.random.default_rng(0)
    coords = rng.integers(-2_000_000, 2_000_000, (1000, 3)).astype(np.int32)
    for C in (256, 1 << 18):
        np.testing.assert_array_equal(
            pvh._hash(torch.tensor(coords), C).numpy(),
            np.asarray(jvh._hash(jnp.asarray(coords), C)))
    xyz = rng.uniform(-500, 500, (1000, 3)).astype(np.float32)
    np.testing.assert_array_equal(pvh._voxel_coords(torch.tensor(xyz), 0.5).numpy(),
                                  np.asarray(jvh._voxel_coords(jnp.asarray(xyz), 0.5)))


def _batch(rng, n, extent, center=(0.0, 0.0, 0.0), dup=0):
    """n points in a cube, the last `dup` of them exact copies of earlier
    ones (equal center distances: the lowest original index must win)."""
    pts = (rng.uniform(-extent, extent, (n, 3)) + center).astype(np.float32)
    if dup:
        pts[-dup:] = pts[rng.choice(n - dup, dup)]
    inten = rng.uniform(0, 30, n).astype(np.float32)
    mask = (rng.uniform(size=n) > 0.1).astype(np.float32)
    return pts, mask, inten


@pytest.mark.parametrize("capacity,extent,budget", [
    (256, 2.0, None),     # ~100 voxels in 256 slots: probe chains, claim races
    (256, 4.0, None),     # more voxels than the probe budget can place: drops
    (1024, 3.0, 64),      # a binding leader budget
    (1024, 3.0, 4096),    # a budget above the batch: no compaction
])
def test_insert_matches_jax(capacity, extent, budget):
    rng = np.random.default_rng(capacity + int(extent))
    jmap = jvh.voxel_map_create(capacity=capacity, voxel_size=0.5, max_probes=8)
    pts, mask, inten = _batch(rng, B, extent, dup=40)
    jmap = _jinsert(jmap, jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(inten))
    pmap = _to_port(jmap)
    # a second batch overlapping the first: incumbents compete, new voxels claim
    pts, mask, inten = _batch(rng, B, extent, center=(1.0, 0.5, 0.0), dup=30)
    jmap = _jinsert(jmap, jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(inten),
                    leader_budget=budget)
    pmap = pvh.voxel_map_insert(pmap, torch.tensor(pts), torch.tensor(mask),
                                torch.tensor(inten), leader_budget=budget)
    _assert_same_map(pmap, jmap)
    assert float(pmap.num_voxels) == float(jmap.num_voxels) > 0


def test_insert_into_empty_map_matches_jax():
    rng = np.random.default_rng(5)
    pts, mask, inten = _batch(rng, B, 10.0, dup=100)
    jmap = _jinsert(jvh.voxel_map_create(capacity=1 << 12), jnp.asarray(pts),
                    jnp.asarray(mask), jnp.asarray(inten))
    pmap = pvh.voxel_map_insert(pvh.voxel_map_create(capacity=1 << 12, device="cpu"),
                                torch.tensor(pts), torch.tensor(mask), torch.tensor(inten))
    _assert_same_map(pmap, jmap)


def test_sector_search_with_stats_matches_jax():
    rng = np.random.default_rng(9)
    jmap = jvh.voxel_map_create(capacity=1 << 12, voxel_size=0.5)
    for k in range(3):
        pts, mask, inten = _batch(rng, B, 30.0, center=(k * 2.0, 0.0, 0.0))
        pts[:, 2] *= 0.1
        jmap = _jinsert(jmap, jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(inten))
    pmap = _to_port(jmap)
    for heading, out_size in ((30.0, 2048), (-170.0, 2048), (30.0, 100)):
        center = np.asarray([1.0, -2.0, 0.0], np.float32)
        want = jvh.voxel_map_sector_search_with_stats(
            jmap, jnp.asarray(center), 25.0, jnp.float32(heading), 60.0, out_size,
            min_count=3.0, fallback_var=0.01)
        got = pvh.voxel_map_sector_search_with_stats(
            pmap, torch.tensor(center), 25.0, torch.tensor(heading), 60.0, out_size,
            min_count=3.0, fallback_var=0.01)
        names = ("points", "mask", "count", "mean", "cov")
        for name, g, w in zip(names[:3], got[:3], want[:3]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
        for name, g, w in zip(names[3:], got[3:], want[3:]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=1e-5,
                                       err_msg=name)
        assert 0 < int(got[2]) <= out_size
        pts, mask, count = pvh.voxel_map_sector_search(
            pmap, torch.tensor(center), 25.0, torch.tensor(heading), 60.0, out_size)
        torch.testing.assert_close(pts, got[0])
        assert int(count) == int(got[2])


def test_map_round_trips_through_numpy():
    rng = np.random.default_rng(2)
    pts, mask, inten = _batch(rng, 300, 5.0)
    pmap = pvh.voxel_map_insert(pvh.voxel_map_create(capacity=512, device="cpu"),
                                torch.tensor(pts), torch.tensor(mask), torch.tensor(inten))
    back = voxel_map_from_numpy(voxel_map_to_numpy(pmap), voxel_size=0.5, max_probes=8,
                                device="cpu")
    for k in VOXEL_MAP_FIELDS:
        assert torch.equal(getattr(back, k), getattr(pmap, k)), k
    with pytest.raises(KeyError):
        voxel_map_from_numpy({"keys": np.zeros((4, 3), np.int32)}, device="cpu")
    with pytest.raises(ValueError):
        pvh.voxel_map_create(capacity=300, device="cpu")


def _knn_map(seed=12):
    """A small map of a ground-like slab, and queries on and off it."""
    rng = np.random.default_rng(seed)
    jmap = jvh.voxel_map_create(capacity=1 << 12, voxel_size=0.5)
    for k in range(2):
        pts, mask, inten = _batch(rng, B, 8.0, center=(k * 1.5, 0.0, 0.0))
        pts[:, 2] *= 0.2
        jmap = _jinsert(jmap, jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(inten))
    queries = rng.uniform(-10, 10, (300, 3)).astype(np.float32)
    queries[:, 2] *= 0.3
    queries[:20] = 0.0                     # padded submap rows sit at the origin
    return jmap, _to_port(jmap), queries


def test_stencil_neighbors_and_lookup_match_jax():
    jmap, pmap, q = _knn_map()
    want = jvh.voxel_map_stencil_neighbors(jmap, jnp.asarray(q), 1)
    got = pvh.voxel_map_stencil_neighbors(pmap, torch.tensor(q), 1)
    assert got[0].shape == (300, 27, 3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    coords = np.asarray(jvh._voxel_coords(jnp.asarray(q), 0.5))
    ws, wf = jvh.voxel_map_lookup_slots(jmap, jnp.asarray(coords))
    gs, gf = pvh.voxel_map_lookup_slots(pmap, torch.tensor(coords))
    np.testing.assert_array_equal(gf.numpy(), np.asarray(wf))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    assert gf.any() and not gf.all()


def _assert_same_knn(got, want):
    """Equal distances where finite (1e-6 relative: the JAX sum of squares
    may contract into FMAs), the same points there, +inf elsewhere."""
    gd, gp = (x.numpy() for x in got)
    wd, wp = (np.asarray(x) for x in want)
    fin = np.isfinite(wd)
    np.testing.assert_array_equal(np.isfinite(gd), fin)
    np.testing.assert_allclose(gd[fin], wd[fin], rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(gp[fin], wp[fin])
    return fin


@pytest.mark.parametrize("k,radius,max_dist", [(5, 1, np.inf), (5, 1, 0.6), (8, 2, 1.2)])
def test_voxel_map_knn_matches_jax(k, radius, max_dist):
    jmap, pmap, q = _knn_map()
    want = jvh.voxel_map_knn(jmap, jnp.asarray(q), k, stencil_radius=radius,
                             max_dist=max_dist)
    fin = _assert_same_knn(pvh.voxel_map_knn(pmap, torch.tensor(q), k, radius, max_dist),
                           want)
    assert fin.any() and not fin.all()


@pytest.mark.parametrize("k,max_dist,chunk", [(5, 2.0, 256), (5, 1.0, 64), (3, 2.0, 1000)])
def test_voxel_map_knn_exact_matches_jax(k, max_dist, chunk):
    jmap, pmap, q = _knn_map()
    want = jvh.voxel_map_knn_exact(jmap, jnp.asarray(q), k, max_dist=max_dist, chunk=chunk)
    got = pvh.voxel_map_knn_exact(pmap, torch.tensor(q), k, max_dist=max_dist, chunk=chunk)
    fin = _assert_same_knn(got, want)
    assert fin.any() and not fin.all()
    # exact: no neighbour within max_dist is missed (numpy brute force)
    stored = voxel_map_to_numpy(pmap)
    pts = stored["points"][stored["occupied"] > 0.5]
    d2 = ((q[:, None, :] - pts[None]) ** 2).sum(-1)
    d2 = np.sort(np.where(d2 < max_dist * max_dist, d2, np.inf), axis=1)[:, :k]
    np.testing.assert_allclose(got[0].numpy(), d2, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError):
        pvh.voxel_map_knn_exact(pmap, torch.tensor(q), k, max_dist=np.inf)


def test_mask_compact_stream_axis_matches_single_calls():
    """values (S, N, ...) and mask (S, N): each stream's compaction equals
    the single call on it, with per-stream counts."""
    rng = np.random.default_rng(3)
    vals = torch.tensor(rng.normal(size=(3, 200, 4)).astype(np.float32))
    mask = torch.tensor((rng.uniform(size=(3, 200)) > np.array([[0.6], [1.0], [0.1]]))
                        .astype(np.float32))
    for out_size in (5, 150):
        got = mask_compact(vals, mask, out_size)
        assert got[0].shape == (3, out_size, 4) and got[2].shape == (3,)
        for s in range(3):
            for g, w in zip(got, mask_compact(vals[s], mask[s], out_size)):
                assert torch.equal(g[s], w)


def _forgetful_map(seed=13):
    """A JAX map of three overlapping batches and its port copy."""
    rng = np.random.default_rng(seed)
    jmap = jvh.voxel_map_create(capacity=1 << 12, voxel_size=0.5)
    for k in range(3):
        pts, mask, inten = _batch(rng, B, 12.0, center=(4.0 * k, 0.0, 0.0))
        jmap = _jinsert(jmap, jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(inten))
    return jmap, _to_port(jmap)


def test_forget_and_rehash_match_jax():
    """Forgetting tombstones the far voxels (keys kept), the rehash rebuilds
    the table from the live ones, and maybe_rehash does so only above its
    tombstone fraction: the same tables as the JAX package's, every field
    exact."""
    jmap, pmap = _forgetful_map()
    center = np.asarray([10.0, 2.0, 0.0], np.float32)
    jf = jvh.voxel_map_forget_far(jmap, jnp.asarray(center), 9.0)
    pf = pvh.voxel_map_forget_far(pmap, torch.tensor(center), 9.0)
    tombs = int(((pf.keys[:, 0] != pvh._EMPTY) & (pf.occupied <= 0.5)).sum())
    assert 0 < int(pf.num_voxels) < int(pmap.num_voxels) and tombs > 0.1 * pf.capacity
    steps = [(jf, pf), (jvh.voxel_map_rehash(jf), pvh.voxel_map_rehash(pf)),
             (jvh.voxel_map_maybe_rehash(jf, 0.1), pvh.voxel_map_maybe_rehash(pf, 0.1)),
             (jvh.voxel_map_maybe_rehash(jf, 0.9), pvh.voxel_map_maybe_rehash(pf, 0.9))]
    for jm, pm in steps:
        got = voxel_map_to_numpy(pm)
        for k in VOXEL_MAP_FIELDS:
            np.testing.assert_array_equal(got[k], np.asarray(getattr(jm, k)), err_msg=k)
    rehashed = steps[1][1]
    assert float(rehashed.num_voxels) == float(pf.num_voxels)
    assert int((rehashed.keys[:, 0] != pvh._EMPTY).sum()) == int(pf.num_voxels)
    assert steps[3][1] is pf                      # below the fraction: untouched


def test_batched_map_ops_match_single_tables():
    """A map of S tables: insert (with and without a binding leader
    budget), both sector queries, forget, rehash and maybe_rehash each give
    stream s what the single-table call gives table s, bit for bit; maybe
    rehash rebuilds only the streams above the fraction."""
    rng = np.random.default_rng(14)
    S, C = 3, 1 << 11
    single = [pvh.voxel_map_create(C, device="cpu") for _ in range(S)]
    batched = pvh.voxel_map_create(C, device="cpu", streams=S)
    assert batched.streams == S and batched.capacity == C and single[0].streams is None

    def same():
        for s in range(S):
            for a, b in zip(batched.stream(s).tables(), single[s].tables()):
                assert torch.equal(a, b)

    for rnd, budget in enumerate((None, 64, None)):
        parts = [_batch(rng, B, 6.0 + 3 * s, center=(2.0 * rnd, 0.0, 0.0), dup=20)
                 for s in range(S)]
        single = [pvh.voxel_map_insert(m, *(torch.tensor(x) for x in p), leader_budget=budget)
                  for m, p in zip(single, parts)]
        batched = pvh.voxel_map_insert(batched, *(torch.tensor(np.stack(x)) for x in zip(*parts)),
                                       leader_budget=budget)
        same()
    center = torch.tensor([[2.0, 0.0, 0.0], [-4.0, 3.0, 0.0], [30.0, 0.0, 0.0]])
    heading = torch.tensor([20.0, 170.0, -90.0])
    got = pvh.voxel_map_sector_search_with_stats(batched, center, 9.0, heading, 60.0, 300)
    plain = pvh.voxel_map_sector_search(batched, center, 9.0, heading, 60.0, 300)
    for s in range(S):
        want = pvh.voxel_map_sector_search_with_stats(single[s], center[s], 9.0, heading[s],
                                                      60.0, 300)
        for g, w in zip(got, want):
            assert torch.equal(g[s], w)
        for g, w in zip(plain, pvh.voxel_map_sector_search(single[s], center[s], 9.0,
                                                           heading[s], 60.0, 300)):
            assert torch.equal(g[s], w)
    assert int(got[2][2]) == 0                    # a sector off the map
    batched = pvh.voxel_map_forget_far(batched, center, 5.0)
    single = [pvh.voxel_map_forget_far(m, center[s], 5.0) for s, m in enumerate(single)]
    same()
    tombs = [int(((m.keys[:, 0] != pvh._EMPTY) & (m.occupied <= 0.5)).sum()) for m in single]
    frac = (sorted(tombs)[0] + sorted(tombs)[1]) / 2 / C        # between two streams
    rehashed = pvh.voxel_map_maybe_rehash(batched, frac)
    for s in range(S):
        want = pvh.voxel_map_maybe_rehash(single[s], frac)
        assert (want is single[s]) == (tombs[s] <= frac * C)
        for a, b in zip(rehashed.stream(s).tables(), want.tables()):
            assert torch.equal(a, b)
    batched, single = pvh.voxel_map_rehash(batched), [pvh.voxel_map_rehash(m) for m in single]
    same()
    # the exact k-NN with a stream axis (kNN GICP's exact map k-NN in a
    # batch): stream s gets the single-table search of table s, though the
    # chunk loop runs until every stream's queries meet the bound
    q = torch.tensor(rng.uniform(-8, 8, (S, 40, 3)).astype(np.float32))
    q[2] += 30.0                                  # far from stream 2's map: every chunk
    d2, pts = pvh.voxel_map_knn_exact(batched, q, 5, max_dist=2.0, chunk=64)
    for s in range(S):
        d1, p1 = pvh.voxel_map_knn_exact(single[s], q[s], 5, max_dist=2.0, chunk=64)
        assert torch.equal(d2[s], d1) and torch.equal(pts[s], p1)
    assert bool(torch.isfinite(d2[0]).any()) and not bool(torch.isfinite(d2[2]).any())
    slots, found = pvh.voxel_map_lookup_slots(batched, pvh._voxel_coords(q, 0.5))
    for s in range(S):
        ws, wf = pvh.voxel_map_lookup_slots(single[s], pvh._voxel_coords(q[s], 0.5))
        assert torch.equal(slots[s], ws) and torch.equal(found[s], wf)


def test_batched_map_matches_vmapped_jax():
    """The batched map against the JAX package's vmapped map, (S, C, ...)
    leaves through interop: inserts, then forget + maybe_rehash, as the
    JAX batch runner's block step calls them under vmap."""
    rng = np.random.default_rng(15)
    S, C = 2, 1 << 10
    jins = jax.jit(jax.vmap(jvh.voxel_map_insert))
    jmap = jax.vmap(lambda _: jvh.voxel_map_create(capacity=C))(jnp.arange(S))
    pmap = _to_port(jmap)
    assert pmap.streams == S and pmap.keys.shape == (S, C, 3)
    for rnd in range(2):
        parts = [_batch(rng, B, 5.0, center=(3.0 * rnd + s, 0.0, 0.0), dup=10) for s in range(S)]
        arrays = [np.stack(x) for x in zip(*parts)]
        jmap = jins(jmap, *map(jnp.asarray, arrays))
        pmap = pvh.voxel_map_insert(pmap, *(torch.tensor(x) for x in arrays))
    _assert_same_map(pmap, jmap)
    center = np.asarray([[3.0, 0.0, 0.0], [-2.0, 1.0, 0.0]], np.float32)
    jmap = jax.vmap(lambda m, c: jvh.voxel_map_maybe_rehash(
        jvh.voxel_map_forget_far(m, c, 4.0), 0.05))(jmap, jnp.asarray(center))
    pmap = pvh.voxel_map_maybe_rehash(pvh.voxel_map_forget_far(pmap, torch.tensor(center), 4.0),
                                      0.05)
    _assert_same_map(pmap, jmap)
    # the JAX map's num_voxels sums over every axis of a vmapped map
    assert float(pmap.num_voxels.sum()) == float(jmap.num_voxels)
