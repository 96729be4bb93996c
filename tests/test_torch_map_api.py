"""Port parity of the ikd-Tree-style map API on the CPU: radius and box
searches, box and point deletes, the box delete that returns what it
removed, and the box re-add, against the JAX package.

The functions are masked selections and writes, so they must match bit for
bit: every table, the compacted points, masks and counts. They start from
the same table (a JAX-built map copied into the port), since the two
packages' inserts agree only within rtol 1e-5 on the Gaussian accumulators
(tests/test_torch_voxel_map.py). One case builds the map with each
package's own insert and holds the API's results to that insert's
tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icp4dradar_tpu.mapping import voxel_hash as jvh
from icp4dradar_tpu_torch.interop import (
    VOXEL_MAP_FIELDS,
    voxel_map_from_numpy,
    voxel_map_to_numpy,
)
from icp4dradar_tpu_torch.mapping import voxel_hash as pvh
from tests._torch_threads import one_torch_thread  # noqa: F401

B = 512
RTOL = 1e-5
_jinsert = jax.jit(jvh.voxel_map_insert)


def _batch(rng, n, extent, center=(0.0, 0.0, 0.0)):
    pts = (rng.uniform(-extent, extent, (n, 3)) + center).astype(np.float32)
    inten = rng.uniform(0, 30, n).astype(np.float32)
    mask = (rng.uniform(size=n) > 0.1).astype(np.float32)
    return pts, mask, inten


def _maps(seed=21):
    """A JAX map of three overlapping batches (capacity 2^12) and its port
    copy, and the batches' points."""
    rng = np.random.default_rng(seed)
    jmap = jvh.voxel_map_create(capacity=1 << 12, voxel_size=0.5)
    batches = []
    for k in range(3):
        pts, mask, inten = _batch(rng, B, 10.0, center=(3.0 * k, 0.0, 0.0))
        jmap = _jinsert(jmap, jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(inten))
        batches.append((pts, mask))
    pmap = voxel_map_from_numpy({k: np.asarray(getattr(jmap, k)) for k in VOXEL_MAP_FIELDS},
                                voxel_size=jmap.voxel_size, max_probes=jmap.max_probes,
                                device="cpu")
    return jmap, pmap, batches


def _assert_equal_maps(pmap, jmap):
    got = voxel_map_to_numpy(pmap)
    for k in VOXEL_MAP_FIELDS:
        np.testing.assert_array_equal(got[k], np.asarray(getattr(jmap, k)), err_msg=k)


def _assert_equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == torch.from_numpy(np.array(w)).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _tombstones(vmap):
    return int(((vmap.keys[:, 0] != pvh._EMPTY) & (vmap.occupied <= 0.5)).sum())


BOX_LO, BOX_HI = np.float32([-2.0, -4.0, -10.0]), np.float32([9.0, 5.0, 10.0])


@pytest.mark.parametrize("center,radius,out_size", [
    ((2.0, 1.0, 0.0), 6.0, 2048),       # room for every hit
    ((2.0, 1.0, 0.0), 6.0, 100),        # overflow: the first 100 in table order
    ((40.0, 0.0, 0.0), 3.0, 64),        # nothing inside
])
def test_radius_and_box_search_match_jax(center, radius, out_size):
    jmap, pmap, _ = _maps()
    c = np.float32(center)
    want = jvh.voxel_map_radius_search(jmap, jnp.asarray(c), radius, out_size)
    got = pvh.voxel_map_radius_search(pmap, torch.tensor(c), radius, out_size)
    _assert_equal(got, want)
    lo, hi = c - radius, c + radius
    want = jvh.voxel_map_box_search(jmap, jnp.asarray(lo), jnp.asarray(hi), out_size)
    got = pvh.voxel_map_box_search(pmap, torch.tensor(lo), torch.tensor(hi), out_size)
    _assert_equal(got, want)
    if center[0] < 10:
        assert int(got[2]) > 0


def test_delete_box_acquire_and_add_box_match_jax():
    """Box delete (tombstones: keys kept, Gaussians cleared), its acquiring
    form (the removed points, compacted), then a re-add of part of the box:
    revived tombstones keep zero statistics."""
    jmap, pmap, _ = _maps()
    jd = jvh.voxel_map_delete_box(jmap, jnp.asarray(BOX_LO), jnp.asarray(BOX_HI))
    pd = pvh.voxel_map_delete_box(pmap, torch.tensor(BOX_LO), torch.tensor(BOX_HI))
    _assert_equal_maps(pd, jd)
    assert 0 < int(pd.num_voxels) < int(pmap.num_voxels) and _tombstones(pd) > 0
    for out_size in (4096, 50):
        jres = jvh.voxel_map_delete_box_acquire(jmap, jnp.asarray(BOX_LO),
                                                jnp.asarray(BOX_HI), out_size)
        pres = pvh.voxel_map_delete_box_acquire(pmap, torch.tensor(BOX_LO),
                                                torch.tensor(BOX_HI), out_size)
        _assert_equal_maps(pres[0], jres[0])
        _assert_equal(pres[1:], jres[1:])
    assert int(pres[3]) == 50
    # the re-add: half the box, plus a box with nothing deleted in it
    lo, hi = BOX_LO, np.float32([3.0, 5.0, 10.0])
    ja = jvh.voxel_map_add_box(jd, jnp.asarray(lo), jnp.asarray(hi))
    pa = pvh.voxel_map_add_box(pd, torch.tensor(lo), torch.tensor(hi))
    _assert_equal_maps(pa, ja)
    assert int(pd.num_voxels) < int(pa.num_voxels) < int(pmap.num_voxels)
    revived = (pa.occupied > 0.5) & (pd.occupied <= 0.5)
    assert float(pa.stat_n[revived].abs().sum()) == 0.0
    far = np.float32([100.0, 100.0, 100.0])
    _assert_equal_maps(pvh.voxel_map_add_box(pd, torch.tensor(far), torch.tensor(far + 5)),
                       jvh.voxel_map_add_box(jd, jnp.asarray(far), jnp.asarray(far + 5)))


def test_deletes_count_as_tombstones_in_maybe_rehash():
    """Tombstones of a box delete trigger maybe_rehash exactly as in JAX:
    below the fraction the table is untouched, above it rebuilt."""
    jmap, pmap, _ = _maps()
    jd = jvh.voxel_map_delete_box(jmap, jnp.asarray(BOX_LO), jnp.asarray(BOX_HI))
    pd = pvh.voxel_map_delete_box(pmap, torch.tensor(BOX_LO), torch.tensor(BOX_HI))
    frac = _tombstones(pd) / pd.capacity
    for f in (frac * 0.5, frac * 2.0):
        _assert_equal_maps(pvh.voxel_map_maybe_rehash(pd, f), jvh.voxel_map_maybe_rehash(jd, f))
    assert pvh.voxel_map_maybe_rehash(pd, frac * 2.0) is pd
    rebuilt = pvh.voxel_map_maybe_rehash(pd, frac * 0.5)
    assert _tombstones(rebuilt) == 0 and float(rebuilt.num_voxels) == float(pd.num_voxels)


def test_delete_points_matches_jax():
    """Points delete their voxels; points whose voxel is not in the map, a
    voxel deleted twice in one call and masked points are no-ops."""
    jmap, pmap, batches = _maps()
    rng = np.random.default_rng(3)
    pts, _ = batches[1]
    pts = np.concatenate([pts[:200], pts[:20],                       # a voxel twice
                          rng.uniform(50, 60, (30, 3)).astype(np.float32)])  # unmatched
    mask = (rng.uniform(size=len(pts)) > 0.3).astype(np.float32)
    for m in (None, mask):
        want = jvh.voxel_map_delete_points(jmap, jnp.asarray(pts),
                                           None if m is None else jnp.asarray(m))
        got = pvh.voxel_map_delete_points(pmap, torch.tensor(pts),
                                          None if m is None else torch.tensor(m))
        _assert_equal_maps(got, want)
        assert 0 < _tombstones(got) <= 200
    assert _tombstones(got) < _tombstones(pvh.voxel_map_delete_points(pmap, torch.tensor(pts)))
    # deleting the deleted again changes nothing
    _assert_equal_maps(pvh.voxel_map_delete_points(got, torch.tensor(pts), torch.tensor(mask)),
                       want)


def test_api_on_maps_built_by_each_package():
    """The map built by each package's own insert from the same points: the
    API's selections agree exactly, its tables within the insert's
    tolerance on the Gaussian accumulators."""
    rng = np.random.default_rng(8)
    jmap = jvh.voxel_map_create(capacity=1 << 12)
    pmap = pvh.voxel_map_create(capacity=1 << 12, device="cpu")
    for k in range(2):
        pts, mask, inten = _batch(rng, B, 8.0, center=(2.0 * k, 0.0, 0.0))
        jmap = _jinsert(jmap, jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(inten))
        pmap = pvh.voxel_map_insert(pmap, torch.tensor(pts), torch.tensor(mask),
                                    torch.tensor(inten))
    c = np.float32([1.0, 0.0, 0.0])
    _assert_equal(pvh.voxel_map_radius_search(pmap, torch.tensor(c), 5.0, 1024),
                  jvh.voxel_map_radius_search(jmap, jnp.asarray(c), 5.0, 1024))
    jd, *jr = jvh.voxel_map_delete_box_acquire(jmap, jnp.asarray(BOX_LO),
                                               jnp.asarray(BOX_HI), 2048)
    pd, *pr = pvh.voxel_map_delete_box_acquire(pmap, torch.tensor(BOX_LO),
                                               torch.tensor(BOX_HI), 2048)
    _assert_equal(pr, jr)
    got = voxel_map_to_numpy(pvh.voxel_map_add_box(pd, torch.tensor(BOX_LO),
                                                   torch.tensor(c)))
    want = jvh.voxel_map_add_box(jd, jnp.asarray(BOX_LO), jnp.asarray(c))
    for k in VOXEL_MAP_FIELDS:
        w = np.asarray(getattr(want, k))
        if k.startswith("stat_"):
            np.testing.assert_allclose(got[k], w, rtol=RTOL, atol=RTOL * np.abs(w).max())
        else:
            np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_api_refuses_a_batched_map():
    vm = pvh.voxel_map_create(capacity=256, device="cpu", streams=2)
    z, one = torch.zeros(3), torch.ones(3)
    calls = [lambda: pvh.voxel_map_radius_search(vm, z, 1.0, 8),
             lambda: pvh.voxel_map_box_search(vm, z, one, 8),
             lambda: pvh.voxel_map_delete_box(vm, z, one),
             lambda: pvh.voxel_map_delete_points(vm, torch.zeros(4, 3)),
             lambda: pvh.voxel_map_add_box(vm, z, one),
             lambda: pvh.voxel_map_delete_box_acquire(vm, z, one, 8)]
    for call in calls:
        with pytest.raises(ValueError, match="single table"):
            call()
