"""The port's sharded voxel map and ring VGICP
(`icp4dradar_tpu_torch.parallel.sharded_map`, `ring_vgicp` and the ring ops
of `ops/vgicp_fused.py`) on two gloo ranks on the CPU, against the JAX
package's functions on a 2-device mesh (devices 0 and 1 of the 8 virtual
CPU devices) and against the port's single-device functions, on the same
numpy inputs.

One module fixture spawns the rank work of `tests/_torch_dist_sharded.py`
once, at world size 2, and computes the JAX references meanwhile. Inputs are tests/test_sharded_map.py's and
tests/test_parallel.py's ring cases, made from seeds.

Tolerances:
- the sharded tables against JAX's sharded tables and against the port's
  single-device map: tests/test_sharded_map.py's content comparison
  (each occupied voxel's point rounded to 1e-5 and its count equal); the
  rehash slot for slot (its claims arbitrate by the global old-slot index
  in all three); JAX's sharded tables, which fill slots in the same probe
  rounds, key for key and occupancy for occupancy, the Gaussian sums
  within 1e-5 of their largest entry;
- the sector query: the same row set and count as JAX's (rank order of
  the blocks, points and stats within 1e-5);
- the ring normal equations: tests/test_parallel.py's 1e-4 (rtol and
  atol) against the port's `vgicp_iteration` on the whole target;
  against JAX's ring, tests/test_torch_vgicp.py's 1e-4 of the largest
  entry plus 1e-3 (JAX sums ~1e3-sized terms of H in float32, the port in
  float64: an entry of ~12 read 2.5e-3 apart); wsum equal to both. The
  JAX CPU ring matches with expanded distances and its first argmin, the
  port's plain K4 with exact distances (no exact ties on this data);
- the ring alignment: the known offset recovered within 1e-2
  (tests/test_parallel.py) and within 1e-4 of JAX's transform;
- the frozen step's plain version (K5's twin) against JAX's
  `vgicp_accumulators_from_best_xla` on the same rows, stale and
  never-matched rows included: tests/test_torch_vgicp.py's 1e-4 of the
  largest entry plus 1e-3; `merge_best_rows` exactly."""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icp4dradar_tpu import parallel as jpar
from icp4dradar_tpu.geom import se3_exp as j_se3_exp
from icp4dradar_tpu.mapping.voxel_hash import voxel_map_forget_far as j_forget
from icp4dradar_tpu.ops import vgicp_fused as jv
from icp4dradar_tpu_torch.mapping import voxel_map_create, voxel_map_insert
from icp4dradar_tpu_torch.geom.se3 import se3_apply, se3_exp, se3_inverse, se3_log
from icp4dradar_tpu_torch.mapping.voxel_hash import (
    voxel_map_forget_far,
    voxel_map_rehash,
    voxel_map_sector_search_with_stats,
)
from icp4dradar_tpu_torch.ops import vgicp_fused as pv
from icp4dradar_tpu_torch.parallel.dryrun import run_on_ranks
from tests._torch_dist_sharded import TABLES, map_case
from tests._torch_threads import one_torch_thread  # noqa: F401

EMPTY = 0x7FFFFFFF


NB, CAP = 600, 1 << 12      # insert batches padded to NB rows


def _batch(x):
    """Points (n, 3) -> (NB, 3) and their mask (NB,), padded with masked
    rows."""
    pts = np.zeros((NB, 3), np.float32)
    pts[:len(x)] = x
    return pts, (np.arange(NB) < len(x)).astype(np.float32)


def _inputs() -> dict:
    rng = np.random.default_rng(42)
    pts, msk = _batch(rng.uniform(-20, 20, (600, 3)).astype(np.float32))
    msk *= (rng.uniform(size=NB) > 0.1).astype(np.float32)
    batches = dict(pts=(pts, msk), b=_batch(rng.uniform(-10, 10, (200, 3)).astype(np.float32)))
    N, M = 256, 512
    src = rng.uniform(-30, 30, (N, 3)).astype(np.float32)
    smask = (rng.uniform(size=N) > 0.1).astype(np.float32)
    scov = pv.radar_point_covariances_packed(torch.from_numpy(src)).numpy()
    tgt = rng.uniform(-30, 30, (M, 3)).astype(np.float32)
    tcov = np.abs(rng.normal(0.05, 0.02, (M, 6))).astype(np.float32)
    tmask = (rng.uniform(size=M) > 0.2).astype(np.float32)
    T = se3_exp(torch.tensor([0.1, -0.2, 0.05, 0.02, 0.0, 0.1])).numpy()
    atgt = rng.uniform(-30, 30, (M, 3)).astype(np.float32)
    atcov = np.broadcast_to(np.asarray([0.02, 0.02, 0.02, 0, 0, 0], np.float32), (M, 6)).copy()
    T_true = se3_exp(torch.tensor([0.2, -0.1, 0.05, 0.01, -0.02, 0.03]))
    asrc = se3_apply(se3_inverse(T_true), torch.from_numpy(atgt))
    ascov = pv.radar_point_covariances_packed(asrc).numpy()
    ones = np.ones(M, np.float32)
    return dict(batches=batches,
                ring=dict(T=T, src=src, smask=smask, scov=scov, tgt=tgt, tcov=tcov,
                          tmask=tmask),
                align=dict(src=asrc.numpy(), smask=ones, scov=ascov, tgt=atgt, tcov=atcov,
                           tmask=ones, T_true=T_true.numpy()))


def _jnp_tables(vm):
    return {k: np.asarray(getattr(vm, k)) for k in TABLES}


def _jax_references() -> dict:
    """The JAX package's sharded functions on make_mesh(2) (devices 0 and 1
    of tests/conftest.py's 8 virtual CPU devices)."""
    inp, mesh, out = _inputs(), jpar.make_mesh(2), {}
    bat = {k: tuple(map(jnp.asarray, v)) for k, v in inp["batches"].items()}

    def insert(sm, k):
        return jpar.sharded_map_insert(sm, mesh, *bat[k])

    # every call of the JAX package's sharded insert compiles anew: the
    # cases chain on two inserts
    sm = insert(jpar.sharded_map_create(mesh, capacity=CAP), "pts")
    out["insert"] = _jnp_tables(sm)
    sm = insert(sm, "b")
    out["incremental"] = _jnp_tables(sm)
    out["sector"] = [np.asarray(x) for x in jpar.sharded_sector_search_with_stats(
        sm, mesh, jnp.zeros(3), 30.0, jnp.asarray(0.0), 180.0, 1024)]
    sm = j_forget(sm, jnp.zeros(3), 12.0)
    out["rehash"] = _jnp_tables(jpar.sharded_map_rehash(sm, mesh))
    r = inp["ring"]
    out["ring_ne"] = [np.asarray(x) for x in jpar.ring_vgicp_normal_equations(
        *(jnp.asarray(r[k]) for k in ("T", "src", "smask", "scov", "tgt", "tcov", "tmask")),
        mesh)]
    a = inp["align"]
    out["ring_align"] = [np.asarray(x) for x in jpar.ring_vgicp_align(
        *(jnp.asarray(a[k]) for k in ("src", "smask", "scov", "tgt", "tcov", "tmask")), mesh)]
    return out


@pytest.fixture(scope="module")
def case():
    """The inputs, the rank results at world size 2 (a list of the two
    ranks' results) and the JAX references, computed here while the ranks
    work."""
    inp, got = _inputs(), {}
    ranks = threading.Thread(target=lambda: got.update(ranks=run_on_ranks(map_case, 2, inp)))
    ranks.start()
    try:
        refs = _jax_references()
    finally:
        ranks.join()
    if "ranks" not in got:
        raise RuntimeError("the ranks returned no result")
    return dict(inp=inp, ranks=got["ranks"], jax=refs)


def _voxels(t) -> dict:
    """tests/test_sharded_map.py's content: voxel -> (point rounded to
    1e-5, count)."""
    occ = np.asarray(t["occupied"]) > 0.5
    keys = map(tuple, np.asarray(t["keys"])[occ])
    pts = np.asarray(t["points"])[occ]
    return dict(zip(keys, zip(map(tuple, np.round(pts, 5)), np.asarray(t["stat_n"])[occ])))


def _single(*batches, capacity=CAP):
    vm = voxel_map_create(capacity, device="cpu")
    for b in batches:
        vm = voxel_map_insert(vm, *(torch.from_numpy(x) for x in b))
    return vm


def _port_tables(vm) -> dict:
    return {k: getattr(vm, k).numpy() for k in TABLES}


def _close_to_largest(a, b, rel=1e-5):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, atol=rel * max(np.abs(b).max(), 1e-30))


def _same_slots_as_jax(got, want):
    """The same probe rounds fill the same slots: keys and occupancy equal,
    points and counts equal, the Gaussian sums within 1e-5 of their largest
    entry (their scatter-adds may add in another order)."""
    for k in ("keys", "occupied", "points", "intensity", "stat_n"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("stat_sum", "stat_sq"):
        _close_to_largest(got[k], want[k])


def test_ranks_agree(case):
    """Every result, the gathered tables included, is the same on both
    ranks; a capacity or a target that the mesh does not divide raises."""
    r0, r1 = case["ranks"]
    for k in ("insert", "incremental", "forgotten", "rehash"):
        for t in TABLES:
            np.testing.assert_array_equal(r0[k][t], r1[k][t])
    for a, b in zip(r0["ring_ne"] + r0["ring_align"], r1["ring_ne"] + r1["ring_align"]):
        np.testing.assert_array_equal(a, b)
    assert r0["capacity_mod_n_raises"] and r0["rows_mod_n_raises"]


@pytest.mark.parametrize("name", ["insert", "incremental"])
def test_sharded_insert_matches_jax_and_single_device(case, name):
    """One masked insert (600 points in 40 m, 10% of them masked), then a
    second (200 points in 20 m), at capacity 2^12: the gathered table holds the voxel
    content of JAX's sharded map and of the port's single-device
    `voxel_map_insert` on the same points, and fills JAX's slots."""
    bat, got = case["inp"]["batches"], case["ranks"][0][name]
    single = _single(bat["pts"]) if name == "insert" else _single(bat["pts"], bat["b"])
    assert _voxels(got) == _voxels(case["jax"][name]) == _voxels(_port_tables(single))
    assert float(got["occupied"].sum()) == float(single.num_voxels) > 0
    _same_slots_as_jax(got, case["jax"][name])


def test_sharded_rehash_matches_jax_and_single_device(case):
    """forget-far (12 m) then the distributed rehash: no tombstone left;
    every table slot for slot the port's single-device `voxel_map_rehash`
    of the same (gathered) map, the keys slot for slot JAX's sharded
    rehash; the content that of the port's single-device insert, forget
    and rehash (whose sort-based insert fills other slots first); the
    trigger (`shard_local_maybe_rehash`) keeps the map below its fraction
    and rehashes above it."""
    r0 = case["ranks"][0]
    got = r0["rehash"]
    forgotten = r0["forgotten"]
    same_map = voxel_map_rehash(voxel_map_create(CAP, device="cpu").with_tables(
        torch.from_numpy(forgotten[k]) for k in TABLES))
    bat = case["inp"]["batches"]
    single = voxel_map_rehash(voxel_map_forget_far(_single(bat["pts"], bat["b"]),
                                                   torch.zeros(3), 12.0))
    tombs = np.sum((got["keys"][:, 0] != EMPTY) & (got["occupied"] <= 0.5))
    assert tombs == 0
    assert np.sum((forgotten["keys"][:, 0] != EMPTY) & (forgotten["occupied"] <= 0.5)) > 0
    for t in TABLES:
        np.testing.assert_array_equal(got[t], getattr(same_map, t).numpy(), err_msg=t)
    np.testing.assert_array_equal(got["keys"], case["jax"]["rehash"]["keys"])
    assert _voxels(got) == _voxels(_port_tables(single)) == _voxels(case["jax"]["rehash"])
    assert r0["kept_below_trigger"]
    for t in TABLES:
        np.testing.assert_array_equal(r0["maybe_rehash"][t], got[t])


def test_sharded_sector_query_matches_jax(case):
    """The sector query (30 m, the full circle, out 1024) on the map of both
    inserts: the blocks of both shards in rank order as JAX's, the count
    summed; its count and row set the single-device query's on the
    single-device map."""
    r0 = case["ranks"][0]
    pts, m, cnt, mu, cov = r0["sector"]
    jpts, jm, jcnt, jmu, jcov = case["jax"]["sector"]
    bat = case["inp"]["batches"]
    spts, sm, scnt, _, _ = voxel_map_sector_search_with_stats(
        _single(bat["pts"], bat["b"]), torch.zeros(3), 30.0, torch.tensor(0.0), 180.0, 1024)
    assert int(cnt) == int(jcnt) == int(scnt) > 0
    assert r0["num_voxels"] > int(cnt)           # voxels outside 30 m are left out
    np.testing.assert_array_equal(m, jm)
    for a, b in ((pts, jpts), (mu, jmu), (cov, jcov)):
        _close_to_largest(a, b)
    assert set(map(tuple, np.round(pts[m > 0.5], 4))) == \
        set(map(tuple, np.round(spts.numpy()[sm.numpy() > 0.5], 4)))


def test_ring_normal_equations_match_jax_and_single_device(case):
    """n = 2 against the port's single-device `vgicp_iteration` over the
    whole target (256 sources, 512 targets, 20% masked): 1e-4, wsum equal;
    against JAX's ring on its 2-device mesh, whose sums run in float32:
    1e-4 of the largest entry plus 1e-3, wsum equal."""
    r = case["inp"]["ring"]
    got = case["ranks"][0]["ring_ne"]
    single = [x.numpy() for x in pv.vgicp_iteration(
        *(torch.from_numpy(r[k]) for k in ("T", "src", "smask", "scov", "tgt", "tcov",
                                            "tmask")))]
    for ref, largest in ((single, False), (case["jax"]["ring_ne"], True)):
        for a, b in zip(got[:3], ref[:3]):
            b = np.asarray(b)
            atol = 1e-4 * np.abs(b).max() + 1e-3 if largest else 1e-4
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=atol)
        assert float(got[3]) == float(ref[3]) > 0
        np.testing.assert_allclose(float(got[4]), float(ref[4]), rtol=1e-4)


def test_ring_align_recovers_a_known_offset(case):
    """tests/test_parallel.py's case: the scan is its own target moved by a
    known SE(3) offset; the ring GN recovers it (1e-2 of se3_log), as
    JAX's does, within 1e-4 of JAX's transform."""
    T, fit, iters = case["ranks"][0]["ring_align"]
    jT, jfit, jiters = case["jax"]["ring_align"]
    T_true = torch.from_numpy(case["inp"]["align"]["T_true"])
    err = float(se3_log(se3_inverse(torch.from_numpy(T)) @ T_true).abs().max())
    assert err < 1e-2, err
    assert int(iters) >= 1 and float(fit) < 0.05
    np.testing.assert_allclose(T, jT, atol=1e-4)
    assert abs(int(iters) - int(jiters)) <= 1


def _frozen_rows(seed=3, n=300, P=400):
    """A sweep's matched rows at T0 for n sources, then rows made stale (d2
    set past 2.5e29) and rows that never matched (d2 1e30, zero payload),
    and the transform T1 they are re-linearised at."""
    rng = np.random.default_rng(seed)
    src = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
    smask = (rng.uniform(size=n) > 0.1).astype(np.float32)
    scov = np.asarray(jv.radar_point_covariances_packed(jnp.asarray(src)))
    tgt = rng.uniform(-20, 20, (P, 3)).astype(np.float32)
    tcov = np.abs(rng.normal(0.05, 0.02, (P, 6))).astype(np.float32)
    T0 = j_se3_exp(jnp.asarray([0.05, -0.1, 0.02, 0.01, 0.0, 0.03], jnp.float32))
    rows = np.array(jv.vgicp_sweep_best_xla(T0, jnp.asarray(src), jnp.asarray(tgt),
                                            jnp.asarray(tcov), jnp.ones(P)))
    rows[::17, 0] = 3e29                                    # stale
    rows[5::23] = 0.0
    rows[5::23, 0] = 1e30                                   # never matched
    T1 = np.asarray(j_se3_exp(jnp.asarray([0.08, -0.12, 0.0, 0.012, 0.004, 0.03],
                                          jnp.float32)))
    return T1, src, smask, scov, rows


def _blocked(rows, ts=2048):
    """(n, 10) rows -> the (ns, 10, ts') `return_best` layout of n sources
    (ts' = min(ts, max(8, n)), as `vgicp_prepare` blocks them), the inverse
    of `best_payload_to_rows`; pad rows never matched (d2 1e30)."""
    n = rows.shape[0]
    ts = min(ts, max(8, n))
    fill = rows.new_zeros(((-n) % ts, 10))
    fill[:, 0] = 1e30
    return torch.cat([rows, fill]).reshape(-1, ts, 10).transpose(1, 2).contiguous()


def test_frozen_plain_matches_jax_accumulators_from_best():
    """K5's plain version (`vgicp_iteration_frozen` on CPU tensors, the rows
    re-blocked into the `return_best` layout) against JAX's
    `vgicp_accumulators_from_best_xla` on the same rows, stale and
    never-matched rows included: 1e-4 of the largest entry plus 1e-3."""
    T1, src, smask, scov, rows = _frozen_rows()
    want = jax.jit(jv.vgicp_accumulators_from_best_xla)(
        *(jnp.asarray(x) for x in (T1, src, smask, scov, rows)))
    got = pv.vgicp_iteration_frozen(*(torch.from_numpy(x) for x in (T1, src, smask, scov)),
                                    _blocked(torch.from_numpy(rows)))
    for a, b in zip(got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4,
                                   atol=1e-4 * np.abs(b).max() + 1e-3)
    np.testing.assert_array_equal(
        pv.best_payload_to_rows(_blocked(torch.from_numpy(rows)), len(rows)).numpy(), rows)


def test_merge_best_rows_matches_jax():
    """Strictly smaller d2 wins, equal d2 keeps the first payload: rows and
    the blocked layout, against JAX's merge on the rows."""
    rng = np.random.default_rng(5)
    a = rng.normal(size=(64, 10)).astype(np.float32)
    b = rng.normal(size=(64, 10)).astype(np.float32)
    a[:, 0], b[:, 0] = rng.integers(0, 4, 64), rng.integers(0, 4, 64)   # many equal d2
    a[:8, 0] = 1e30
    want = np.asarray(jv.merge_best_rows(jnp.asarray(a), jnp.asarray(b)))
    got = pv.merge_best_rows(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.array_equal(got[a[:, 0] == b[:, 0]], a[a[:, 0] == b[:, 0]])
    blocked = pv.merge_best_rows(_blocked(torch.from_numpy(a)), _blocked(torch.from_numpy(b)))
    np.testing.assert_array_equal(pv.best_payload_to_rows(blocked, 64).numpy(), want)
