"""Port nearest-neighbour parity on the CPU: the plain versions of the CUDA
1-NN kernels against the Pallas kernels run in interpret mode (as
tests/test_ops.py runs them), and the chunked k-NN against the JAX
package's.

Tolerances. 1-NN: equal indices, bit-equal d2 and equal coordinates (the
plain version forms d2 with the same fused multiply-adds as XLA evaluates
the Pallas body, and takes the smallest index among the exact minima).
k-NN: the same index sets; d2 within 1e-5 relative plus 2e-7 of the
largest |s|^2 + |t|^2 (both form |s|^2 - 2 s.t + |t|^2, whose terms cancel,
and the two libraries' (256 x 3) x (3 x M) products may round differently:
a few float32 ulps of the cancelling terms)."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from tests._torch_threads import one_torch_thread  # noqa: F401

# both packages' `ops` export a function `knn` that shadows the module
jknn = importlib.import_module("icp4dradar_tpu.ops.knn")
pknn = importlib.import_module("icp4dradar_tpu_torch.ops.knn")


def _cloud(rng, n, scale=60.0):
    return rng.uniform(-scale, scale, (n, 3)).astype(np.float32)


def _pallas(src, tgt, mask, coords=False, **kw):
    fn = jknn.nearest_neighbor_coords_pallas if coords else jknn.nearest_neighbor_pallas
    out = fn(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(mask), interpret=True, **kw)
    return tuple(np.asarray(x) for x in out)


def _plain(src, tgt, mask, coords=False):
    fn = pknn.nearest_neighbor_with_coords if coords else pknn.nearest_neighbor
    return tuple(x.numpy() for x in fn(torch.tensor(src), torch.tensor(tgt),
                                       torch.tensor(mask)))


@pytest.mark.parametrize("n,m,live", [
    (700, 5000, 0.7),      # three target tiles, ragged sources and targets
    (64, 2048, 1.0),       # one full tile, no mask
    (513, 4100, 0.05),     # sparse mask: most rows 1e30
    (3, 1, 1.0),           # one target
])
def test_nearest_neighbor_matches_pallas(n, m, live):
    rng = np.random.default_rng(n + m)
    src, tgt = _cloud(rng, n), _cloud(rng, m)
    mask = (rng.uniform(size=m) < live).astype(np.float32)
    mask[rng.integers(m)] = 1.0
    ji, jd = _pallas(src, tgt, mask)
    pi, pd = _plain(src, tgt, mask)
    assert pi.dtype == np.int32 and pd.dtype == np.float32
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_array_equal(pd, jd)
    assert (mask[pi] > 0.5).all()


def _tie_case():
    """Source 0 at the origin: rows 3 and 700 (tile 0 of 2048 rows) and
    row 2100 (tile 1) all lie at d2 = 5: row 3 wins. Source 1 at (20, 0,
    0): tile 0's best is row 5 at d2 = 9; rows 2500 and 3000 of tile 1 at
    d2 = 2 are strictly closer, and row 2500 wins."""
    rng = np.random.default_rng(11)
    tgt = (rng.uniform(60, 100, (4096, 3)) * rng.choice([-1.0, 1.0], (4096, 3)))
    tgt = tgt.astype(np.float32)
    tgt[3], tgt[700], tgt[2100] = (1, 2, 0), (1, -2, 0), (-1, 2, 0)
    tgt[5], tgt[2500], tgt[3000] = (20, 3, 0), (21, 0, 1), (19, 0, -1)
    src = np.asarray([[0, 0, 0], [20, 0, 0]], np.float32)
    return src, tgt, np.ones(4096, np.float32)


def test_exact_ties_within_and_across_tiles():
    src, tgt, mask = _tie_case()
    ji, jd = _pallas(src, tgt, mask)
    pi, pd = _plain(src, tgt, mask)
    np.testing.assert_array_equal(ji, [3, 2500])
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_array_equal(pd, [5.0, 2.0])
    np.testing.assert_array_equal(pd, jd)
    jd, jq = _pallas(src, tgt, mask, coords=True)
    pd, pq = _plain(src, tgt, mask, coords=True)
    np.testing.assert_array_equal(pq, [[1, 2, 0], [21, 0, 1]])
    np.testing.assert_array_equal(pq, jq)
    np.testing.assert_array_equal(pd, jd)


def test_all_targets_masked():
    rng = np.random.default_rng(5)
    src, tgt = _cloud(rng, 300), _cloud(rng, 2500)
    mask = np.zeros(2500, np.float32)
    ji, jd = _pallas(src, tgt, mask)
    pi, pd = _plain(src, tgt, mask)
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_array_equal(pd, jd)
    assert (pi == 0).all() and (pd == np.float32(1e30)).all()


@pytest.mark.parametrize("n,m", [(700, 5000), (100, 300)])
def test_nearest_neighbor_with_coords_matches_pallas(n, m):
    rng = np.random.default_rng(n * m)
    src, tgt = _cloud(rng, n), _cloud(rng, m)
    mask = (rng.uniform(size=m) > 0.3).astype(np.float32)
    jd, jq = _pallas(src, tgt, mask, coords=True)
    pd, pq = _plain(src, tgt, mask, coords=True)
    np.testing.assert_array_equal(pd, jd)
    np.testing.assert_array_equal(pq, jq)
    pi, _ = _plain(src, tgt, mask)
    np.testing.assert_array_equal(pq, tgt[pi])


def test_fma_rounds_once():
    """The plain version's float32 fused multiply-add is the correctly
    rounded a * b + c, checked against exact rational arithmetic."""
    from fractions import Fraction

    rng = np.random.default_rng(0)
    a = (rng.normal(size=2000) * 10.0 ** rng.integers(-3, 4, 2000)).astype(np.float32)
    b = (rng.normal(size=2000) * 10.0 ** rng.integers(-3, 4, 2000)).astype(np.float32)
    c = (rng.normal(size=2000) * 10.0 ** rng.integers(-6, 7, 2000)).astype(np.float32)
    got = pknn._fma(torch.tensor(a), torch.tensor(b), torch.tensor(c)).numpy()
    for x, y, z, g in zip(a, b, c, got):
        exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        lo = np.float32(float(exact))
        # the two float32 neighbours of the exact value; g must be the nearer
        cands = {lo, np.nextafter(lo, np.float32(np.inf)), np.nextafter(lo, np.float32(-np.inf))}
        errs = {v: abs(Fraction(float(v)) - exact) for v in cands}
        best = min(errs.values())
        assert errs[g] == best, (x, y, z, g)


@pytest.mark.parametrize("n,m,k,live", [(600, 900, 5, 0.8), (300, 300, 5, 1.0),
                                        (50, 40, 8, 0.1)])
def test_knn_matches_jax(n, m, k, live):
    rng = np.random.default_rng(n + m + k)
    src, tgt = _cloud(rng, n, 30.0), _cloud(rng, m, 30.0)
    mask = (rng.uniform(size=m) < live).astype(np.float32)
    ji, jd = (np.asarray(x) for x in jknn.knn(jnp.asarray(src), jnp.asarray(tgt), k,
                                             jnp.asarray(mask)))
    pi, pd = (x.numpy() for x in pknn.knn(torch.tensor(src), torch.tensor(tgt), k,
                                          torch.tensor(mask)))
    assert pi.shape == ji.shape == (n, k) and pi.dtype == np.int32
    valid = jd < 1e20
    np.testing.assert_array_equal(pd < 1e20, valid)
    for a, b, v in zip(pi, ji, valid):
        assert set(a[v]) == set(b[v])
    scale = (src * src).sum(-1).max() + (tgt * tgt).sum(-1).max()
    np.testing.assert_allclose(pd[valid], jd[valid], rtol=1e-5, atol=2e-7 * scale)
    assert (np.diff(pd, axis=1) >= 0).all()


def test_knn_ties_take_the_lower_index_first():
    tgt = np.asarray([[5, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1], [-1, 0, 0]],
                     np.float32)
    src = np.zeros((1, 3), np.float32)
    pi, pd = pknn.knn(torch.tensor(src), torch.tensor(tgt), 3)
    ji, jd = jknn.knn(jnp.asarray(src), jnp.asarray(tgt), 3)
    np.testing.assert_array_equal(pi.numpy(), [[1, 2, 3]])
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))


def test_cuda_tensors_never_take_the_plain_version(monkeypatch):
    """On the CPU the wrappers run the plain versions only because their
    tensors lie on the CPU; mixed devices raise, and so do bad shapes."""
    rng = np.random.default_rng(2)
    src, tgt = torch.tensor(_cloud(rng, 20)), torch.tensor(_cloud(rng, 30))
    calls = []
    for name in ("_nn_search_cuda", "_nn_pack_cuda"):
        monkeypatch.setattr(pknn, name, lambda *a, **k: calls.append(1))
    pknn.nearest_neighbor(src, tgt)
    pknn.nearest_neighbor_with_coords(src, tgt)
    pknn.nn_search(src, pknn.nn_prepare(tgt))
    pknn.nn_search_coords(src, pknn.nn_prepare(tgt))
    assert calls == []
    with pytest.raises(ValueError):
        pknn.nearest_neighbor(src, tgt, torch.ones(30, device="meta"))
    with pytest.raises(ValueError):
        pknn.nearest_neighbor_with_coords(src, tgt[:, :2])
    with pytest.raises(ValueError):
        pknn.nearest_neighbor(src, tgt[:0])
    with pytest.raises(ValueError):
        pknn.nn_search(src.to("meta"), pknn.nn_prepare(tgt))
    with pytest.raises(ValueError):
        pknn.nn_search_coords(src[:, :2], pknn.nn_prepare(tgt))
    with pytest.raises(ValueError):
        pknn.nn_prepare(tgt.to("meta"), torch.ones(30, device="meta"))


# ---- the prepared search (`nn_prepare` + `nn_search`, the plain version on
# the packed layout) against the Pallas kernel in interpret mode: equal
# indices and bit-equal d2.

def _scattered():
    """Live rows scattered among masked rows (20% live), some masked rows
    right at the sources."""
    rng = np.random.default_rng(41)
    src, tgt = _cloud(rng, 300, 30.0), _cloud(rng, 4096, 30.0)
    mask = (rng.uniform(size=4096) < 0.2).astype(np.float32)
    tgt[np.flatnonzero(mask == 0)[:50]] = src[:50]
    return src, tgt, mask


def _ties_between_masked():
    """Rows 0-9 masked, live rows 10 and 50 at d2 = 5 from source 0 with
    masked rows between them lying on the source: row 10 wins. Rows 70 and
    3000 tie at d2 = 2 for source 1 behind a masked row at its position:
    row 70 wins."""
    tgt = np.full((4096, 3), 90.0, np.float32)
    mask = np.ones(4096, np.float32)
    mask[:10] = 0.0
    mask[11:50] = 0.0
    tgt[:10] = tgt[11:50] = 0.0
    tgt[10], tgt[50] = (1, 2, 0), (1, -2, 0)
    tgt[70], tgt[3000] = (21, 0, 1), (19, 0, -1)
    tgt[60], mask[60] = (20, 0, 0), 0.0
    src = np.asarray([[0, 0, 0], [20, 0, 0]], np.float32)
    return src, tgt, mask


def _all_masked():
    rng = np.random.default_rng(43)
    return _cloud(rng, 200), _cloud(rng, 2500), np.zeros(2500, np.float32)


def _far_live_row():
    """One live row 2e15 m away, the rest masked: its d2 (4e30) is not below
    the penalty, so masked row 0 wins at d2 1e30."""
    rng = np.random.default_rng(44)
    src, tgt = _cloud(rng, 100), _cloud(rng, 1000)
    mask = np.zeros(1000, np.float32)
    tgt[7], mask[7] = (2e15, 0, 0), 1.0
    return src, tgt, mask


PREPARED_CASES = {"scattered": _scattered, "ties_between_masked": _ties_between_masked,
                  "all_masked": _all_masked, "far_live_row": _far_live_row}


@pytest.mark.parametrize("case", sorted(PREPARED_CASES))
def test_prepared_search_matches_pallas(case):
    src, tgt, mask = PREPARED_CASES[case]()
    ji, jd = _pallas(src, tgt, mask)
    ops = pknn.nn_prepare(torch.tensor(tgt), torch.tensor(mask))
    pi, pd = (x.numpy() for x in pknn.nn_search(torch.tensor(src), ops))
    assert pi.dtype == np.int32 and pd.dtype == np.float32
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_array_equal(pd, jd)
    if case == "ties_between_masked":
        np.testing.assert_array_equal(pi, [10, 70])
        np.testing.assert_array_equal(pd, [5.0, 2.0])
    if case in ("all_masked", "far_live_row"):
        assert (pi == 0).all() and (pd == np.float32(1e30)).all()


def test_nn_prepare_packs_live_rows_first():
    src, tgt, mask = _scattered()
    ops = pknn.nn_prepare(torch.tensor(tgt), torch.tensor(mask))
    live = np.flatnonzero(mask > 0.5)
    order = np.concatenate([live, np.flatnonzero(mask <= 0.5)])
    assert ops.count.tolist() == [len(live)] and ops.count.dtype == torch.int32
    np.testing.assert_array_equal(ops.orig.numpy(), order)
    np.testing.assert_array_equal(ops.rows[:, :3].numpy(), tgt[order])
    assert float(ops.rows[:, 3].abs().max()) == 0.0 and ops.rows.is_contiguous()
    assert ops.cluster == 2 and pknn.nn_prepare(torch.tensor(tgt[:2048])).cluster == 1
    assert pknn.nn_prepare(torch.zeros((16384, 3))).cluster == 8


@pytest.mark.parametrize("n,m,live", [(300, 4096, 0.1), (64, 700, 1.0)])
def test_prepared_search_equals_per_call(n, m, live):
    """One preparation serves every search of a registration: at several
    source positions it gives what the per-call `nearest_neighbor` and the
    all-rows plain version give."""
    rng = np.random.default_rng(n + m)
    tgt = torch.tensor(_cloud(rng, m, 30.0))
    mask = torch.tensor((rng.uniform(size=m) < live).astype(np.float32))
    ops = pknn.nn_prepare(tgt, mask)
    for step in range(3):
        src = torch.tensor(_cloud(rng, n, 30.0))
        got = pknn.nn_search(src, ops)
        for want in (pknn.nearest_neighbor(src, tgt, mask),
                     pknn.nearest_neighbor_plain(src, tgt, mask)):
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_k_smallest_is_the_stable_sort_prefix():
    """The k-NN selection equals the first k columns of a stable sort (the
    lower index first among equal values) on rows full of ties, with +inf
    and 1e30 entries and k at the row length."""
    g = torch.Generator().manual_seed(0)
    for trial in range(100):
        r = int(torch.randint(1, 30, (1,), generator=g))
        m = int(torch.randint(5, 200, (1,), generator=g))
        k = int(torch.randint(1, 6, (1,), generator=g))
        d = torch.randint(0, 6, (r, m), generator=g).float()
        d[d == 4] = np.inf
        d[d == 5] = 1e30
        if trial % 4 == 0:
            k = m
        want_d, want_i = torch.sort(d, dim=-1, stable=True)
        got_i, got_d = pknn.k_smallest(d, k)
        assert torch.equal(got_i, want_i[:, :k]), trial
        assert torch.equal(got_d, want_d[:, :k]), trial


# ---- the coordinate search on prepared targets (`nn_search_coords`, and the
# per-call `nearest_neighbor_with_coords` built on it) against the Pallas
# coordinate kernel in interpret mode: bit-equal d2 and coordinates.

def _ragged():
    """777 sources (not a multiple of the kernel's 128) against 5001 rows,
    30% masked at random."""
    rng = np.random.default_rng(45)
    src, tgt = _cloud(rng, 777), _cloud(rng, 5001)
    return src, tgt, (rng.uniform(size=5001) > 0.3).astype(np.float32)


def _ties_across_ranks():
    """16,384 rows (a cluster of 8 on the card), 2000 live at random: the
    live rows split 250 a rank. Source 0 ties at d2 = 5 between the 3rd and
    the 1500th live row (ranks 0 and 6): the first wins. Source 1 ties at
    d2 = 2 between the 700th and 1900th, with a masked row on it."""
    rng = np.random.default_rng(46)
    tgt = (rng.uniform(60, 100, (16384, 3)) * rng.choice([-1.0, 1.0], (16384, 3)))
    tgt = tgt.astype(np.float32)
    mask = np.zeros(16384, np.float32)
    live = np.sort(rng.choice(16384, 2000, replace=False))
    mask[live] = 1.0
    tgt[live[3]], tgt[live[1500]] = (1, 2, 0), (1, -2, 0)
    tgt[live[700]], tgt[live[1900]] = (21, 0, 1), (19, 0, -1)
    dead = np.flatnonzero(mask == 0)[5]
    tgt[dead] = (20, 0, 0)
    src = np.asarray([[0, 0, 0], [20, 0, 0]], np.float32)
    return src, tgt, mask


COORDS_CASES = {**PREPARED_CASES, "ragged": _ragged, "ties_across_ranks": _ties_across_ranks}


@pytest.mark.parametrize("case", sorted(COORDS_CASES))
def test_coords_search_matches_pallas(case):
    src, tgt, mask = COORDS_CASES[case]()
    jd, jq = _pallas(src, tgt, mask, coords=True)
    ops = pknn.nn_prepare(torch.tensor(tgt), torch.tensor(mask))
    for pd, pq in (pknn.nn_search_coords(torch.tensor(src), ops),
                   pknn.nearest_neighbor_with_coords(torch.tensor(src), torch.tensor(tgt),
                                                     torch.tensor(mask)),
                   pknn.nearest_neighbor_with_coords_plain(torch.tensor(src),
                                                           torch.tensor(tgt),
                                                           torch.tensor(mask))):
        assert pd.dtype == pq.dtype == torch.float32 and tuple(pq.shape) == (len(src), 3)
        np.testing.assert_array_equal(pd.numpy(), jd)
        np.testing.assert_array_equal(pq.numpy(), jq)
    pi, _ = pknn.nn_search(torch.tensor(src), ops)
    np.testing.assert_array_equal(jq, tgt[pi.numpy()])
    if case == "ties_across_ranks":
        live = np.flatnonzero(mask > 0.5)
        np.testing.assert_array_equal(pi.numpy(), [live[3], live[700]])
        np.testing.assert_array_equal(jd, [5.0, 2.0])
    if case in ("all_masked", "far_live_row"):
        np.testing.assert_array_equal(jq, np.broadcast_to(tgt[0], jq.shape))


# ---- the stream axis (a batch of kNN-GICP registrations): S target sets
# packed in one call and searched in one call, each stream as alone


def _streams(rng, S, n, m, lives):
    src = np.stack([_cloud(rng, n) for _ in range(S)])
    tgt = np.stack([_cloud(rng, m) for _ in range(S)])
    mask = np.stack([(rng.uniform(size=m) < live).astype(np.float32) for live in lives])
    return src, tgt, mask


@pytest.mark.parametrize("S,n,m,lives", [
    (3, 200, 700, (0.7, 0.0, 1.0)),     # a stream with every row masked
    (2, 130, 2049, (0.05, 0.5)),        # across the cluster's 2048-row ranks
    (1, 5, 3, (1.0,)),
])
def test_stream_axis_equals_single_target_calls(S, n, m, lives):
    """`nn_prepare` on (S, M, 3) targets and `nn_search` on (S, N, 3)
    sources (their plain versions on the CPU) equal S single-target calls
    bit for bit: packed rows, original indices, live counts, indices and
    d2; the coordinate search with the stream axis gathers each stream's
    own rows."""
    rng = np.random.default_rng(S + n + m)
    src, tgt, mask = (torch.from_numpy(x) for x in _streams(rng, S, n, m, lives))
    ops = pknn.nn_prepare(tgt, mask)
    assert ops.streams == S and ops.count.shape == (S,) and ops.rows.shape == (S, m, 4)
    idx, d2 = pknn.nn_search(src, ops)
    cd, cq = pknn.nn_search_coords(src, ops)
    assert idx.shape == d2.shape == (S, n) and cq.shape == (S, n, 3)
    for s in range(S):
        one = pknn.nn_prepare(tgt[s], mask[s])
        for a, b in zip((ops.rows[s], ops.orig[s], ops.count[s:s + 1]),
                        (one.rows, one.orig, one.count)):
            assert torch.equal(a, b)
        i1, d1 = pknn.nn_search(src[s], one)
        assert torch.equal(idx[s], i1) and torch.equal(d2[s], d1)
        assert torch.equal(cd[s], d1) and torch.equal(cq[s], tgt[s][i1.long()])


@pytest.mark.parametrize("S,n,m", [(3, 96, 700), (2, 40, 2100)])
def test_stream_axis_matches_vmapped_pallas(S, n, m):
    """The stream axis against the Pallas kernel vmapped over the streams
    (`jax.vmap` of `nearest_neighbor_pallas`, interpret mode), as the JAX
    package's batch vmaps `gicp_align`: equal indices and d2."""
    import jax

    rng = np.random.default_rng(S * n + m)
    src, tgt, mask = _streams(rng, S, n, m, [0.6] * S)
    mask[:, 0] = 1.0
    ji, jd = jax.vmap(lambda s, t, k: jknn.nearest_neighbor_pallas(s, t, k, interpret=True))(
        jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(mask))
    pi, pd = pknn.nn_search(torch.from_numpy(src),
                            pknn.nn_prepare(torch.from_numpy(tgt), torch.from_numpy(mask)))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))


def test_stream_axis_rejects_mismatched_sources():
    rng = np.random.default_rng(9)
    src, tgt, mask = (torch.from_numpy(x) for x in _streams(rng, 2, 10, 20, (1.0, 1.0)))
    ops = pknn.nn_prepare(tgt, mask)
    with pytest.raises(ValueError):
        pknn.nn_search(src[0], ops)                  # no stream axis
    with pytest.raises(ValueError):
        pknn.nn_search(torch.cat([src, src]), ops)   # 4 streams against 2
    with pytest.raises(ValueError):
        pknn.nn_prepare(tgt, mask[0])
