"""The port's pose-graph back end (`icp4dradar_tpu_torch.graph`) on the CPU
against the JAX package's, on the same numpy inputs: the five residuals
and `quat_slerp`, the per-factor Jacobians against `jax.jacfwd`'s, the
dense normal equations of a K = 8 graph with every factor type, the block
assembly against the dense H, the block-tridiagonal Cholesky and solve,
one `solve_block_step`, both optimisers to convergence, and
`split_chain_loops`; and, port only, the block solver on a long chain.

Tolerances (float32 on both sides, different operation orders):
- residuals and slerp: atol 1e-5 (values of order 1-10);
- Jacobians: rtol 1e-5, atol 1e-6 (jacfwd through the same functions);
- normal equations: H and g within 1e-5 of their largest entry, cost rtol
  1e-5;
- block Cholesky and solve: 1e-5 of the largest entry;
- one block step: poses within 1e-5; the optimisers: poses within 1e-4 m,
  cost rtol 1e-4 (a PCG that stops one iteration apart moves the last
  digits); the dense and block solvers with Huber weights: 1e-3 m;
- `split_chain_loops`: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icp4dradar_tpu import graph as jg
from icp4dradar_tpu.config import PoseGraphConfig as JaxPoseGraphConfig
from icp4dradar_tpu.geom import se3_exp as jax_se3_exp
from icp4dradar_tpu.geom.so3 import quat_slerp as jax_quat_slerp
from icp4dradar_tpu.graph import block_solver as jbs
from icp4dradar_tpu_torch import graph as pg
from icp4dradar_tpu_torch.config import PoseGraphConfig
from icp4dradar_tpu_torch.geom import quat_slerp
from icp4dradar_tpu_torch.graph import block_solver as pbs
from icp4dradar_tpu_torch.graph import gauss_newton as pgn
from icp4dradar_tpu_torch.interop import POSE_GRAPH_FACTOR_FIELDS, pose_graph_from_numpy
from tests._torch_threads import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")


def _exp(xi):
    return np.asarray(jax_se3_exp(jnp.asarray(np.asarray(xi, np.float32))))


def _body(T, world):
    return np.einsum("pji,pj->pi", T[:, :3, :3], world - T[:, :3, 3])


def loop_graph(K, radius, n_loops, drift_sigma, seed):
    """tests/test_graph.py's circle: random-walk drift on the poses, exact
    chain measurements (weight 100), n_loops closures across the circle
    (weight 10). numpy arrays: (gt, poses, rel dict)."""
    rng = np.random.default_rng(seed)
    gt = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    th = 2 * np.pi * np.arange(K) / K
    gt[:, :3, 3] = np.stack([radius * np.cos(th), radius * np.sin(th), 0.01 * np.arange(K)], -1)
    poses = gt.copy()
    drift = np.eye(4, dtype=np.float32)
    for k in range(1, K):
        drift = _exp(rng.normal(0, drift_sigma, 6)) @ drift
        poses[k] = drift @ poses[k]
    ci = np.arange(K - 1, dtype=np.int32)
    li = rng.integers(0, K // 2, n_loops).astype(np.int32)
    i = np.concatenate([ci, li])
    j = np.concatenate([ci + 1, li + K // 2]).astype(np.int32)
    T = np.stack([np.linalg.inv(gt[a]) @ gt[b] for a, b in zip(i, j)]).astype(np.float32)
    w = np.concatenate([np.full(K - 1, 100.0), np.full(n_loops, 10.0)]).astype(np.float32)
    return gt, poses, dict(i=i, j=j, T_meas=T, weight=w, mask=np.ones(len(i), np.float32))


def single_pose_factors(K, gt, seed, P=40, L=30, Q=30):
    """Factors of every single-pose type on the ground truth
    (tests/test_graph.py's structured graph): planes z=0 (normal + offset
    and through three points), lines y=1, z=2 along x, point anchors."""
    rng = np.random.default_rng(seed)
    ones = np.ones
    pw = rng.uniform(-3, 6, (P, 3)).astype(np.float32)
    pw[:, 2] = 0.0
    ks = rng.integers(0, K, P).astype(np.int32)
    pb = _body(gt[ks], pw).astype(np.float32)
    lw = np.stack([rng.uniform(-3, 6, L), np.full(L, 1.0), np.full(L, 2.0)], -1).astype(np.float32)
    kl = rng.integers(0, K, L).astype(np.int32)
    qw = rng.uniform(-3, 6, (Q, 3)).astype(np.float32)
    kq = rng.integers(0, K, Q).astype(np.int32)
    tile = lambda v, n: np.tile(np.float32(v), (n, 1))   # noqa: E731
    return dict(
        planes=dict(k=ks, p_body=pb, normal=tile([0, 0, 1], P), offset=np.zeros(P, np.float32),
                    weight=rng.uniform(0.5, 2.0, P).astype(np.float32), mask=ones(P, np.float32)),
        planes3=dict(k=ks, p_body=pb, plane_j=tile([0, 0, 0], P), plane_l=tile([1, 0, 0], P),
                     plane_m=tile([0, 1, 0], P), weight=ones(P, np.float32),
                     mask=(rng.uniform(size=P) > 0.2).astype(np.float32)),
        lines=dict(k=kl, p_body=_body(gt[kl], lw).astype(np.float32), line_a=tile([0, 1, 2], L),
                   line_b=tile([1, 1, 2], L), weight=ones(L, np.float32), mask=ones(L, np.float32)),
        points=dict(k=kq, p_body=_body(gt[kq], qw).astype(np.float32), q_world=qw,
                    weight=ones(Q, np.float32), mask=ones(Q, np.float32)))


_JAX_TYPES = {"rel": jg.RelPoseFactors, "points": jg.PointFactors, "lines": jg.LineFactors,
              "planes": jg.PlaneFactors, "planes3": jg.Plane3Factors}


def both_graphs(poses, **factors):
    """The same numpy graph as a JAX PoseGraph and, carried across with
    `pose_graph_from_numpy`, as the port's (on the CPU)."""
    jgraph = jg.PoseGraph(poses=jnp.asarray(poses), **{
        name: _JAX_TYPES[name](**{f: jnp.asarray(v) for f, v in d.items()})
        for name, d in factors.items()})
    arrays = {"poses": np.asarray(jgraph.poses)}
    for name in factors:
        arrays[name] = {f: np.asarray(getattr(getattr(jgraph, name), f))
                        for f in POSE_GRAPH_FACTOR_FIELDS[name]}
    return jgraph, pose_graph_from_numpy(arrays, device=CPU)


def full_graph(K, seed, n_loops=2, drift=0.01):
    gt, poses, rel = loop_graph(K, 10.0, n_loops, drift, seed)
    return gt, both_graphs(poses, rel=rel, **single_pose_factors(K, gt, seed))


def test_graph_exports_the_jax_names():
    names = {n for n in dir(jg) if not n.startswith("_")
             and type(getattr(jg, n)).__name__ != "module"}       # submodules once imported
    assert len(names) == 21
    assert names <= set(dir(pg))


# ---- residuals, slerp, Jacobians --------------------------------------

def _factor_inputs(rng, n):
    T = _exp(rng.normal(0, [2, 2, 0.5, 0.3, 0.3, 1.0], (n, 6)))
    v = lambda: rng.normal(0, 5, (n, 3)).astype(np.float32)   # noqa: E731
    return T, dict(
        point_to_point=(v(), v()),
        point_to_line=(v(), v(), v()),
        point_to_plane=(v(), v(), v(), v()),
        point_to_plane_norm=(v(), (lambda n_: n_ / np.linalg.norm(n_, axis=-1, keepdims=True))(v()),
                             rng.normal(0, 3, n).astype(np.float32)))


RESIDUALS = ("point_to_point", "point_to_line", "point_to_plane", "point_to_plane_norm")


@pytest.mark.parametrize("name,interp", [(n, 1.0) for n in RESIDUALS + ("relative_pose",)]
                         + [("point_to_line", 0.3), ("point_to_plane", 0.3)])
def test_residuals_match_jax(name, interp):
    rng = np.random.default_rng(1)
    n = 64
    T, payloads = _factor_inputs(rng, n)
    if name == "relative_pose":
        args = (T, _exp(rng.normal(0, 1, (n, 6))), _exp(rng.normal(0, 1, (n, 6))))
    else:
        args = (T,) + payloads[name]
    kw = {"interp": interp} if name in ("point_to_line", "point_to_plane") else {}
    jf = getattr(jg, f"{name}_residual")
    want = np.asarray(jax.vmap(lambda *a: jf(*a, **kw))(*(jnp.asarray(a) for a in args)))
    got = getattr(pg, f"{name}_residual")(*(torch.from_numpy(a) for a in args), **kw).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("case", ["generic", "near", "flip", "identity"])
@pytest.mark.parametrize("s", [0.0, 0.25, 1.0])
def test_quat_slerp_matches_jax(case, s):
    rng = np.random.default_rng(2)
    a = rng.normal(size=(32, 4)).astype(np.float32)
    a /= np.linalg.norm(a, axis=-1, keepdims=True)
    b = {"generic": rng.normal(size=(32, 4)),
         "near": a + rng.normal(0, 1e-6, (32, 4)),
         "flip": -a + rng.normal(0, 1e-3, (32, 4)),
         "identity": a}[case].astype(np.float32)
    b /= np.linalg.norm(b, axis=-1, keepdims=True)
    want = np.asarray(jax_quat_slerp(jnp.asarray(a), jnp.asarray(b), s))
    got = quat_slerp(torch.from_numpy(a), torch.from_numpy(b), s).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def _jax_single_pose_jacobian(res_fn, T, payload):
    def f(xi, Tk, *pl):
        return res_fn(Tk @ jax_se3_exp(xi), *pl)

    zeros = jnp.zeros((T.shape[0], 6), jnp.float32)
    return np.asarray(jax.vmap(jax.jacfwd(f))(zeros, jnp.asarray(T),
                                              *(jnp.asarray(p) for p in payload)))


@pytest.mark.parametrize("name", RESIDUALS + ("relative_pose",))
@pytest.mark.parametrize("pose", ["generic", "identity", "rot1e-6"])
def test_jacobians_match_jax_jacfwd(name, pose):
    rng = np.random.default_rng(3)
    n = 48
    T, payloads = _factor_inputs(rng, n)
    if pose == "identity":
        T = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    elif pose == "rot1e-6":
        T = _exp(np.concatenate([rng.normal(0, 1, (n, 3)), rng.normal(0, 1e-6, (n, 3))], -1))
    poses = torch.from_numpy(T)
    k = torch.arange(n)
    if name == "relative_pose":
        Tj = T if pose == "identity" else _exp(rng.normal(0, 1, (n, 6)))
        Tm = np.linalg.inv(T) @ Tj @ _exp(rng.normal(0, 0.01, (n, 6)))
        Tm = Tm.astype(np.float32)

        def f(xi_i, xi_j, Ti, Tj_, Tm_):
            return jg.relative_pose_residual(Ti @ jax_se3_exp(xi_i), Tj_ @ jax_se3_exp(xi_j), Tm_)

        z = jnp.zeros((n, 6), jnp.float32)
        args = (z, z, jnp.asarray(T), jnp.asarray(Tj), jnp.asarray(Tm))
        want_i = np.asarray(jax.vmap(jax.jacfwd(f, argnums=0))(*args))
        want_j = np.asarray(jax.vmap(jax.jacfwd(f, argnums=1))(*args))
        all_poses = torch.from_numpy(np.concatenate([T, Tj]))
        rel = pg.RelPoseFactors.build(np.arange(n), np.arange(n, 2 * n), Tm, device=CPU)
        _, Ji, Jj, _, _ = pgn._rel_linearize(all_poses, rel, 1.0)
        for got, want in ((Ji, want_i), (Jj, want_j)):
            assert np.isfinite(got.numpy()).all()
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
        return
    payload = payloads[name]
    want = _jax_single_pose_jacobian(getattr(jg, f"{name}_residual"), T, payload)
    _, got = pgn._single_pose_linearize(poses, getattr(pg, f"{name}_residual"), k,
                                        tuple(torch.from_numpy(p) for p in payload))
    assert got.shape == want.shape and np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


# ---- assemblies ----------------------------------------------------------

def test_dense_normal_equations_match_jax():
    _, (jgraph, pgraph) = full_graph(8, seed=3)
    H, g, c = jax.jit(jg.pose_graph_normal_equations)(jgraph)
    Hp, gp, cp = pg.pose_graph_normal_equations(pgraph)
    scale = float(np.abs(np.asarray(H)).max())
    np.testing.assert_allclose(Hp.numpy(), np.asarray(H), atol=1e-5 * scale)
    np.testing.assert_allclose(gp.numpy(), np.asarray(g), atol=1e-5 * scale)
    np.testing.assert_allclose(float(cp), float(c), rtol=1e-5)


@pytest.fixture(scope="module")
def block_case():
    """A K = 16 graph of every factor type with 3 closures, and the JAX
    package's block normal equations of it."""
    _, (jgraph, pgraph) = full_graph(16, seed=6, n_loops=3, drift=0.02)
    jne = jax.jit(jg.block_normal_equations)(jgraph, *jg.split_chain_loops(jgraph.rel))
    return jgraph, pgraph, jne


def test_block_normal_equations_match_jax_and_reconstruct_dense_H(block_case):
    jgraph, pgraph, jne = block_case
    K = pgraph.poses.shape[0]
    chain, loops = pg.split_chain_loops(pgraph.rel)
    ne = pg.block_normal_equations(pgraph, chain, loops)
    H, g, cost = pg.pose_graph_normal_equations(pgraph)
    scale = float(H.abs().max())
    for f in ("diag", "off", "U", "g"):
        np.testing.assert_allclose(getattr(ne, f).numpy(), np.asarray(getattr(jne, f)),
                                   atol=1e-5 * scale, err_msg=f)
    Hb = np.zeros((K, 6, K, 6), np.float32)
    for k in range(K):
        Hb[k, :, k, :] += ne.diag[k].numpy()
    for k in range(K - 1):
        Hb[k + 1, :, k, :] += ne.off[k].numpy()
        Hb[k, :, k + 1, :] += ne.off[k].numpy().T
    U = ne.U.numpy().reshape(6 * K, -1)
    np.testing.assert_allclose(Hb.reshape(6 * K, 6 * K) + U @ U.T, H.numpy(), atol=1e-5 * scale)
    np.testing.assert_allclose(ne.g.numpy().reshape(-1), g.numpy(), atol=1e-5 * scale)
    np.testing.assert_allclose(float(ne.cost), float(cost), rtol=1e-5)
    np.testing.assert_allclose(float(ne.cost), float(jne.cost), rtol=1e-5)


def test_block_tridiag_cholesky_and_solve_match_jax():
    rng = np.random.default_rng(5)
    K = 40
    A = rng.normal(size=(K, 6, 6)).astype(np.float32)
    diag = (A @ A.transpose(0, 2, 1) + 8 * np.eye(6)).astype(np.float32)
    diag[0] += 1e6 * np.eye(6, dtype=np.float32)                   # a gauge block
    off = rng.normal(0, 1.0, (K - 1, 6, 6)).astype(np.float32)
    rhs = rng.normal(size=(K, 6, 5)).astype(np.float32)
    jLd, jLo = jg.block_tridiag_cholesky(jnp.asarray(diag), jnp.asarray(off))
    Ld, Lo = pg.block_tridiag_cholesky(torch.from_numpy(diag), torch.from_numpy(off))
    for got, want in ((Ld, jLd), (Lo, jLo)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * np.abs(want).max())
    want = np.asarray(jg.block_tridiag_solve(jLd, jLo, jnp.asarray(rhs)))
    got = pg.block_tridiag_solve(Ld, Lo, torch.from_numpy(rhs)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())
    # and it solves T x = rhs
    Tx = np.einsum("kij,kjm->kim", diag, got)
    Tx[1:] += np.einsum("kij,kjm->kim", off, got[:-1])
    Tx[:-1] += np.einsum("kji,kjm->kim", off, got[1:])
    np.testing.assert_allclose(Tx, rhs, atol=1e-3)


def test_solve_block_step_matches_jax(block_case):
    jgraph, pgraph, jne = block_case
    ne = pbs.BlockNormalEq(**{f: torch.from_numpy(np.asarray(getattr(jne, f)))
                              for f in ("diag", "off", "U", "g", "cost")})
    want, wd = jax.jit(jbs.solve_block_step)(jne, jgraph.poses)
    got, d = pbs.solve_block_step(ne, pgraph.poses)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(float(d), float(wd), rtol=1e-4)


@pytest.mark.parametrize("solver", ["dense", "block"])
def test_optimizers_match_jax(solver):
    """To convergence on a graph whose closures disagree with the chain by
    a few cm (a cost of order 1 at the optimum)."""
    K = 16
    gt, poses, rel = loop_graph(K, 10.0, 3, 0.01, seed=3)
    noise = np.random.default_rng(9).normal(0, [0.05, 0.05, 0.05, 0.01, 0.01, 0.01], (3, 6))
    rel["T_meas"][K - 1:] = rel["T_meas"][K - 1:] @ _exp(noise)
    singles = single_pose_factors(K, gt, seed=3)
    # the line factors (the slerp-interpolated path) beside the chain: every
    # factor type's linearisation is held in the assembly tests above, and
    # each type adds ~3 s of JAX compilation here
    jgraph, pgraph = both_graphs(poses, rel=rel, lines=singles["lines"])
    cfg = dict(max_iterations=8)
    if solver == "dense":
        jout, jc = jg.optimize_pose_graph(jgraph, JaxPoseGraphConfig(**cfg))
        out, c = pg.optimize_pose_graph(pgraph, PoseGraphConfig(**cfg))
    else:
        jout, jc = jg.optimize_pose_graph_block(jgraph, JaxPoseGraphConfig(**cfg))
        out, c = pg.optimize_pose_graph_block(pgraph, PoseGraphConfig(**cfg))
    np.testing.assert_allclose(out.poses.numpy(), np.asarray(jout.poses), atol=1e-4)
    np.testing.assert_allclose(float(c), float(jc), rtol=1e-4)


def test_dense_and_block_agree_with_huber_on_a_bad_closure():
    gt, poses, rel = loop_graph(12, 5.0, 1, 0.02, seed=0)
    rel["T_meas"][-1, 0, 3] += 5.0
    rel["weight"][-1] = 1.0
    _, pgraph = both_graphs(poses, rel=rel)
    cfg = PoseGraphConfig(max_iterations=20, huber_delta=0.3)
    dense, _ = pg.optimize_pose_graph(pgraph, cfg)
    block, _ = pg.optimize_pose_graph_block(pgraph, cfg)
    np.testing.assert_allclose(block.poses.numpy(), dense.poses.numpy(), atol=1e-3)


def test_split_chain_loops_exact():
    rng = np.random.default_rng(7)
    i = rng.integers(0, 30, 50).astype(np.int32)
    j = np.where(rng.uniform(size=50) < 0.6, i + 1, rng.integers(0, 30, 50)).astype(np.int32)
    rel = dict(i=i, j=j, T_meas=_exp(rng.normal(0, 1, (50, 6))),
               weight=rng.uniform(1, 9, 50).astype(np.float32),
               mask=(rng.uniform(size=50) > 0.1).astype(np.float32))
    jgraph, pgraph = both_graphs(np.tile(np.eye(4, dtype=np.float32), (31, 1, 1)), rel=rel)
    for got, want in zip(pg.split_chain_loops(pgraph.rel), jg.split_chain_loops(jgraph.rel)):
        for f in POSE_GRAPH_FACTOR_FIELDS["rel"]:
            np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
    assert pg.split_chain_loops(None) == (None, None)


def test_long_chain_block_solver_converges():
    """tests/test_graph.py's long-chain acceptance (a 100 m loop, 8
    closures, random-walk drift) at K = 256, the largest that keeps this
    file within its time budget on the CPU (K = 512 takes ~25 s here;
    chip_smoke.py runs it on the card and the CPU): the damped
    preconditioner + PCG on the exact H holds up in float32. Port only."""
    gt, poses, rel = loop_graph(256, 100.0, 8, 0.004, seed=5)
    _, pgraph = both_graphs(poses, rel=rel)
    err0 = np.linalg.norm(poses[:, :3, 3] - gt[:, :3, 3], axis=-1).max()
    out, cost = pg.optimize_pose_graph_block(pgraph, PoseGraphConfig(max_iterations=10))
    err = np.linalg.norm(out.poses.numpy()[:, :3, 3] - gt[:, :3, 3], axis=-1).max()
    assert np.isfinite(float(cost))
    assert err0 > 5.0, err0
    assert err < 0.05, err


def test_long_chain_pcg_stops_at_its_cap_in_both_packages():
    """Why float32 PCG runs of the long chain converge from some perturbed
    starts and not others (PERF.md section 7): on tests/test_graph.py's
    chain at K = 256 (seed 7), both packages' first block GN step runs the
    PCG to its 64-iteration cap and lands far from the exact GN step (the
    dense float64 solve of the same normal equations): JAX's float32 step
    and the port's (float64 matvec) alike, 20-80% of the exact step's
    length off it, within a factor 2 of each other. The step each GN
    iteration takes is decided by round-off inside a capped PCG, so which
    starts converge in 30 iterations is too; no one piece of the port
    (matvec, preconditioner substitutions, dots) differs from JAX's in a
    way that decides it (swapped one at a time on the K = 512 chain, seeds
    5-10: JAX 3 of 6, the port 2 of 6 in float32 and 1 of 6 with the
    float64 matvec)."""
    K = 256
    gt, poses, rel = loop_graph(K, 100.0, 8, 0.004, seed=7)
    jgraph, pgraph = both_graphs(poses, rel=rel)
    chain, loops = jbs.split_chain_loops(jgraph.rel)
    jcfg = JaxPoseGraphConfig()
    jne = jax.jit(lambda g, c, l: jbs.block_normal_equations(g, c, l, jcfg))(jgraph, chain, loops)
    arrays = {f: np.asarray(getattr(jne, f)) for f in ("diag", "off", "U", "g", "cost")}
    # the exact step: the dense float64 solve of the damped, gauge-pinned H
    d64 = {f: v.astype(np.float64) for f, v in arrays.items()}
    H = np.zeros((K, 6, K, 6))
    for k in range(K):
        H[k, :, k, :] = d64["diag"][k] + jcfg.damping * np.eye(6)
    for k in range(K - 1):
        H[k + 1, :, k, :] += d64["off"][k]
        H[k, :, k + 1, :] += d64["off"][k].T
    H = H.reshape(6 * K, 6 * K)
    H[:6, :6] += 1e6 * np.eye(6)
    U = d64["U"].reshape(6 * K, -1)
    x = np.linalg.solve(H + U @ U.T, -d64["g"].reshape(-1)).reshape(K, 6)
    exact = pgn._apply_twists(torch.from_numpy(poses.astype(np.float64)),
                              torch.from_numpy(x)).numpy()

    def off(new):
        step, want = new[:, :3, 3] - poses[:, :3, 3], exact[:, :3, 3] - poses[:, :3, 3]
        return np.linalg.norm(step - want) / np.linalg.norm(want)

    ne = pbs.BlockNormalEq(**{f: torch.from_numpy(v.copy()) for f, v in arrays.items()})
    before = pbs.PCG_ITERATIONS
    port, _ = pbs.solve_block_step(ne, pgraph.poses, PoseGraphConfig())
    assert pbs.PCG_ITERATIONS - before == 64                 # the cap binds
    jax_new, _ = jax.jit(lambda n, p: jbs.solve_block_step(n, p, jcfg))(jne, jgraph.poses)
    e_port, e_jax = off(port.numpy()), off(np.asarray(jax_new))
    assert 0.2 < e_port < 0.8 and 0.2 < e_jax < 0.8, (e_port, e_jax)
    assert 0.5 < e_port / e_jax < 2.0, (e_port, e_jax)
