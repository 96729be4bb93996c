"""The float32 block PCG on tests/test_graph.py's long chain, in both packages
on the CPU: which perturbed starts converge, and how far each variant's
first GN step lands from the exact GN step.

    JAX_PLATFORMS=cpu python scripts/port_pcg_probe.py [--k 512] [--seeds 5,6,7,8,9,10]

Part 1 runs 30 block GN iterations from the chain of each seed (error below
0.05 m counts as converged) with JAX's solver and with the port's PCG step
under three matvecs: the port's float32 `block_matvec`, its float64 one
(what `solve_block_step` ships) and JAX's, jitted. Part 2 takes JAX's
normal equations at the first seed's start and prints each variant's first
step against the dense float64 solve: the relative distance to the exact
step and the relative residual. Variants swap one piece of the port's step
at a time: the matvec (float32, float64, JAX's), the preconditioner's
substitutions (inverted diagonal factors, JAX's, triangular solves) and
the dots (float32, float64)."""

import argparse
import functools
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from icp4dradar_tpu import graph as jg  # noqa: E402
from icp4dradar_tpu.config import PoseGraphConfig as JaxPoseGraphConfig  # noqa: E402
from icp4dradar_tpu.graph import block_solver as jbs  # noqa: E402
from icp4dradar_tpu_torch.config import PoseGraphConfig  # noqa: E402
from icp4dradar_tpu_torch.graph import block_solver as pbs  # noqa: E402
from icp4dradar_tpu_torch.graph.gauss_newton import _apply_twists  # noqa: E402
from tests.test_torch_graph import both_graphs, loop_graph  # noqa: E402

GAUGE = 1e6


@functools.lru_cache(maxsize=None)
def _jax_matvec(damping):
    """JAX's `block_matvec`, jitted once."""
    return jax.jit(lambda d, o, U, x: jbs.block_matvec(
        jbs.BlockNormalEq(diag=d, off=o, U=U, g=x, cost=x[0, 0]), x, damping, GAUGE))


def pcg_step(ne, cfg, matvec="f32", pre="port", dots="f32", cg_iters=64, cg_tol=1e-6):
    """The port's `solve_block_step` PCG with one piece swapped -> (x, iterations)."""
    dt = torch.float32
    eye6 = torch.eye(6, dtype=dt)
    scale = torch.mean(torch.diagonal(ne.diag, dim1=-2, dim2=-1).sum(-1)) / 6.0
    lam = 1e-4 * scale + 1e-3 + cfg.damping
    diag_pre = ne.diag + lam * eye6
    diag_pre[0] += GAUGE * eye6
    Ld, Lo = pbs.block_tridiag_cholesky(diag_pre, ne.off)
    if pre == "port":
        sub = pbs._substitution(Ld, Lo)

        def solve(rhs):
            return pbs._substitute(sub, rhs)
    elif pre == "jax":
        jLd, jLo = jnp.asarray(Ld.numpy()), jnp.asarray(Lo.numpy())
        jsolve = jax.jit(lambda r: jbs.block_tridiag_solve(jLd, jLo, r))

        def solve(rhs):
            return torch.from_numpy(np.asarray(jsolve(jnp.asarray(rhs.numpy()))).copy())
    else:                                                  # triangular solves, in torch
        def solve(rhs):
            y = [torch.linalg.solve_triangular(Ld[0], rhs[0], upper=False)]
            for k in range(1, rhs.shape[0]):
                y.append(torch.linalg.solve_triangular(Ld[k], rhs[k] - Lo[k - 1] @ y[-1],
                                                       upper=False))
            x = [torch.linalg.solve_triangular(Ld[-1].T, y[-1], upper=True)]
            for k in range(rhs.shape[0] - 2, -1, -1):
                x.append(torch.linalg.solve_triangular(Ld[k].T, y[k] - Lo[k].T @ x[-1],
                                                       upper=True))
            return torch.stack(x[::-1])
    TinvU = solve(ne.U)
    S = torch.eye(ne.U.shape[-1], dtype=dt) + torch.einsum("kir,kis->rs", ne.U, TinvU)

    def apply_pre(r):
        z = solve(r[..., None])[..., 0]
        corr = torch.linalg.solve(S, torch.einsum("kir,ki->r", ne.U, z))
        return z - torch.einsum("kir,r->ki", TinvU, corr)

    ne64 = pbs.BlockNormalEq(**{f: getattr(ne, f).double() for f in ("diag", "off", "U", "g",
                                                                     "cost")})
    jmv = _jax_matvec(cfg.damping)

    def mv(p):
        if matvec == "f32":
            return pbs.block_matvec(ne, p, cfg.damping, GAUGE)
        if matvec == "f64":
            return pbs.block_matvec(ne64, p.double(), cfg.damping, GAUGE).float()
        return torch.from_numpy(np.asarray(jmv(ne.diag.numpy(), ne.off.numpy(), ne.U.numpy(),
                                               p.numpy())).copy())

    def dot(a, b):
        return torch.sum(a * b) if dots == "f32" else torch.sum(a.double() * b.double()).float()

    b = -ne.g
    tol2 = cg_tol * cg_tol * dot(b, b)
    x, r = torch.zeros_like(b), b
    z = apply_pre(r)
    p, rz, it = z, dot(r, z), 0
    while it < cg_iters and bool(dot(r, r) > tol2):
        Hp = mv(p)
        alpha = rz / torch.clamp(dot(p, Hp), min=1e-30)
        x, r = x + alpha * p, r - alpha * Hp
        z = apply_pre(r)
        rz_new = dot(r, z)
        p = z + rz_new / torch.clamp(rz, min=1e-30) * p
        rz, it = rz_new, it + 1
    return x, it


def port_solve(pgraph, cfg, matvec):
    chain, loops = pbs.split_chain_loops(pgraph.rel)
    poses, its = pgraph.poses, []
    for _ in range(cfg.max_iterations):
        ne = pbs.block_normal_equations(pgraph.replace(poses=poses), chain, loops, cfg)
        x, it = pcg_step(ne, cfg, matvec=matvec)
        poses = _apply_twists(poses, x)
        its.append(it)
        if not bool(torch.sum(torch.abs(x)) > cfg.convergence_eps):
            break
    return poses.numpy(), its


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--k", type=int, default=512)
    ap.add_argument("--seeds", default="5,6,7,8,9,10")
    args = ap.parse_args()
    seeds = [int(s) for s in args.seeds.split(",")]
    torch.set_num_threads(4)
    K = args.k
    print(f"part 1: {K}-keyframe chains, 30 block GN iterations, converged = error < 0.05 m")
    for seed in seeds:
        gt, poses, rel = loop_graph(K, 100.0, 8, 0.004, seed=seed)
        jgraph, pgraph = both_graphs(poses, rel=rel)
        row = []
        for name in ("jax", "f32", "f64", "jaxmv"):
            t0 = time.time()
            if name == "jax":
                out, _ = jg.optimize_pose_graph_block(jgraph, JaxPoseGraphConfig(max_iterations=30))
                P = np.asarray(out.poses)
            else:
                P, _ = port_solve(pgraph, PoseGraphConfig(max_iterations=30), name)
            err = np.linalg.norm(P[:, :3, 3] - gt[:, :3, 3], axis=-1).max()
            row.append(f"{name} {err:.4g} m {'converged' if err < 0.05 else 'not'} "
                       f"({time.time() - t0:.1f} s)")
        print(f"seed {seed}: " + "; ".join(row), flush=True)

    seed = seeds[0]
    print(f"part 2: the first GN step at seed {seed}, from JAX's normal equations")
    gt, poses, rel = loop_graph(K, 100.0, 8, 0.004, seed=seed)
    jgraph, pgraph = both_graphs(poses, rel=rel)
    chain, loops = jbs.split_chain_loops(jgraph.rel)
    jcfg = JaxPoseGraphConfig()
    jne = jax.jit(lambda g, c, l: jbs.block_normal_equations(g, c, l, jcfg))(jgraph, chain, loops)
    arrays = {f: np.asarray(getattr(jne, f)) for f in ("diag", "off", "U", "g", "cost")}
    d64 = {f: v.astype(np.float64) for f, v in arrays.items()}
    H = np.zeros((K, 6, K, 6))
    for k in range(K):
        H[k, :, k, :] = d64["diag"][k] + jcfg.damping * np.eye(6)
    for k in range(K - 1):
        H[k + 1, :, k, :] += d64["off"][k]
        H[k, :, k + 1, :] += d64["off"][k].T
    H = H.reshape(6 * K, 6 * K)
    H[:6, :6] += GAUGE * np.eye(6)
    U = d64["U"].reshape(6 * K, -1)
    H += U @ U.T
    b = -d64["g"].reshape(-1)
    x_ex = np.linalg.solve(H, b)

    p64 = torch.from_numpy(poses.astype(np.float64))
    want = _apply_twists(p64, torch.from_numpy(x_ex.reshape(K, 6))).numpy()[:, :3, 3] - \
        poses[:, :3, 3]

    def step_off(new):
        """The translation step's distance to the exact step's, relative."""
        return np.linalg.norm(new[:, :3, 3] - poses[:, :3, 3] - want) / np.linalg.norm(want)

    def report(name, x, it):
        new = _apply_twists(p64, torch.from_numpy(np.asarray(x, np.float64))).numpy()
        x = np.asarray(x, np.float64).reshape(-1)
        print(f"  {name:44s} PCG iterations {it}, |x - x*| / |x*| "
              f"{np.linalg.norm(x - x_ex) / np.linalg.norm(x_ex):.3e}, |b - H x| / |b| "
              f"{np.linalg.norm(b - H @ x) / np.linalg.norm(b):.3e}, translation step "
              f"{step_off(new):.3e} off")

    new = jax.jit(lambda n, q: jbs.solve_block_step(n, q, jcfg))(jne, jgraph.poses)
    print(f"  {'JAX solve_block_step (float32)':44s} translation step "
          f"{step_off(np.asarray(new[0])):.3e} off")
    ne = pbs.BlockNormalEq(**{f: torch.from_numpy(v.copy()) for f, v in arrays.items()})
    cfg = PoseGraphConfig()
    for matvec, pre, dots in (("f32", "port", "f32"), ("f64", "port", "f32"),
                              ("jax", "port", "f32"), ("f32", "jax", "f32"),
                              ("f64", "jax", "f32"), ("f32", "tri", "f32"),
                              ("f64", "tri", "f32"), ("f32", "port", "f64")):
        x, it = pcg_step(ne, cfg, matvec=matvec, pre=pre, dots=dots)
        report(f"port: matvec {matvec}, substitutions {pre}, dots {dots}", x.numpy(), it)


if __name__ == "__main__":
    main()
