"""The damped GN step of the VGICP loops (`ops/gn_step.py`) on the CPU:
`gn_step` against the JAX package's step on the same inputs (an active
frame, an inactive one, non-finite H, rotations inside and outside the
Taylor window, no mask); it refuses what the kernel does not take before
any launch; and every GN loop of `registration/vgicp.py` steps through it,
once a sweep. The kernel itself is held to `gn_step_plain` on the card
(tests/test_torch_gpu.py).

Tolerance against JAX: float32 round-off. Both run the same closed-form
solve and exponential; the small products (`@` here, XLA's dot there) may
sum in another order, which moves T and dlt by an ulp or a few (1.2e-7 and
1.1e-7 of dlt on this suite's cases on one host; translations reach ~5 m,
where an ulp is 4.8e-7, so 4e-6 allows 8). Held frames are exact."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icp4dradar_tpu.geom import se3_exp as j_se3_exp
from icp4dradar_tpu.geom.linalg import solve_spd6 as j_solve_spd6
from icp4dradar_tpu_torch.config import GicpConfig
from icp4dradar_tpu_torch.geom.linalg import solve_spd6
from icp4dradar_tpu_torch.geom.se3 import se3_exp
from icp4dradar_tpu_torch.ops.gn_step import gn_step
from icp4dradar_tpu_torch.ops.vgicp_fused import radar_point_covariances_packed
from icp4dradar_tpu_torch.registration import vgicp as reg
from tests._torch_threads import one_torch_thread  # noqa: F401

# the module (the package's `gn_step` is the function)
gs = importlib.import_module("icp4dradar_tpu_torch.ops.gn_step")
LM = GicpConfig().lm_lambda


def _jax_step(T, H, g, lm, active=None):
    """The JAX package's GN step on the same inputs: the `gn_update`
    closures of `icp4dradar_tpu/registration/vgicp.py` (lines 98-102, one
    frame and no mask, vmapped here over the frames; lines 201-205, a
    batch with its mask)."""
    T, H, g = (jnp.asarray(x.numpy()) for x in (T, H, g))
    H = H + lm * jnp.eye(6, dtype=T.dtype)[None]
    xi = jax.vmap(j_solve_spd6)(H, -g)
    xi = jnp.where(jnp.isfinite(xi), xi, 0.0)
    if active is not None:
        xi = jnp.where(jnp.asarray(active.numpy())[:, None], xi, 0.0)
    T = jax.vmap(lambda x, t: j_se3_exp(x) @ t)(xi, T)
    return (torch.from_numpy(np.array(T)),
            torch.from_numpy(np.array(jnp.sum(jnp.abs(xi), axis=-1))))


def gn_case(kind, n=4, seed=0):
    """n frames whose frame 0 is of `kind`, the others ordinary active
    steps: T (n,4,4), H (n,6,6) SPD at the scale of a sweep's sums, g
    = -(H + lm I) xi for a chosen step xi, active (n,) or None."""
    rng = np.random.default_rng(seed)
    T = se3_exp(torch.from_numpy(rng.normal(0, [2.0, 2.0, 0.2, 0.1, 0.1, 1.0], (n, 6))
                                 .astype(np.float32)))
    J = rng.normal(0, 1, (n, 64, 6)) * [1, 1, 1, 8, 8, 8]
    H = np.einsum("nki,nkj->nij", J, J) * 20.0
    xi = rng.normal(0, [0.05, 0.05, 0.02, 0.01, 0.01, 0.02], (n, 6))
    if kind == "taylor":
        xi[0, 3:] = [3e-5, -2e-5, 4e-5]                 # theta^2 = 2.9e-9 < 1e-8
    elif kind == "one_rad":
        xi[0, 3:] = np.array([1.0, -2.0, 2.0]) / 3.0    # theta = 1 rad
    g = -np.einsum("nij,nj->ni", H + LM * np.eye(6), xi)
    H = torch.from_numpy(H.astype(np.float32))
    if kind == "nonfinite":
        H[0] = float("nan")                             # no correspondences
    active = None if kind == "no_mask" else torch.ones(n, dtype=torch.bool)
    if kind == "inactive":
        active[0] = False
    return T, H, torch.from_numpy(g.astype(np.float32)), active


@pytest.mark.parametrize("kind", ["active", "inactive", "nonfinite", "taylor", "one_rad",
                                  "no_mask"])
def test_gn_step_matches_the_jax_step(kind):
    T, H, g, active = gn_case(kind)
    T_new, dlt = gn_step(T, H, g, LM, active)
    want_T, want_dlt = _jax_step(T, H, g, LM, active)
    assert T_new.dtype == torch.float32 and T_new.shape == T.shape and dlt.shape == (4,)
    torch.testing.assert_close(T_new, want_T, rtol=0, atol=4e-6)
    torch.testing.assert_close(dlt, want_dlt, rtol=4e-6, atol=0)
    if kind in ("inactive", "nonfinite"):               # the frame holds, in both
        assert torch.equal(T_new[0], T[0]) and float(dlt[0]) == 0.0
        assert torch.equal(want_T[0], T[0]) and float(want_dlt[0]) == 0.0
    else:                                               # the step is the chosen xi
        xi = solve_spd6(H[:1] + LM * torch.eye(6), -g[:1])
        torch.testing.assert_close(T_new[:1], se3_exp(xi) @ T[:1], rtol=0, atol=1e-5)
        torch.testing.assert_close(dlt[:1], xi.abs().sum(-1), rtol=1e-6, atol=0)
    theta2 = float((solve_spd6(H[:1] + LM * torch.eye(6), -g[:1])[0, 3:] ** 2).sum())
    if kind == "taylor":
        assert theta2 < 1e-8
    elif kind == "one_rad":
        assert abs(theta2 - 1.0) < 1e-3


def test_gn_step_refuses_what_the_kernel_does_not_take(monkeypatch):
    """Wrong shapes, leading counts, dtypes and devices raise ValueError
    before anything launches."""
    launched = []
    monkeypatch.setattr(gs, "_gn_step_cuda", lambda *a: launched.append(a))
    T, H, g, active = gn_case("active")
    bad = [
        (T[0], H, g, active),                           # no leading axis
        (T, H[:, :, :5], g, active),                    # H not 6x6
        (T, H[:3], g[:3], active),                      # leading counts differ
        (T, H, g[:3], active),
        (T, H, g, active[:3]),
        (T, H, g, active.float()),                      # a float mask
        (T, H.double(), g, active),                     # mixed dtypes
        (T.int(), H.int(), g.int(), active),            # not floating
        (T.to("meta"), H, g, active),                   # mixed devices
        (T.to("meta"), H.to("meta"), g.to("meta"), None),   # no kernel there
    ]
    for T_, H_, g_, active_ in bad:
        with pytest.raises(ValueError):
            gn_step(T_, H_, g_, LM, active_)
    assert launched == []
    gn_step(T.double(), H.double(), g.double(), LM, active)   # the plain path takes float64


def _scene(seed, frames, N=256, P=400):
    rng = np.random.default_rng(seed)
    world = rng.uniform(-20, 20, (P, 3)).astype(np.float32)
    world[:, 2] *= 0.1
    tcov = np.zeros((P, 6), np.float32)
    tcov[:, :3] = np.abs(rng.normal(0.02, 0.005, (P, 3)))
    src = np.stack([world[rng.choice(P, N, replace=False)] + rng.normal(0, 0.02, (N, 3))
                    for _ in range(frames)]).astype(np.float32)
    init = se3_exp(torch.tensor([[0.2, -0.1, 0.0, 0.0, 0.0, 0.01]] * frames))
    return torch.from_numpy(src), torch.from_numpy(world), torch.from_numpy(tcov), init


def test_every_gn_loop_steps_through_gn_step(monkeypatch):
    """`vgicp_align`, `vgicp_align_streams` with and without inner steps and
    `vgicp_align_block` (with a stream axis) take one `gn_step` a sweep
    and a frozen step, for all their frames at once."""
    calls = {"step": [], "sweep": 0}
    real_step, real_sweep, real_frozen = reg.gn_step, reg.vgicp_sweep, reg.vgicp_frozen

    def step(T, *a):
        calls["step"].append(T.shape[0])
        return real_step(T, *a)

    def counted(fn):
        def run(*a, **k):
            calls["sweep"] += 1
            return fn(*a, **k)
        return run

    monkeypatch.setattr(reg, "gn_step", step)
    monkeypatch.setattr(reg, "vgicp_sweep", counted(real_sweep))
    monkeypatch.setattr(reg, "vgicp_frozen", counted(real_frozen))
    src, world, tcov, init = _scene(0, 4)
    ones = torch.ones(src.shape[:2])
    scov = radar_point_covariances_packed(src)
    tm = torch.ones(world.shape[0])
    cfg = GicpConfig(max_iterations=6)

    def check(frames, run):
        calls["step"].clear()
        calls["sweep"] = 0
        run()
        assert calls["step"] and set(calls["step"]) == {frames}
        assert len(calls["step"]) == calls["sweep"]

    check(1, lambda: reg.vgicp_align(src[0], world, tcov, init_transform=init[0], cfg=cfg))
    S = 2
    streams = (src[:S], world.expand(S, -1, -1), tcov.expand(S, -1, -1), ones[:S],
               tm.expand(S, -1), scov[:S], init[:S])
    for inner in (0, 1):
        check(S, lambda: reg.vgicp_align_streams(
            *streams, GicpConfig(max_iterations=6, inner_gn_steps=inner)))
    check(4, lambda: reg.vgicp_align_block(
        src.reshape(S, 2, -1, 3), world.expand(S, -1, -1), tcov.expand(S, -1, -1),
        ones.reshape(S, 2, -1), tm.expand(S, -1), scov.reshape(S, 2, -1, 6),
        init.reshape(S, 2, 4, 4), cfg))
