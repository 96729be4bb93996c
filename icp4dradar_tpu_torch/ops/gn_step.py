"""The damped Gauss-Newton step of the VGICP loops, one launch for a batch
of frames (`registration/vgicp.py`): for each frame xi = -(H + lm I)^-1 g,
zeroed where it is not finite (no correspondences) or the frame is
inactive, then T <- exp(xi) T and dlt = sum |xi|.

- `gn_step` takes T (n,4,4), H (n,6,6), g (n,6) of one floating dtype on
  one device and `active` (n,) bool or None, and checks them before any
  launch. CUDA tensors (float32) launch `gn_step_launch` of
  `csrc/gn_step.cu`: one launch, one thread a frame, no host sync and
  nothing copied from the host. CPU tensors run `gn_step_plain`.
- `gn_step_plain` is the step in plain PyTorch (the closed-form 6x6 solve
  of `geom/linalg.py`, `se3_exp`, a small product): the CPU path and the
  kernel's reference. The kernel runs its operations in its order.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from icp4dradar_tpu_torch.geom.linalg import small_matmul, solve_spd6
from icp4dradar_tpu_torch.geom.se3 import se3_exp
from icp4dradar_tpu_torch.ops import _build

# Kernel launches of `gn_step` in this process; the CUDA path adds one per
# launch and nowhere else.
GN_STEP_LAUNCHES = 0


def gn_step_plain(T, H, g, lm_lambda: float, active=None):
    """One damped GN step T <- exp(xi) T with xi = -(H + lm_lambda I)^-1 g;
    non-finite steps (no correspondences) and inactive frames hold. Returns
    (T, sum |xi|)."""
    eye = torch.eye(6, dtype=T.dtype, device=T.device)
    xi = solve_spd6(H + lm_lambda * eye, -g)
    xi = torch.where(torch.isfinite(xi), xi, 0.0)
    if active is not None:
        xi = torch.where(active[..., None], xi, 0.0)   # converged frames hold
    return small_matmul(se3_exp(xi), T), torch.sum(torch.abs(xi), dim=-1)


def _check(T, H, g, active) -> bool:
    """Shapes, dtypes and devices of a step; True for CUDA tensors."""
    if T.dim() != 3 or tuple(T.shape[1:]) != (4, 4):
        raise ValueError(f"gn_step: T must be (n, 4, 4), got {tuple(T.shape)}")
    n = T.shape[0]
    if tuple(H.shape) != (n, 6, 6) or tuple(g.shape) != (n, 6):
        raise ValueError(f"gn_step: H {tuple(H.shape)} and g {tuple(g.shape)} must be "
                         f"({n}, 6, 6) and ({n}, 6) for T {tuple(T.shape)}")
    if active is not None and (tuple(active.shape) != (n,) or active.dtype != torch.bool):
        raise ValueError(f"gn_step: active must be ({n},) bool, got {tuple(active.shape)} "
                         f"{active.dtype}")
    if not T.is_floating_point() or H.dtype != T.dtype or g.dtype != T.dtype:
        raise ValueError(f"gn_step: T, H and g must share one floating dtype, got "
                         f"{T.dtype}, {H.dtype}, {g.dtype}")
    tensors = (T, H, g) + (() if active is None else (active,))
    if any(x.device != T.device for x in tensors):
        raise ValueError(f"gn_step: inputs on {[str(x.device) for x in tensors]}; they must "
                         f"share one device")
    if T.device.type == "cpu":
        return False
    if not T.is_cuda or T.dtype != torch.float32:
        raise ValueError(f"gn_step: the kernel takes float32 CUDA tensors, got {T.dtype} on "
                         f"{T.device}")
    return True


def gn_step(T, H, g, lm_lambda: float, active: Optional[torch.Tensor] = None):
    """One damped GN step for each of n frames -> (T (n,4,4), dlt (n,)), as
    `gn_step_plain`. CUDA tensors launch the kernel (one launch, no host
    sync); CPU tensors run the plain version; anything else raises."""
    if not _check(T, H, g, active):
        return gn_step_plain(T, H, g, lm_lambda, active)
    return _gn_step_cuda(T, H, g, lm_lambda, active)


def _lib() -> ctypes.CDLL:
    lib = _build.load_library()
    if lib.gn_step_launch.argtypes is None:
        p, q, i, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
        lib.gn_step_launch.argtypes = [p, q, p, q, p, q, p, f, i, p, p, p]
        lib.gn_step_launch.restype = i
    return lib


def _frames(x, inner):
    """x with each frame's entries row-major (`inner`: the strides within a
    frame; a sweep's H and g are views into wider rows, taken as they are),
    copied only where they are not -> (x, floats from one frame to the
    next)."""
    if x.stride()[1:] != inner:
        x = x.contiguous()
    return x, x.stride(0)


def _gn_step_cuda(T, H, g, lm_lambda, active):
    global GN_STEP_LAUNCHES
    n, dev = T.shape[0], T.device
    T_new = torch.empty((n, 4, 4), dtype=torch.float32, device=dev)
    dlt = torch.empty((n,), dtype=torch.float32, device=dev)
    (T, t_row), (H, h_row), (g, g_row) = _frames(T, (4, 1)), _frames(H, (6, 1)), _frames(g, (1,))
    if active is not None:
        active = active.contiguous()
    rc = _build.launch(dev, _lib().gn_step_launch, T.data_ptr(), t_row, H.data_ptr(), h_row,
                       g.data_ptr(), g_row, None if active is None else active.data_ptr(),
                       lm_lambda, n, T_new.data_ptr(), dlt.data_ptr())
    if rc != 0:
        raise RuntimeError(f"gn_step kernel launch failed: CUDA error {rc} (n={n})")
    GN_STEP_LAUNCHES += 1
    return T_new, dlt
