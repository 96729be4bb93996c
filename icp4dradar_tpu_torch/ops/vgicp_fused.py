"""Fused VGICP Gauss-Newton sweep: scan-to-map distribution registration in
one pass per iteration (PyTorch port of `icp4dradar_tpu/ops/vgicp_fused.py`).

Per source point s (sensor frame, measurement-model covariance Ca) and
transform T = (R, t) of its frame, one sweep computes

    p = R s + t
    d2 to every live voxel mean of the submap (masked rows: +1e30)
    the matched payload [mean3, cov6]: the mean of every row of a target
    tile at exactly the tile's minimum d2; a later tile replaces the
    running best only when its minimum is STRICTLY smaller
    r = q - p,  M = (R Ca R^T + Cb + eps I)^-1 (closed-form, `_sym_inv3`)
    w = mask * (d2 < gate)
    H += w J^T M J,  g += w J^T M r,  J = [-I | hat(p)]

and leaves only 30 sums per frame: packed H (21), g (6), cost, sum w,
sum w d2. The tiles are the Pallas kernel's: `tm = min(1024, round_up(P,
8))` rows, so ties average inside a tile only (`vgicp_fused.py:166-179`).
Tiles past the live count `tgt_count` are skipped (valid rows front-packed
by the sector query's compaction); tile 0 is always swept.

- `vgicp_iteration` / `vgicp_iteration_batch` dispatch on the device of
  their inputs: CPU tensors go to the plain version; CUDA tensors launch
  the hand-written kernel `csrc/vgicp_sweep.cu` or raise.
- `vgicp_iteration_plain` is plain torch with the kernel's semantics,
  chunked over frames so that the (frames, N, tm) distance tile stays
  bounded.
- `vgicp_iteration_frozen` (the inner GN steps, `gicp.inner_gn_steps >
  0`) re-linearises the same 30 sums at a new T on the payload a sweep
  returned under `return_best`, with no search: the kernel
  `vgicp_frozen_launch` of the same source on CUDA tensors, or
  `vgicp_iteration_frozen_plain` on CPU tensors.

The band-gate tile skip of the Pallas kernel (`:137-144`) is not ported: a
tile it skips holds no voxel within the correspondence gate, so it changes
no accumulator; `gate_axis` is accepted and only checked for shape.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

_BIG = 1e30
NUM_ACC = 30
MAX_TILE = 1024

# Kernel launches of `vgicp_iteration` / `vgicp_iteration_batch` in this
# process; the CUDA path adds one per kernel launch and nowhere else.
VGICP_SWEEP_LAUNCHES = 0
# Kernel launches of `vgicp_iteration_frozen`, counted the same way.
VGICP_FROZEN_LAUNCHES = 0

_GRID_Y_MAX = 65535  # CUDA grid.y limit: frames per launch


def radar_point_covariances_packed(
    xyz: torch.Tensor,
    sigma_r: float = 0.1,
    sigma_az: float = 0.01,
    sigma_el: float = 0.02,
) -> torch.Tensor:
    """(..., N, 6) packed sensor-frame covariance [xx,yy,zz,xy,xz,yz] per
    point from the radar measurement model: C = B diag(sr^2, (r saz)^2,
    (r sel)^2) B^T with B = [d, t_az, t_el] the spherical frame at the
    point."""
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    r = torch.clamp(torch.sqrt(x * x + y * y + z * z), min=1e-6)
    d = xyz / r[..., None]
    rho = torch.clamp(torch.sqrt(x * x + y * y), min=1e-6)
    t_az = torch.stack([-y / rho, x / rho, torch.zeros_like(rho)], dim=-1)
    t_el = torch.stack([
        d[..., 1] * t_az[..., 2] - d[..., 2] * t_az[..., 1],
        d[..., 2] * t_az[..., 0] - d[..., 0] * t_az[..., 2],
        d[..., 0] * t_az[..., 1] - d[..., 1] * t_az[..., 0],
    ], dim=-1)
    s1 = sigma_r ** 2
    ra, re = r * sigma_az, r * sigma_el
    s2, s3 = ra * ra, re * re

    def outer6(v, s):
        v0, v1, v2 = v[..., 0], v[..., 1], v[..., 2]
        return torch.stack([s * v0 * v0, s * v1 * v1, s * v2 * v2,
                            s * v0 * v1, s * v0 * v2, s * v1 * v2], dim=-1)

    return outer6(d, s1) + outer6(t_az, s2) + outer6(t_el, s3)


def _sym_inv3(c6, eps: float):
    """Closed-form inverse of packed symmetric 3x3 (+eps on the diagonal),
    rows xx,yy,zz,xy,xz,yz -> packed inverse (list of 6), with the
    sign/max(|det|, 1e-20) guard of the TPU kernel."""
    a, b, c = c6[0] + eps, c6[1] + eps, c6[2] + eps
    d_, e_, f_ = c6[3], c6[4], c6[5]
    A = b * c - f_ * f_
    B = a * c - e_ * e_
    C = a * b - d_ * d_
    D = -(d_ * c - f_ * e_)
    E = d_ * f_ - b * e_
    F = -(a * f_ - d_ * e_)
    det = a * A + d_ * D + e_ * E
    inv_det = 1.0 / torch.clamp(torch.abs(det), min=1e-20) * torch.sign(det)
    return [A * inv_det, B * inv_det, C * inv_det,
            D * inv_det, E * inv_det, F * inv_det]


def _sum3(terms):
    return terms[0] + terms[1] + terms[2]


def _gn_accumulators(R, p, w_src, ca, best_pay, gate_d2, gate: float,
                     cov_eps: float) -> torch.Tensor:
    """Per-point Mahalanobis GN terms, (..., 30) float32: packed upper H
    (21), g (6), cost, w, w d2. R: 3x3 nested lists and p, ca, best_pay
    lists of tensors broadcasting to the point shape; best_pay = [q0..q2,
    cb0..cb5]. Each product and sum is a separately rounded f32 op in the
    TPU kernel's order (`vgicp_fused.py:194-261`); the CUDA kernel repeats
    it with -fmad=false."""
    q, cb = best_pay[:3], best_pay[3:]
    Cf = [[ca[0], ca[3], ca[4]], [ca[3], ca[1], ca[5]], [ca[4], ca[5], ca[2]]]
    D = [[_sum3([R[r][k] * Cf[k][c] for k in range(3)]) for c in range(3)]
         for r in range(3)]
    cp = [_sum3([D[a][k] * R[c][k] for k in range(3)])
          for a, c in ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2))]
    w = w_src * (gate_d2 < gate).to(w_src.dtype)
    m00, m11, m22, m01, m02, m12 = _sym_inv3([cp[k] + cb[k] for k in range(6)],
                                             cov_eps)
    Mf = [[m00, m01, m02], [m01, m11, m12], [m02, m12, m22]]
    r_ = [q[k] - p[k] for k in range(3)]
    Mr = [_sum3([Mf[a][k] * r_[k] for k in range(3)]) for a in range(3)]
    pxMr = [p[1] * Mr[2] - p[2] * Mr[1], p[2] * Mr[0] - p[0] * Mr[2],
            p[0] * Mr[1] - p[1] * Mr[0]]
    g = [-Mr[0], -Mr[1], -Mr[2], -pxMr[0], -pxMr[1], -pxMr[2]]
    zero = torch.zeros_like(p[0])
    hp = [[zero, -p[2], p[1]], [p[2], zero, -p[0]], [-p[1], p[0], zero]]
    Mhp = [[_sum3([Mf[a][k] * hp[k][c] for k in range(3)]) for c in range(3)]
           for a in range(3)]
    Hww = [[_sum3([hp[k][a] * Mhp[k][c] for k in range(3)]) for c in range(3)]
           for a in range(3)]
    H = [[None] * 6 for _ in range(6)]
    for a in range(3):
        for c in range(3):
            H[a][c] = Mf[a][c]
            H[a][3 + c] = -Mhp[a][c]
            H[3 + a][3 + c] = Hww[a][c]
    cost = _sum3([r_[k] * Mr[k] for k in range(3)])
    vals = [H[a][c] for a in range(6) for c in range(a, 6)] + g + [cost]
    terms = [w * v for v in vals] + [w, w * gate_d2]
    shape = torch.broadcast_shapes(*(t.shape for t in terms))
    return torch.stack([t.expand(shape) for t in terms], dim=-1)


def _unpack_accumulators(acc: torch.Tensor, dtype=torch.float32):
    """(..., 30) -> (H (..., 6, 6), g (..., 6), cost, wsum, d2sum)."""
    iu = torch.triu_indices(6, 6)
    H = torch.zeros(acc.shape[:-1] + (6, 6), dtype=dtype, device=acc.device)
    H[..., iu[0], iu[1]] = acc[..., :21].to(dtype)
    H[..., iu[1], iu[0]] = acc[..., :21].to(dtype)
    return (H, acc[..., 21:27].to(dtype), acc[..., 27], acc[..., 28],
            acc[..., 29])


def sweep_gate(max_correspondence_dist: float) -> float:
    """The squared-distance gate of the TPU kernel, min(d^2, 5e29), rounded
    to f32 as the kernel compares it."""
    return float(np.float32(min(float(max_correspondence_dist) ** 2, _BIG * 0.5)))


def target_tile_rows(P: int) -> int:
    """Rows per target tile, as the Pallas kernel chooses them
    (`vgicp_fused.py:353`): they decide which exact ties average."""
    return min(MAX_TILE, P + (-P) % 8)


def _pack_sources(T, src_xyz, src_mask, src_cov6, ts):
    """Sources padded to a multiple of the block size ts and packed (Np, 10)
    as [xyz, mask, cov6], grouped by frame: Bk frames of Nf sources, blocks
    never straddle frames. -> (T (Bk, 4, 4), src, ts, Bk, Nf)."""
    n = src_xyz.shape[0]
    if src_mask.shape != (n,) or src_cov6.shape != (n, 6) or src_xyz.shape != (n, 3):
        raise ValueError(f"sources: xyz {tuple(src_xyz.shape)}, mask "
                         f"{tuple(src_mask.shape)}, cov {tuple(src_cov6.shape)}")
    if n == 0:
        raise ValueError("empty source cloud")
    f32 = torch.float32
    ts = min(ts, max(8, n))
    pad = (-n) % ts
    src = torch.cat([src_xyz.to(f32), src_mask.to(f32)[:, None], src_cov6.to(f32)], dim=-1)
    if pad:
        src = torch.cat([src, src.new_zeros((pad, 10))])
    Np = n + pad
    T = T.to(f32)
    Tk = T[None] if T.dim() == 2 else T
    Bk = Tk.shape[0]
    if (Np // ts) % Bk:
        raise ValueError(f"{Np // ts} source blocks do not split over {Bk} frames")
    return Tk.reshape(Bk, 4, 4).contiguous(), src.contiguous(), ts, Bk, Np // Bk


def _prepare(T, src_xyz, src_mask, src_cov6, tgt_mean, tgt_cov6, tgt_mask,
             ts, tgt_count, gate_axis):
    """Shared layout of the kernel and its plain version: the sources of
    `_pack_sources`, targets packed (P, 10) as [mean3, cov6, penalty], the
    live count as an int32 (1,) tensor."""
    P = tgt_mean.shape[0]
    if tgt_cov6.shape != (P, 6) or tgt_mask.shape != (P,) or tgt_mean.shape != (P, 3):
        raise ValueError(f"targets: mean {tuple(tgt_mean.shape)}, cov "
                         f"{tuple(tgt_cov6.shape)}, mask {tuple(tgt_mask.shape)}")
    if P == 0:
        raise ValueError("empty target cloud")
    if gate_axis is not None and tuple(gate_axis.shape) != (2,):
        raise ValueError(f"gate_axis has shape {tuple(gate_axis.shape)}, expected (2,)")
    f32 = torch.float32
    Tk, src, ts, Bk, Nf = _pack_sources(T, src_xyz, src_mask, src_cov6, ts)
    pen = torch.where(tgt_mask > 0.5, 0.0, _BIG).to(f32)
    tgt10 = torch.cat([tgt_mean.to(f32), tgt_cov6.to(f32), pen[:, None]], dim=-1)
    if tgt_count is None:
        cnt = torch.full((1,), P, dtype=torch.int32, device=src.device)
    else:
        cnt = torch.as_tensor(tgt_count, device=src.device).to(torch.int32).reshape(1)
    return Tk, src, tgt10.contiguous(), cnt, ts, Bk, Nf


def _finish(acc_frames, groups, dtype, best, return_best):
    """(Bk, 30) float64 per-frame sums -> unpacked f32 results, summed over
    `groups` consecutive frame groups (1 group: one result)."""
    Bk = acc_frames.shape[0]
    acc = acc_frames.reshape(groups, Bk // groups, NUM_ACC).sum(dim=1).to(torch.float32)
    out = _unpack_accumulators(acc if groups > 1 else acc[0], dtype)
    return out + (best,) if return_best else out


def vgicp_iteration(
    T: torch.Tensor,
    src_xyz: torch.Tensor,
    src_mask: torch.Tensor,
    src_cov6: torch.Tensor,
    tgt_mean: torch.Tensor,
    tgt_cov6: torch.Tensor,
    tgt_mask: torch.Tensor,
    max_correspondence_dist: float = 2.0,
    cov_eps: float = 1e-3,
    ts: int = 2048,
    tgt_count: Optional[torch.Tensor] = None,
    return_best: bool = False,
    gate_axis: Optional[torch.Tensor] = None,
    _acc_groups: int = 1,
):
    """One fused GN pass -> (H (6,6), g (6,), cost, wsum, d2sum) [+ the
    (ns, 10, ts) matched payload [d2, mean3, cov6] when `return_best`].

    T: (4,4), or (B,4,4) mapping frame b to its ns/B consecutive source
    blocks of ts points. `tgt_count`: live target rows when they are packed
    to the front (tiles past it are skipped). CPU tensors run the plain
    version; CUDA tensors launch the CUDA kernel (all on one device) or
    raise."""
    args = (T, src_xyz, src_mask, src_cov6, tgt_mean, tgt_cov6, tgt_mask)
    kw = dict(max_correspondence_dist=max_correspondence_dist, cov_eps=cov_eps,
              ts=ts, tgt_count=tgt_count, return_best=return_best,
              gate_axis=gate_axis, _acc_groups=_acc_groups)
    tensors = args + tuple(x for x in (tgt_count, gate_axis) if torch.is_tensor(x))
    if all(x.device.type == "cpu" for x in tensors):
        return vgicp_iteration_plain(*args, **kw)
    if not all(x.is_cuda and x.device == src_xyz.device for x in tensors):
        raise ValueError("vgicp_iteration: inputs must all be on the CPU or all "
                         f"on one CUDA device, got {[str(x.device) for x in tensors]}")
    return _vgicp_sweep_cuda(*args, **kw)


def vgicp_iteration_batch(
    T: torch.Tensor,
    src_xyz: torch.Tensor,
    src_mask: torch.Tensor,
    src_cov6: torch.Tensor,
    tgt_mean: torch.Tensor,
    tgt_cov6: torch.Tensor,
    tgt_mask: torch.Tensor,
    max_correspondence_dist: float = 2.0,
    cov_eps: float = 1e-3,
    ts: int = 2048,
    tgt_count: Optional[torch.Tensor] = None,
    return_best: bool = False,
    gate_axis: Optional[torch.Tensor] = None,
):
    """B frames against ONE shared target in a single sweep -> (H (B,6,6),
    g (B,6), cost (B,), wsum (B,), d2sum (B,)) [+ best]. T: (B,4,4);
    src_xyz/src_mask/src_cov6: (B,N,...); N must be a multiple of the
    source block size (blocks never straddle frames)."""
    B, N = src_xyz.shape[0], src_xyz.shape[1]
    ts = min(ts, max(8, N))
    if N % ts:
        raise ValueError(f"batched sweep needs N % ts == 0, got {N}, {ts}")
    return vgicp_iteration(
        T, src_xyz.reshape(B * N, 3), src_mask.reshape(B * N),
        src_cov6.reshape(B * N, 6), tgt_mean, tgt_cov6, tgt_mask,
        max_correspondence_dist=max_correspondence_dist, cov_eps=cov_eps,
        ts=ts, tgt_count=tgt_count, return_best=return_best,
        gate_axis=gate_axis, _acc_groups=B)


def vgicp_iteration_frozen(
    T: torch.Tensor,
    src_xyz: torch.Tensor,
    src_mask: torch.Tensor,
    src_cov6: torch.Tensor,
    best: torch.Tensor,
    max_correspondence_dist: float = 2.0,
    cov_eps: float = 1e-3,
    _acc_groups: int = 1,
):
    """GN pass re-linearised at T on FROZEN correspondences: the (ns, 10,
    ts) payload `best` of an earlier `vgicp_iteration(..., return_best=True)`
    over the same sources, no search -> (H, g, cost, wsum, d2sum) as a
    sweep gives them. Each source is gated on its fresh |q - p|^2; a source
    the sweep never matched (stale d2 >= 2.5e29) gets 1e30 and no weight.
    The source block size is `best`'s own ts. CPU tensors run the plain
    version; CUDA tensors launch the CUDA kernel or raise."""
    args = (T, src_xyz, src_mask, src_cov6, best)
    kw = dict(max_correspondence_dist=max_correspondence_dist, cov_eps=cov_eps,
              _acc_groups=_acc_groups)
    if all(x.device.type == "cpu" for x in args):
        return vgicp_iteration_frozen_plain(*args, **kw)
    if not all(x.is_cuda and x.device == src_xyz.device for x in args):
        raise ValueError("vgicp_iteration_frozen: inputs must all be on the CPU or all "
                         f"on one CUDA device, got {[str(x.device) for x in args]}")
    return _vgicp_frozen_cuda(*args, **kw)


def _prepare_frozen(T, src_xyz, src_mask, src_cov6, best, _acc_groups):
    """`_pack_sources` at the payload's block size; checks that the payload
    covers exactly the padded sources."""
    if best.dim() != 3 or best.shape[1] != 10:
        raise ValueError(f"best has shape {tuple(best.shape)}, expected (ns, 10, ts)")
    Tk, src, ts, Bk, Nf = _pack_sources(T, src_xyz, src_mask, src_cov6, best.shape[2])
    if ts != best.shape[2] or Bk * Nf != best.shape[0] * ts:
        raise ValueError(f"best {tuple(best.shape)} does not match {src_xyz.shape[0]} "
                         f"sources in blocks of {best.shape[2]}")
    if Bk % _acc_groups:
        raise ValueError(f"{Bk} frames do not split into {_acc_groups} groups")
    return Tk, src, ts, Bk, Nf


def best_payload_to_rows(best: torch.Tensor, n: int) -> torch.Tensor:
    """(ns, 10, ts) blocked matched payload (the `return_best` layout) ->
    (n, 10) rows [d2, q0..2, cb0..5]; row i is source point i."""
    ns, _, ts = best.shape
    return best.transpose(1, 2).reshape(ns * ts, 10)[:n]


def vgicp_iteration_frozen_plain(
    T: torch.Tensor,
    src_xyz: torch.Tensor,
    src_mask: torch.Tensor,
    src_cov6: torch.Tensor,
    best: torch.Tensor,
    max_correspondence_dist: float = 2.0,
    cov_eps: float = 1e-3,
    _acc_groups: int = 1,
):
    """Plain-torch twin of the frozen kernel, on any device: the kernel's
    p, fresh distance and GN terms (`_gn_accumulators`), summed in float64
    per frame and returned as float32."""
    Tk, src, ts, Bk, Nf = _prepare_frozen(T, src_xyz, src_mask, src_cov6, best,
                                          _acc_groups)
    rows = best_payload_to_rows(best.to(torch.float32), Bk * Nf).reshape(Bk, Nf, 10)
    src = src.reshape(Bk, Nf, 10)
    R = [[Tk[:, r, c, None] for c in range(3)] for r in range(3)]
    s = [src[..., k] for k in range(10)]
    p = [R[r][0] * s[0] + R[r][1] * s[1] + R[r][2] * s[2] + Tk[:, r, 3, None]
         for r in range(3)]
    pay = list(rows.unbind(-1))
    d = [pay[1 + k] - p[k] for k in range(3)]
    fresh = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    gate_d2 = torch.where(pay[0] < 2.5e29, fresh, _BIG)
    terms = _gn_accumulators(R, p, s[3], s[4:10], pay[1:], gate_d2,
                             sweep_gate(max_correspondence_dist), float(np.float32(cov_eps)))
    return _finish(terms.sum(dim=1, dtype=torch.float64), _acc_groups, src_xyz.dtype,
                   None, False)


def _lib() -> ctypes.CDLL:
    from icp4dradar_tpu_torch.ops import _build

    lib = _build.load_library()
    if lib.vgicp_sweep_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.vgicp_sweep_launch.argtypes = [p, p, p, p, i, i, i, i, i, i,
                                           ctypes.c_float, ctypes.c_float, p, p, p]
        lib.vgicp_sweep_launch.restype = i
        lib.vgicp_sweep_threads.argtypes = []
        lib.vgicp_sweep_threads.restype = i
        lib.vgicp_frozen_launch.argtypes = [p, p, p, i, i, i, i, ctypes.c_float,
                                            ctypes.c_float, p, p]
        lib.vgicp_frozen_launch.restype = i
    return lib


def _vgicp_sweep_cuda(T, src_xyz, src_mask, src_cov6, tgt_mean, tgt_cov6,
                      tgt_mask, max_correspondence_dist, cov_eps, ts,
                      tgt_count, return_best, gate_axis, _acc_groups):
    global VGICP_SWEEP_LAUNCHES
    for name, x in (("T", T), ("src_xyz", src_xyz), ("src_mask", src_mask),
                    ("src_cov6", src_cov6), ("tgt_mean", tgt_mean),
                    ("tgt_cov6", tgt_cov6), ("tgt_mask", tgt_mask)):
        if x.dtype != torch.float32:
            raise ValueError(f"vgicp_sweep kernel takes float32 tensors; {name} "
                             f"is {x.dtype}")
    Tk, src, tgt10, cnt, ts, Bk, Nf = _prepare(
        T, src_xyz, src_mask, src_cov6, tgt_mean, tgt_cov6, tgt_mask, ts,
        tgt_count, gate_axis)
    if Bk % _acc_groups:
        raise ValueError(f"{Bk} frames do not split into {_acc_groups} groups")
    lib = _lib()
    P = tgt10.shape[0]
    nblk = -(-Nf // lib.vgicp_sweep_threads())
    # per-block float64 partials: one deterministic sum over blocks below
    out = torch.empty((Bk, nblk, NUM_ACC), dtype=torch.float64, device=src.device)
    best = (torch.empty((Bk * Nf // ts, 10, ts), dtype=torch.float32, device=src.device)
            if return_best else None)
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        for b0 in range(0, Bk, _GRID_Y_MAX):
            nb = min(_GRID_Y_MAX, Bk - b0)
            rc = lib.vgicp_sweep_launch(
                Tk[b0].data_ptr(), src[b0 * Nf].data_ptr(), tgt10.data_ptr(),
                cnt.data_ptr(), nb, Nf, b0 * Nf, P, target_tile_rows(P), ts,
                sweep_gate(max_correspondence_dist), float(np.float32(cov_eps)),
                out[b0].data_ptr(), best.data_ptr() if best is not None else None,
                stream)
            if rc != 0:
                raise RuntimeError(f"vgicp_sweep kernel launch failed: CUDA error "
                                   f"{rc} (B={nb}, N={Nf}, P={P})")
            VGICP_SWEEP_LAUNCHES += 1
    return _finish(out.sum(dim=1), _acc_groups, src_xyz.dtype, best, return_best)


def _vgicp_frozen_cuda(T, src_xyz, src_mask, src_cov6, best, max_correspondence_dist,
                       cov_eps, _acc_groups):
    global VGICP_FROZEN_LAUNCHES
    for name, x in (("T", T), ("src_xyz", src_xyz), ("src_mask", src_mask),
                    ("src_cov6", src_cov6), ("best", best)):
        if x.dtype != torch.float32:
            raise ValueError(f"vgicp_frozen kernel takes float32 tensors; {name} "
                             f"is {x.dtype}")
    if not best.is_contiguous():
        raise ValueError("vgicp_frozen kernel takes a contiguous best payload")
    Tk, src, ts, Bk, Nf = _prepare_frozen(T, src_xyz, src_mask, src_cov6, best,
                                          _acc_groups)
    lib = _lib()
    nblk = -(-Nf // lib.vgicp_sweep_threads())
    out = torch.empty((Bk, nblk, NUM_ACC), dtype=torch.float64, device=src.device)
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        for b0 in range(0, Bk, _GRID_Y_MAX):
            nb = min(_GRID_Y_MAX, Bk - b0)
            rc = lib.vgicp_frozen_launch(
                Tk[b0].data_ptr(), src[b0 * Nf].data_ptr(), best.data_ptr(), nb, Nf,
                b0 * Nf, ts, sweep_gate(max_correspondence_dist),
                float(np.float32(cov_eps)), out[b0].data_ptr(), stream)
            if rc != 0:
                raise RuntimeError(f"vgicp_frozen kernel launch failed: CUDA error "
                                   f"{rc} (B={nb}, N={Nf}, ts={ts})")
            VGICP_FROZEN_LAUNCHES += 1
    return _finish(out.sum(dim=1), _acc_groups, src_xyz.dtype, None, False)


def vgicp_iteration_plain(
    T: torch.Tensor,
    src_xyz: torch.Tensor,
    src_mask: torch.Tensor,
    src_cov6: torch.Tensor,
    tgt_mean: torch.Tensor,
    tgt_cov6: torch.Tensor,
    tgt_mask: torch.Tensor,
    max_correspondence_dist: float = 2.0,
    cov_eps: float = 1e-3,
    ts: int = 2048,
    tgt_count: Optional[torch.Tensor] = None,
    return_best: bool = False,
    gate_axis: Optional[torch.Tensor] = None,
    _acc_groups: int = 1,
    max_tile_elems: int = 1 << 24,
):
    """Plain-torch twin of the kernel, on any device: the same tiles, ties
    averaged within a tile, strict-less across tiles, the same live-tile
    skip, `max_tile_elems // (Nf * tm)` frames at a time. Sums run in
    float64 and return as float32. Reads the live count on the host."""
    Tk, src, tgt10, cnt, ts, Bk, Nf = _prepare(
        T, src_xyz, src_mask, src_cov6, tgt_mean, tgt_cov6, tgt_mask, ts,
        tgt_count, gate_axis)
    if Bk % _acc_groups:
        raise ValueError(f"{Bk} frames do not split into {_acc_groups} groups")
    P = tgt10.shape[0]
    tm = target_tile_rows(P)
    live_tiles = max(1, min(-(-P // tm), -(-int(cnt.item()) // tm)))
    gate = sweep_gate(max_correspondence_dist)
    eps = float(np.float32(cov_eps))
    src = src.reshape(Bk, Nf, 10)
    frames = max(1, max_tile_elems // (Nf * tm))
    accs, bests = [], []
    for f0 in range(0, Bk, frames):
        acc, best = _plain_chunk(Tk[f0:f0 + frames], src[f0:f0 + frames], tgt10,
                                 tm, live_tiles, gate, eps)
        accs.append(acc)
        bests.append(best)
    best = None
    if return_best:
        best = torch.cat(bests).reshape(-1, ts, 10).transpose(1, 2).contiguous()
    return _finish(torch.cat(accs), _acc_groups, src_xyz.dtype, best, return_best)


def _plain_chunk(T, src, tgt10, tm, live_tiles, gate, eps):
    """(b,4,4), (b,Nf,10) sources -> ((b,30) float64 sums, (b,Nf,10) best
    rows [d2, mean3, cov6])."""
    R = [[T[:, r, c, None] for c in range(3)] for r in range(3)]
    s = [src[..., k] for k in range(10)]
    # p = R s + t, summed left to right: (b, Nf) per coordinate
    p = [R[r][0] * s[0] + R[r][1] * s[1] + R[r][2] * s[2] + T[:, r, 3, None]
         for r in range(3)]
    best_d2 = torch.full_like(p[0], _BIG)
    best_pay = torch.zeros(p[0].shape + (9,), dtype=p[0].dtype, device=p[0].device)
    for j in range(live_tiles):
        t = tgt10[j * tm:(j + 1) * tm]                        # (rows, 10)
        d2 = t[:, 9]
        for k in range(3):
            diff = t[:, k] - p[k][..., None]                  # (b, Nf, rows)
            d2 = d2 + diff * diff
        dmin = torch.amin(d2, dim=-1)
        onehot = (d2 <= dmin[..., None]).to(d2.dtype)
        del d2
        pay = (onehot @ t[:, :9]) / torch.clamp(onehot.sum(dim=-1), min=1.0)[..., None]
        del onehot
        better = dmin < best_d2
        best_d2 = torch.where(better, dmin, best_d2)
        best_pay = torch.where(better[..., None], pay, best_pay)
    terms = _gn_accumulators(R, p, s[3], s[4:10], list(best_pay.unbind(-1)),
                             best_d2, gate, eps)
    return (terms.sum(dim=1, dtype=torch.float64),
            torch.cat([best_d2[..., None], best_pay], dim=-1))
