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

- `vgicp_prepare` packs a registration's operands once (`VgicpOperands`):
  sources (Np, 10), targets (P, 4) [mean, penalty] and (P, 8) covariances
  with each tile's live rows first, per-tile live counts, the live count.
  `vgicp_sweep` runs one GN pass at T over them and `vgicp_frozen` one
  frozen step (below); the GN loops of `registration/vgicp.py` prepare once
  and call these. Both dispatch on the operands' device: CPU tensors go to
  the plain version; CUDA tensors launch the hand-written kernels of
  `csrc/vgicp_sweep.cu` or raise, and copy nothing from the host (no host
  sync inside a call).
- A stream axis (serving, `run_scan_to_map_batch`): targets (S, P, ...)
  with per-stream live counts pack into S target sets, and the frames are
  S runs of frames / S frames, run s sweeping set s, in the same one launch
  (the JAX package vmaps its `pallas_call`, whose batching rule gives the
  kernel a batch grid axis with one target set per stream). One stream is
  the single-target sweep, with the same bits.
- `vgicp_iteration` / `vgicp_iteration_batch` keep the JAX package's
  signatures and layouts: they prepare the operands for one call and sweep.
- `vgicp_iteration_plain` is plain torch with the kernel's semantics on the
  same prepared operands, chunked over frames so that the (frames, N, tm)
  distance tile stays bounded.
- `vgicp_iteration_frozen` (the inner GN steps, `gicp.inner_gn_steps >
  0`) re-linearises the same 30 sums at a new T on the payload a sweep
  returned under `return_best`, with no search: the kernel
  `vgicp_frozen_launch` of the same source on CUDA tensors, one launch that
  writes each frame group's finished float32 row (H unpacked, g, cost,
  wsum, d2sum) and returns views of it, or `vgicp_iteration_frozen_plain`
  on CPU tensors, which sums in float64 and lays out the same rows.

The ring VGICP (`parallel/ring_vgicp.py`) sweeps one scan slice against
every visiting shard: `vgicp_pack_targets` packs a shard once, the sweep
returns its payload with `return_best`, `merge_best_rows` keeps the running
best (strictly smaller d2; JAX's rule at ties across shards), and one frozen
step reads the merged payload in the same blocked layout.

The band-gate tile skip of the Pallas kernel (`:137-144`) is not ported: a
tile it skips holds no voxel within the correspondence gate, so it changes
no accumulator; `gate_axis` is accepted and only checked for shape.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch

from icp4dradar_tpu_torch.geom.linalg import broadcast_shape, pairwise_sum
from icp4dradar_tpu_torch.ops import _build
from icp4dradar_tpu_torch.utils import profiling

_BIG = 1e30
NUM_ACC = 30
NUM_FROZEN_OUT = 45  # a frozen step's finished row: H (36), g (6), cost, wsum, d2sum
MAX_TILE = 1024

# Kernel launches of the sweep (`vgicp_sweep` and the calls built on it) in
# this process; the CUDA path adds one per kernel launch and nowhere else.
VGICP_SWEEP_LAUNCHES = 0
# Kernel launches of the frozen step (`vgicp_frozen`), counted the same way.
VGICP_FROZEN_LAUNCHES = 0

_GRID_Y_MAX = 65535  # CUDA grid.y limit: frames per launch
_INT_MAX = 2**31 - 1


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
    shape = broadcast_shape(*(t.shape for t in terms))
    return torch.stack([t.expand(shape) for t in terms], dim=-1)


_SYM6_INDEX = {}  # device -> (36,) index of each H entry in the packed 21


def _sym6_index(device) -> torch.Tensor:
    """Index of H[r, c] in the packed upper triangle (row-major, as
    `triu_indices(6, 6)`), made once per device so that unpacking H copies
    nothing from the host."""
    idx = _SYM6_INDEX.get(device)
    if idx is None:
        packed = {}
        for r in range(6):
            for c in range(r, 6):
                packed[(r, c)] = len(packed)
        idx = torch.tensor([packed[(min(r, c), max(r, c))] for r in range(6) for c in range(6)],
                           device=device)
        _SYM6_INDEX[device] = idx
    return idx


def _unpack_accumulators(acc: torch.Tensor, dtype=torch.float32):
    """(..., 30) -> (H (..., 6, 6), g (..., 6), cost, wsum, d2sum). One
    gather on the device: no host sync."""
    H = acc[..., :21].to(dtype).index_select(-1, _sym6_index(acc.device))
    return (H.reshape(acc.shape[:-1] + (6, 6)), acc[..., 21:27].to(dtype), acc[..., 27],
            acc[..., 28], acc[..., 29])


def sweep_gate(max_correspondence_dist: float) -> float:
    """The squared-distance gate of the TPU kernel, min(d^2, 5e29), rounded
    to f32 as the kernel compares it."""
    return float(np.float32(min(float(max_correspondence_dist) ** 2, _BIG * 0.5)))


def target_tile_rows(P: int) -> int:
    """Rows per target tile, as the Pallas kernel chooses them
    (`vgicp_fused.py:353`): they decide which exact ties average."""
    return min(MAX_TILE, P + (-P) % 8)


@dataclass(frozen=True)
class VgicpOperands:
    """A registration's sweep operands, packed once (`vgicp_prepare`) and
    read in place by every sweep (K4) and frozen step (K5) of its GN loop.

    - `src` (frames * per_frame, 10): [xyz, mask, cov6] per source, each
      frame's sources zero-padded to a multiple of the block size `ts`
      (blocks never straddle frames); `n` sources before padding.
    - `tgt` (P, 4): [mean3, penalty] (penalty 1e30 where masked), with the
      live rows of each tile of `tm` rows first, in row order; `tgt_cov`
      (P, 8): [cov6, 0, 0] in the same order; `tile_live` (P / tm,) int32
      live rows per tile; `count` (1,) int32 live rows of the caller's
      layout (tiles past it are skipped). All None, and tm 0, for
      sources-only operands (the frozen step).
    - `streams` S > 1 (serving): S target sets of P rows each, stacked
      (S * P, 4) / (S * P, 8), `tile_live` (S, P / tm), `count` (S,); the
      frames are S runs of frames / S consecutive frames, run s sweeping
      set s.
    - `dtype`: the caller's dtype of the results."""

    src: torch.Tensor
    frames: int
    per_frame: int
    ts: int
    n: int
    dtype: torch.dtype
    tgt: Optional[torch.Tensor] = None
    tgt_cov: Optional[torch.Tensor] = None
    tile_live: Optional[torch.Tensor] = None
    count: Optional[torch.Tensor] = None
    tm: int = 0
    streams: int = 1

    @property
    def rows(self) -> int:
        """P, the target rows of one stream."""
        return self.tgt.shape[0] // self.streams


def _check_devices(name, tensors):
    """All on the CPU (-> False), or all on one CUDA device and float32
    there (-> True); else raises."""
    if all(x.device.type == "cpu" for x in tensors):
        return False
    dev = tensors[0].device
    if not all(x.is_cuda and x.device == dev for x in tensors):
        raise ValueError(f"{name}: inputs must all be on the CPU or all on one CUDA "
                         f"device, got {[str(x.device) for x in tensors]}")
    for x in tensors:
        if x.is_floating_point() and x.dtype != torch.float32:
            raise ValueError(f"{name}: the CUDA kernels take float32 tensors, got {x.dtype}")
    return True


def _pack_sources(src_xyz, src_mask, src_cov6, ts, frames):
    """Sources padded to a multiple of the block size ts and packed (Np, 10)
    as [xyz, mask, cov6], grouped by frame: `frames` frames of Np / frames
    sources, blocks never straddle frames. -> (src, ts, per_frame)."""
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
    if (Np // ts) % frames:
        raise ValueError(f"{Np // ts} source blocks do not split over {frames} frames")
    return src.contiguous(), ts, Np // frames


def _pack_targets(tgt_mean, tgt_cov6, tgt_mask, tgt_count, device):
    """Targets ([S,] P, 3) / ([S,] P, 6) / ([S,] P) -> (S * P, 4) [mean3,
    penalty] and (S * P, 8) [cov6, 0, 0] with each tile's live rows first in
    row order (one stable sort on the device for all streams), the per-tile
    live counts ([S,] P / tm), the live counts ((S,), (1,) for one set) and
    the tile rows."""
    streamed = tgt_mean.dim() == 3
    if not streamed:
        tgt_mean, tgt_cov6, tgt_mask = tgt_mean[None], tgt_cov6[None], tgt_mask[None]
    S, P = tgt_mean.shape[:2]
    if tgt_cov6.shape != (S, P, 6) or tgt_mask.shape != (S, P) or tgt_mean.shape != (S, P, 3):
        raise ValueError(f"targets: mean {tuple(tgt_mean.shape)}, cov "
                         f"{tuple(tgt_cov6.shape)}, mask {tuple(tgt_mask.shape)}")
    if P == 0:
        raise ValueError("empty target cloud")
    f32 = torch.float32
    tm = target_tile_rows(P)
    nt = -(-P // tm)
    live = tgt_mask > 0.5
    tile = torch.arange(P, device=device) // tm
    order = torch.argsort(2 * tile + (~live).to(tile.dtype), dim=-1, stable=True)
    order = (order + torch.arange(S, device=device)[:, None] * P).reshape(-1)
    pen = torch.where(live, 0.0, _BIG).to(f32)
    tgt = torch.cat([tgt_mean.to(f32), pen[..., None]], dim=-1).reshape(S * P, 4)
    cov = torch.cat([tgt_cov6.to(f32), tgt_cov6.new_zeros((S, P, 2), dtype=f32)],
                    dim=-1).reshape(S * P, 8)
    tile_live = torch.zeros(S * nt, dtype=torch.int32, device=device).index_add_(
        0, (tile + torch.arange(S, device=device)[:, None] * nt).reshape(-1),
        live.to(torch.int32).reshape(-1)).reshape(S, nt)
    if tgt_count is None:
        count = torch.full((S,), P, dtype=torch.int32, device=device)
    else:
        count = torch.as_tensor(tgt_count, device=device).to(torch.int32).reshape(S)
    if not streamed:
        tile_live = tile_live[0]
    return tgt[order].contiguous(), cov[order].contiguous(), tile_live, count, tm, S


def vgicp_prepare(
    src_xyz: torch.Tensor,
    src_mask: torch.Tensor,
    src_cov6: torch.Tensor,
    tgt_mean: Optional[torch.Tensor] = None,
    tgt_cov6: Optional[torch.Tensor] = None,
    tgt_mask: Optional[torch.Tensor] = None,
    *,
    frames: int = 1,
    ts: int = 2048,
    tgt_count: Optional[torch.Tensor] = None,
    gate_axis: Optional[torch.Tensor] = None,
) -> VgicpOperands:
    """Pack a registration's operands once (`VgicpOperands`).

    Sources: (n,3) / (n,) / (n,6) for `frames` frames of equal block counts,
    or (B,N,3) / (B,N) / (B,N,6) for B frames (N a multiple of the block
    size min(ts, N)). Targets (P,3) / (P,6) / (P,); leave them out for a
    frozen step's sources-only operands. `tgt_count`: live target rows when
    front-packed (tiles past it are skipped). `gate_axis` (2,) is checked
    for shape only. With a stream axis on the targets, (S,P,3) / (S,P,6) /
    (S,P), `tgt_count` (S,) and `gate_axis` (S,2), the B frames are S runs
    of B / S frames, run s against target set s (serving). All on the CPU
    or all on one CUDA device (float32 there); nothing is read on the
    host."""
    tgts = (tgt_mean, tgt_cov6, tgt_mask)
    if any(x is None for x in tgts) and not all(x is None for x in tgts):
        raise ValueError("give all of tgt_mean, tgt_cov6 and tgt_mask, or none")
    tensors = (src_xyz, src_mask, src_cov6) + tuple(x for x in tgts if x is not None) + tuple(
        x for x in (tgt_count, gate_axis) if torch.is_tensor(x))
    _check_devices("vgicp_prepare", tensors)
    lead = tuple(tgt_mean.shape[:-2]) if tgt_mean is not None else ()
    if gate_axis is not None and tuple(gate_axis.shape) != lead + (2,):
        raise ValueError(f"gate_axis has shape {tuple(gate_axis.shape)}, expected "
                         f"{lead + (2,)}")
    dtype = src_xyz.dtype
    if src_xyz.dim() == 3:
        B, N = src_xyz.shape[0], src_xyz.shape[1]
        ts = min(ts, max(8, N))
        if N % ts:
            raise ValueError(f"batched sweep needs N % ts == 0, got {N}, {ts}")
        src_xyz, src_mask, src_cov6 = (src_xyz.reshape(B * N, 3), src_mask.reshape(B * N),
                                       src_cov6.reshape(B * N, 6))
        frames = B
    src, ts, per_frame = _pack_sources(src_xyz, src_mask, src_cov6, ts, frames)
    ops = VgicpOperands(src=src, frames=frames, per_frame=per_frame, ts=ts,
                        n=src_xyz.shape[0], dtype=dtype)
    if tgt_mean is None:
        return ops
    tgt, cov, tile_live, count, tm, S = _pack_targets(tgt_mean, tgt_cov6, tgt_mask,
                                                      tgt_count, src.device)
    if frames % S:
        raise ValueError(f"{frames} frames do not split over {S} streams")
    return replace(ops, tgt=tgt, tgt_cov=cov, tile_live=tile_live, count=count, tm=tm,
                   streams=S)


def vgicp_pack_targets(
    tgt_mean: torch.Tensor,
    tgt_cov6: torch.Tensor,
    tgt_mask: torch.Tensor,
    tgt_count: Optional[torch.Tensor] = None,
) -> dict:
    """One target set (P,3) / (P,6) / (P,) packed as `vgicp_prepare` packs
    it, as the target fields of `VgicpOperands`: `dataclasses.replace(ops,
    **targets)` sweeps it from any prepared sources (the ring's sweeps of
    one scan slice against each visiting shard pack neither side twice)."""
    _check_devices("vgicp_pack_targets", (tgt_mean, tgt_cov6, tgt_mask) + tuple(
        x for x in (tgt_count,) if torch.is_tensor(x)))
    if tgt_mean.dim() != 2:
        raise ValueError(f"vgicp_pack_targets takes one target set, got "
                         f"{tuple(tgt_mean.shape)}")
    tgt, cov, tile_live, count, tm, S = _pack_targets(tgt_mean, tgt_cov6, tgt_mask, tgt_count,
                                                      tgt_mean.device)
    return dict(tgt=tgt, tgt_cov=cov, tile_live=tile_live, count=count, tm=tm, streams=S)


def _frames_T(T, ops, groups):
    """T (4,4) or (frames,4,4) -> (frames,4,4) float32, contiguous."""
    Tk = T[None] if T.dim() == 2 else T
    if tuple(Tk.shape) != (ops.frames, 4, 4):
        raise ValueError(f"T has shape {tuple(T.shape)}; the operands hold {ops.frames} frames")
    if ops.frames % groups:
        raise ValueError(f"{ops.frames} frames do not split into {groups} groups")
    return Tk.to(torch.float32).contiguous()


def _finish(acc_rows, groups, dtype, best, return_best):
    """A sweep's (frames, rows, 30) or (frames, 30) float64 partial sums ->
    unpacked f32 results, summed over `groups` consecutive frame groups (1
    group: one result). A pairwise sum (its order fixed by a group's rows
    alone: a library reduction over them splits its work by the number of
    groups, so a stream's sums would round by the size of its batch), a
    cast and a gather on the device."""
    acc = pairwise_sum(acc_rows.reshape(groups, -1, NUM_ACC), dim=1).to(torch.float32)
    out = _unpack_accumulators(acc if groups > 1 else acc[0], dtype)
    return out + (best,) if return_best else out


def vgicp_sweep(
    T: torch.Tensor,
    ops: VgicpOperands,
    max_correspondence_dist: float = 2.0,
    cov_eps: float = 1e-3,
    return_best: bool = False,
    _acc_groups: int = 1,
):
    """One fused GN pass at T over prepared operands -> (H (6,6), g (6,),
    cost, wsum, d2sum) [+ the (ns, 10, ts) matched payload [d2, mean3,
    cov6] when `return_best`]; with `_acc_groups` = B, per-group results
    with a leading (B,) axis. T: (4,4), or (frames,4,4) mapping frame b to
    its sources. CPU operands run the plain version; CUDA operands launch
    the CUDA kernel or raise. No host sync on the card."""
    if ops.tgt is None:
        raise ValueError("vgicp_sweep: the operands hold no targets")
    Tk = _frames_T(T, ops, _acc_groups)
    gate, eps = sweep_gate(max_correspondence_dist), float(np.float32(cov_eps))
    # the operands' tensors share src's device (vgicp_prepare)
    if not _check_devices("vgicp_sweep", (T, ops.src)):
        return _sweep_plain(Tk, ops, gate, eps, return_best, _acc_groups)
    return _vgicp_sweep_cuda(Tk, ops, gate, eps, return_best, _acc_groups)


def vgicp_frozen(
    T: torch.Tensor,
    ops: VgicpOperands,
    best: torch.Tensor,
    max_correspondence_dist: float = 2.0,
    cov_eps: float = 1e-3,
    _acc_groups: int = 1,
):
    """GN pass re-linearised at T on FROZEN correspondences: the (ns, 10,
    ts) payload `best` of an earlier sweep over the same prepared sources,
    no search -> (H, g, cost, wsum, d2sum) as a sweep gives them. Each source
    is gated on its fresh |q - p|^2; a source the sweep never matched (stale
    d2 >= 2.5e29) gets 1e30 and no weight. The results are views of one
    (groups, 45) float32 tensor. CPU operands run the plain version; CUDA
    operands launch the CUDA kernel (one launch, no host sync) or raise."""
    _check_payload(ops, best)
    Tk = _frames_T(T, ops, _acc_groups)
    gate, eps = sweep_gate(max_correspondence_dist), float(np.float32(cov_eps))
    if not _check_devices("vgicp_frozen", (T, best, ops.src)):
        return _frozen_plain(Tk, ops, best, gate, eps, _acc_groups)
    if not best.is_contiguous():
        raise ValueError("vgicp_frozen kernel takes a contiguous best payload")
    return _vgicp_frozen_cuda(Tk, ops, best, gate, eps, _acc_groups)


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
    (ns, 10, ts) matched payload [d2, mean3, cov6] when `return_best`]:
    `vgicp_sweep` on operands prepared for this call alone.

    T: (4,4), or (B,4,4) mapping frame b to its ns/B consecutive source
    blocks of ts points. `tgt_count`: live target rows when they are packed
    to the front (tiles past it are skipped). CPU tensors run the plain
    version; CUDA tensors launch the CUDA kernel (all on one device) or
    raise."""
    ops = vgicp_prepare(src_xyz, src_mask, src_cov6, tgt_mean, tgt_cov6, tgt_mask,
                        frames=1 if T.dim() == 2 else T.shape[0], ts=ts,
                        tgt_count=tgt_count, gate_axis=gate_axis)
    return vgicp_sweep(T, ops, max_correspondence_dist, cov_eps, return_best, _acc_groups)


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
    ops = vgicp_prepare(src_xyz, src_mask, src_cov6, tgt_mean, tgt_cov6, tgt_mask, ts=ts,
                        tgt_count=tgt_count, gate_axis=gate_axis)
    return vgicp_sweep(T, ops, max_correspondence_dist, cov_eps, return_best,
                       src_xyz.shape[0])


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
    """GN pass re-linearised at T on FROZEN correspondences (`vgicp_frozen`
    on sources prepared for this call alone): the (ns, 10, ts) payload
    `best` of an earlier `vgicp_iteration(..., return_best=True)` over the
    same sources, no search -> (H, g, cost, wsum, d2sum). The source block
    size is `best`'s own ts. CPU tensors run the plain version; CUDA tensors
    launch the CUDA kernel or raise."""
    return vgicp_frozen(T, _frozen_operands(T, src_xyz, src_mask, src_cov6, best), best,
                        max_correspondence_dist, cov_eps, _acc_groups)


def _check_payload(ops, best):
    """best must be the (ns, 10, ts) payload of exactly these sources."""
    if best.dim() != 3 or best.shape[1] != 10 or best.shape[2] != ops.ts or \
            best.shape[0] * ops.ts != ops.frames * ops.per_frame:
        raise ValueError(f"best {tuple(best.shape)} does not match {ops.n} sources in "
                         f"blocks of {ops.ts}")


def _frozen_operands(T, src_xyz, src_mask, src_cov6, best):
    if best.dim() != 3 or best.shape[1] != 10:
        raise ValueError(f"best has shape {tuple(best.shape)}, expected (ns, 10, ts)")
    return vgicp_prepare(src_xyz, src_mask, src_cov6, frames=1 if T.dim() == 2 else T.shape[0],
                         ts=best.shape[2])


def best_payload_to_rows(best: torch.Tensor, n: int) -> torch.Tensor:
    """(ns, 10, ts) blocked matched payload (the `return_best` layout) ->
    (n, 10) rows [d2, q0..2, cb0..5]; row i is source point i."""
    ns, _, ts = best.shape
    return best.transpose(1, 2).reshape(ns * ts, 10)[:n]


def merge_best_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Running-best merge of two matched payloads by distance, the ring
    step's combiner: (n, 10) rows, or the blocked (ns, 10, ts) `return_best`
    layout (d2 is column 0 of the rows, row 0 of a block). b's entry
    replaces a's only at a STRICTLY smaller d2: on equal d2 the earlier
    shard's match stays (the JAX package's rule; K4 averages ties inside a
    shard)."""
    return torch.where(b[:, 0:1] < a[:, 0:1], b, a)


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
    ops = _frozen_operands(T, src_xyz, src_mask, src_cov6, best)
    _check_payload(ops, best)
    return _frozen_plain(_frames_T(T, ops, _acc_groups), ops, best,
                         sweep_gate(max_correspondence_dist), float(np.float32(cov_eps)),
                         _acc_groups)


def _frozen_plain(Tk, ops, best, gate, eps, groups):
    Bk, Nf = ops.frames, ops.per_frame
    rows = best_payload_to_rows(best.to(torch.float32), Bk * Nf).reshape(Bk, Nf, 10)
    src = ops.src.reshape(Bk, Nf, 10)
    R = [[Tk[:, r, c, None] for c in range(3)] for r in range(3)]
    s = [src[..., k] for k in range(10)]
    p = [R[r][0] * s[0] + R[r][1] * s[1] + R[r][2] * s[2] + Tk[:, r, 3, None]
         for r in range(3)]
    pay = list(rows.unbind(-1))
    d = [pay[1 + k] - p[k] for k in range(3)]
    fresh = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    gate_d2 = torch.where(pay[0] < 2.5e29, fresh, _BIG)
    terms = _gn_accumulators(R, p, s[3], s[4:10], pay[1:], gate_d2, gate, eps)
    acc = (terms.sum(dim=1, dtype=torch.float64).reshape(groups, -1, NUM_ACC).sum(dim=1)
           .to(torch.float32))
    out = torch.cat([acc.index_select(-1, _sym6_index(acc.device)), acc[:, 21:]], dim=-1)
    return _frozen_results(out if groups > 1 else out[0], ops.dtype)


def _frozen_results(out, dtype):
    """(groups, 45) or (45,) finished rows [H (36, row-major), g (6), cost,
    wsum, d2sum] -> views (H, g, cost, wsum, d2sum)."""
    H, g, rest = out.split([36, 6, 3], dim=-1)
    H = H.unflatten(-1, (6, 6))
    if dtype != torch.float32:
        H, g = H.to(dtype), g.to(dtype)
    return (H, g) + rest.unbind(-1)


def _lib() -> ctypes.CDLL:
    lib = _build.load_library()
    if lib.vgicp_sweep_launch.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.vgicp_sweep_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i, f, f, p, p,
                                           p]
        lib.vgicp_sweep_launch.restype = i
        lib.vgicp_sweep_sources_per_block.argtypes = []
        lib.vgicp_sweep_sources_per_block.restype = i
        lib.vgicp_frozen_launch.argtypes = [p, p, p, i, i, i, i, f, f, p, p]
        lib.vgicp_frozen_launch.restype = i
    return lib


def _row_ptr(x, row):
    """Address of x[row] without making a view (contiguous x)."""
    return x.data_ptr() + row * x.stride(0) * x.element_size()


def _vgicp_sweep_cuda(Tk, ops, gate, eps, return_best, groups):
    lib = _lib()
    nblk = -(-ops.per_frame // lib.vgicp_sweep_sources_per_block())
    dev = ops.src.device
    # per-block float64 partials, summed on the device by _finish
    out = torch.empty((ops.frames, nblk, NUM_ACC), dtype=torch.float64, device=dev)
    best = (torch.empty((ops.frames * ops.per_frame // ops.ts, 10, ops.ts),
                        dtype=torch.float32, device=dev) if return_best else None)
    _launch_sweep(Tk, ops, gate, eps, out, best)
    return _finish(out, groups, ops.dtype, best, return_best)


def _launch_sweep(Tk, ops, gate, eps, out, best=None):
    """The sweep kernel's launches alone, on prepared operands: per-block
    float64 sums into out (frames, nblk, 30) and, if given, the payload
    into best. One launch covers every stream's frames; a call of more than
    _GRID_Y_MAX frames launches once per chunk, each chunk passing its first
    frame so that the kernel finds each frame's stream. Counts each
    launch."""
    global VGICP_SWEEP_LAUNCHES
    lib = _lib()
    Nf, P = ops.per_frame, ops.rows
    if ops.frames * Nf > _INT_MAX:
        # the kernel takes each chunk's first source row as an int
        raise ValueError(f"vgicp_sweep: {ops.frames} frames x {Nf} sources exceed the "
                         f"kernel's int row offsets")
    with torch.cuda.device(ops.src.device):
        stream = torch.cuda.current_stream().cuda_stream
        for b0 in range(0, ops.frames, _GRID_Y_MAX):
            nb = min(_GRID_Y_MAX, ops.frames - b0)
            rc = lib.vgicp_sweep_launch(
                _row_ptr(Tk, b0), _row_ptr(ops.src, b0 * Nf), ops.tgt.data_ptr(),
                ops.tgt_cov.data_ptr(), ops.tile_live.data_ptr(), ops.count.data_ptr(), nb,
                Nf, b0 * Nf, b0, ops.frames // ops.streams, P, ops.tm, ops.ts, gate, eps,
                _row_ptr(out, b0), best.data_ptr() if best is not None else None, stream)
            if rc != 0:
                raise RuntimeError(f"vgicp_sweep kernel launch failed: CUDA error "
                                   f"{rc} (B={nb}, N={Nf}, P={P}, S={ops.streams})")
            VGICP_SWEEP_LAUNCHES += 1


def _vgicp_frozen_cuda(Tk, ops, best, gate, eps, groups):
    """One launch finishes the step: (groups, 45) float32 rows ((45,) for
    one group), returned as views."""
    global VGICP_FROZEN_LAUNCHES
    dev = ops.src.device
    out = torch.empty((groups, NUM_FROZEN_OUT) if groups > 1 else (NUM_FROZEN_OUT,),
                      dtype=torch.float32, device=dev)
    rc = _build.launch(dev, _lib().vgicp_frozen_launch, Tk.data_ptr(), ops.src.data_ptr(),
                       best.data_ptr(), ops.frames, groups, ops.per_frame, ops.ts, gate, eps,
                       out.data_ptr())
    if rc != 0:
        raise RuntimeError(f"vgicp_frozen kernel launch failed: CUDA error {rc} "
                           f"(B={ops.frames}, groups={groups}, N={ops.per_frame}, ts={ops.ts})")
    VGICP_FROZEN_LAUNCHES += 1
    return _frozen_results(out, ops.dtype)


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
    """Plain-torch twin of the kernel, on any device, on the operands the
    kernel reads (`vgicp_prepare`): the same tiles, every row of a tile
    swept (masked rows at the penalty), ties averaged within a tile,
    strict-less across tiles, the same live-tile skip, `max_tile_elems //
    (Nf * tm)` frames at a time. Sums run in float64 and return as float32.
    Reads the live count on the host."""
    ops = vgicp_prepare(src_xyz, src_mask, src_cov6, tgt_mean, tgt_cov6, tgt_mask,
                        frames=1 if T.dim() == 2 else T.shape[0], ts=ts,
                        tgt_count=tgt_count, gate_axis=gate_axis)
    return _sweep_plain(_frames_T(T, ops, _acc_groups), ops,
                        sweep_gate(max_correspondence_dist), float(np.float32(cov_eps)),
                        return_best, _acc_groups, max_tile_elems)


def _sweep_plain(Tk, ops, gate, eps, return_best, groups, max_tile_elems=1 << 24):
    S, P, tm = ops.streams, ops.rows, ops.tm
    # live tiles per stream: tile 0 always, then every tile below the count
    profiling.count("host_syncs")
    counts = ops.count.cpu().tolist()
    live_tiles = torch.tensor([max(1, min(-(-P // tm), -(-c // tm))) for c in counts])
    tgt = ops.tgt.reshape(S, P, 4)
    payload = torch.cat([tgt[..., :3], ops.tgt_cov.reshape(S, P, 8)[..., :6]], dim=-1)
    src = ops.src.reshape(ops.frames, ops.per_frame, 10)
    fps = ops.frames // S
    frames = max(1, max_tile_elems // (ops.per_frame * tm))
    accs, bests = [], []
    for f0 in range(0, ops.frames, frames):
        sid = torch.arange(f0, min(ops.frames, f0 + frames)) // fps
        # one target set: shared by the chunk's frames, as a single sweep
        # reads it; several: each frame gathers its stream's set
        if S == 1:
            t, pay = tgt[0], payload[0]
        else:
            t, pay = tgt[sid.to(tgt.device)], payload[sid.to(tgt.device)]
        acc, best = _plain_chunk(Tk[f0:f0 + frames], src[f0:f0 + frames], t, pay,
                                 tm, live_tiles[sid].to(tgt.device), gate, eps)
        accs.append(acc)
        bests.append(best)
    best = None
    if return_best:
        best = torch.cat(bests).reshape(-1, ops.ts, 10).transpose(1, 2).contiguous()
    return _finish(torch.cat(accs), groups, ops.dtype, best, return_best)


def _plain_chunk(T, src, tgt, payload, tm, live_tiles, gate, eps):
    """(b,4,4), (b,Nf,10) sources against targets (P,4) [mean3, penalty]
    with payloads (P,9) [mean3, cov6], shared by the b frames, or per frame
    (b,P,4) / (b,P,9); a frame sweeps its first live_tiles[frame] tiles ->
    ((b,30) float64 sums, (b,Nf,10) best rows [d2, mean3, cov6])."""
    R = [[T[:, r, c, None] for c in range(3)] for r in range(3)]
    s = [src[..., k] for k in range(10)]
    # p = R s + t, summed left to right: (b, Nf) per coordinate
    p = [R[r][0] * s[0] + R[r][1] * s[1] + R[r][2] * s[2] + T[:, r, 3, None]
         for r in range(3)]
    per_frame = tgt.dim() == 3
    best_d2 = torch.full_like(p[0], _BIG)
    best_pay = torch.zeros(p[0].shape + (9,), dtype=p[0].dtype, device=p[0].device)
    for j in range(int(live_tiles.max())):
        rows = slice(j * tm, (j + 1) * tm)
        t = tgt[:, None, rows] if per_frame else tgt[rows]    # ((b, 1,) rows, 4)
        d2 = t[..., 3]
        for k in range(3):
            diff = t[..., k] - p[k][..., None]                # (b, Nf, rows)
            d2 = d2 + diff * diff
        dmin = torch.amin(d2, dim=-1)
        onehot = (d2 <= dmin[..., None]).to(d2.dtype)
        del d2
        pay = ((onehot @ payload[:, rows] if per_frame else onehot @ payload[rows])
               / torch.clamp(onehot.sum(dim=-1), min=1.0)[..., None])
        del onehot
        # strictly smaller across tiles; frames whose stream has fewer live
        # tiles skip this one
        better = (dmin < best_d2) & (j < live_tiles)[:, None]
        best_d2 = torch.where(better, dmin, best_d2)
        best_pay = torch.where(better[..., None], pay, best_pay)
    terms = _gn_accumulators(R, p, s[3], s[4:10], list(best_pay.unbind(-1)),
                             best_d2, gate, eps)
    return (terms.sum(dim=1, dtype=torch.float64),
            torch.cat([best_d2[..., None], best_pay], dim=-1))
