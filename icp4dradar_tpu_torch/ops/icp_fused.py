"""Fused ICP iteration moments: transform + nearest-neighbour correspondence
+ weighted moment accumulation in one pass (PyTorch port of
`icp4dradar_tpu/ops/icp_fused.py`).

Per frame pair the only data that leave the pass are 19 scalars,

    [sw, swp(3), swq(3), swpq(9), sw*dmin, s(mask*dmin), s(mask)]

from which `moments_to_transform` recovers the Horn best-fit update. The
correspondence q of a source point is the mean of every target at exactly
the minimum f32 distance (the TPU kernel's tie-averaging one-hot,
`icp_fused.py:74-82`).

- `icp_iteration_moments` dispatches on the device of its inputs: CPU
  tensors go to the plain version; CUDA tensors launch the hand-written
  kernel `csrc/icp_moments.cu` or raise. There is no fallback between them.
- `icp_iteration_moments_plain` is plain torch with the kernel's semantics,
  chunked over pairs and target tiles so that the (pairs, N, M) distance
  tile never exists at once (it would be 16 GB at the bench size).

All three take a batch of B pairs, T (B,4,4), src (B,N,3), src_mask (B,N),
tgt (B,M,3), tgt_mask (B,M) -> (B,19), or one pair without the batch axis
-> (19,).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from icp4dradar_tpu_torch.geom.kabsch import _rotation_from_cross_covariance
from icp4dradar_tpu_torch.geom.se3 import se3_from_rt

_BIG = 1e30
NUM_MOMENTS = 19

# Kernel launches of `icp_iteration_moments` in this process; the CUDA path
# adds one per kernel launch and nowhere else.
ICP_MOMENTS_LAUNCHES = 0

_GRID_Y_MAX = 65535  # CUDA grid.y limit: pairs per launch


def correspondence_gate(max_correspondence_dist: float) -> float:
    """The squared-distance gate of the TPU kernel (`icp_fused.py:37-38`),
    rounded to f32 as the kernel compares it: d^2, or 5e29 (off) when the
    distance is >= 1e15. The default distance 1e8 gives 1e16."""
    d = float(max_correspondence_dist)
    gate = min(d ** 2 if d < 1e15 else _BIG * 0.5, _BIG * 0.5)
    return float(np.float32(gate))


def _batched(T, src, src_mask, tgt, tgt_mask):
    unbatched = src.dim() == 2
    if unbatched:
        T, src, src_mask, tgt, tgt_mask = (
            x[None] for x in (T, src, src_mask, tgt, tgt_mask))
    B, N, M = src.shape[0], src.shape[1], tgt.shape[1]
    shapes = {"T": (T.shape, (B, 4, 4)), "src": (src.shape, (B, N, 3)),
              "src_mask": (src_mask.shape, (B, N)),
              "tgt": (tgt.shape, (B, M, 3)), "tgt_mask": (tgt_mask.shape, (B, M))}
    for name, (got, want) in shapes.items():
        if tuple(got) != want:
            raise ValueError(f"{name} has shape {tuple(got)}, expected {want}")
    if N == 0 or M == 0:
        raise ValueError(f"empty clouds: N={N}, M={M}")
    return unbatched, (T, src, src_mask, tgt, tgt_mask)


def icp_iteration_moments(
    T: torch.Tensor,
    src: torch.Tensor,
    src_mask: torch.Tensor,
    tgt: torch.Tensor,
    tgt_mask: torch.Tensor,
    max_correspondence_dist: float = 1e8,
) -> torch.Tensor:
    """One fused pass -> (B, 19) moments (or (19,) for one pair).

    CPU tensors run the plain version; CUDA tensors launch the CUDA kernel
    (float32, contiguous, all on one device) or raise."""
    tensors = (T, src, src_mask, tgt, tgt_mask)
    if all(x.device.type == "cpu" for x in tensors):
        return icp_iteration_moments_plain(*tensors, max_correspondence_dist)
    if not all(x.is_cuda and x.device == src.device for x in tensors):
        raise ValueError("icp_iteration_moments: inputs must all be on the "
                         "CPU or all on one CUDA device, got "
                         f"{[str(x.device) for x in tensors]}")
    return _icp_moments_cuda(*tensors, max_correspondence_dist)


def _lib() -> ctypes.CDLL:
    from icp4dradar_tpu_torch.ops import _build

    lib = _build.load_library()
    if lib.icp_moments_launch.argtypes is None:
        p = ctypes.c_void_p
        lib.icp_moments_launch.argtypes = [p, p, p, p, p, p, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_int,
                                           ctypes.c_float, p]
        lib.icp_moments_launch.restype = ctypes.c_int
        lib.icp_moments_threads.argtypes = []
        lib.icp_moments_threads.restype = ctypes.c_int
    return lib


def _icp_moments_cuda(T, src, src_mask, tgt, tgt_mask, max_correspondence_dist):
    global ICP_MOMENTS_LAUNCHES
    unbatched, (T, src, src_mask, tgt, tgt_mask) = _batched(
        T, src, src_mask, tgt, tgt_mask)
    for name, x in zip(("T", "src", "src_mask", "tgt", "tgt_mask"),
                       (T, src, src_mask, tgt, tgt_mask)):
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"icp_moments kernel takes contiguous float32 "
                             f"tensors; {name} is {x.dtype}, contiguous="
                             f"{x.is_contiguous()}")
    lib = _lib()
    B, N, M = src.shape[0], src.shape[1], tgt.shape[1]
    threads = lib.icp_moments_threads()
    nblk = -(-N // threads)
    gate = correspondence_gate(max_correspondence_dist)
    # per-block float64 partials: one deterministic sum over blocks below
    out = torch.empty((B, nblk, NUM_MOMENTS), dtype=torch.float64,
                      device=src.device)
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        for b0 in range(0, B, _GRID_Y_MAX):
            nb = min(_GRID_Y_MAX, B - b0)
            rc = lib.icp_moments_launch(
                T[b0].data_ptr(), src[b0].data_ptr(), src_mask[b0].data_ptr(),
                tgt[b0].data_ptr(), tgt_mask[b0].data_ptr(),
                out[b0].data_ptr(), nb, N, M, gate, stream)
            if rc != 0:
                raise RuntimeError(f"icp_moments kernel launch failed: CUDA "
                                   f"error {rc} (B={nb}, N={N}, M={M})")
            ICP_MOMENTS_LAUNCHES += 1
    moments = torch.sum(out, dim=1).to(torch.float32)
    return moments[0] if unbatched else moments


def icp_iteration_moments_plain(
    T: torch.Tensor,
    src: torch.Tensor,
    src_mask: torch.Tensor,
    tgt: torch.Tensor,
    tgt_mask: torch.Tensor,
    max_correspondence_dist: float = 1e8,
    tile_m: int = 1024,
    max_tile_elems: int = 1 << 24,
) -> torch.Tensor:
    """Plain-torch twin of the kernel, on any device.

    Pairs are processed `max_tile_elems // (N * tile_m)` at a time, and
    targets `tile_m` at a time with a running (min, sum q, count) merged
    across tiles exactly as the kernel's per-thread state: a strictly
    smaller tile minimum replaces it, an equal one adds to it. p and d2 are
    formed in the kernel's (and the TPU kernel's) order of operations, each
    separately rounded, so exact ties agree. Moments are summed in float64
    and returned as float32."""
    unbatched, (T, src, src_mask, tgt, tgt_mask) = _batched(
        T, src, src_mask, tgt, tgt_mask)
    B, N, M = src.shape[0], src.shape[1], tgt.shape[1]
    gate = correspondence_gate(max_correspondence_dist)
    tile_m = max(1, min(tile_m, M))
    pairs = max(1, max_tile_elems // (N * tile_m))
    out = [
        _plain_chunk(T[s:s + pairs], src[s:s + pairs], src_mask[s:s + pairs],
                     tgt[s:s + pairs], tgt_mask[s:s + pairs], gate, tile_m)
        for s in range(0, B, pairs)
    ]
    moments = torch.cat(out)
    return moments[0] if unbatched else moments


def _plain_chunk(T, src, src_mask, tgt, tgt_mask, gate, tile_m):
    f32 = torch.float32
    T, src, tgt = T.to(f32), src.to(f32), tgt.to(f32)
    sw = src_mask.to(f32)
    # p = R s + t, summed left to right: (b, N) per coordinate
    p = [T[:, r, 0, None] * src[..., 0] + T[:, r, 1, None] * src[..., 1]
         + T[:, r, 2, None] * src[..., 2] + T[:, r, 3, None] for r in range(3)]
    pen = torch.where(tgt_mask > 0.5, 0.0, _BIG).to(f32)
    M = tgt.shape[1]
    dmin = qsum = cnt = None
    for m0 in range(0, M, tile_m):
        t = tgt[:, m0:m0 + tile_m]                            # (b, tm, 3)
        d2 = pen[:, None, m0:m0 + tile_m]                     # (b, 1, tm)
        for k in range(3):
            diff = t[:, None, :, k] - p[k][..., None]         # (b, N, tm)
            d2 = d2 + diff * diff
        tmin = torch.amin(d2, dim=-1)                         # (b, N)
        onehot = (d2 <= tmin[..., None]).to(f32)
        del d2
        tq = onehot @ t                                       # (b, N, 3)
        tcnt = torch.sum(onehot, dim=-1)
        del onehot
        if dmin is None:
            dmin, qsum, cnt = tmin, tq, tcnt
            continue
        lt, eq = tmin < dmin, tmin == dmin
        qsum = torch.where(lt[..., None], tq,
                           torch.where(eq[..., None], qsum + tq, qsum))
        cnt = torch.where(lt, tcnt, torch.where(eq, cnt + tcnt, cnt))
        dmin = torch.minimum(dmin, tmin)
    q = qsum / torch.clamp(cnt, min=1.0)[..., None]
    w = sw * (dmin < gate)
    wp = [w * p[a] for a in range(3)]
    terms = [w, *wp, *(w * q[..., a] for a in range(3))]
    terms += [wp[a] * q[..., c] for a in range(3) for c in range(3)]
    terms += [w * dmin, sw * dmin, sw]
    return torch.stack(terms, dim=-1).sum(dim=1, dtype=torch.float64).to(f32)


def moments_to_transform(moments: torch.Tensor):
    """(..., 19) moments -> (dT (..., 4, 4) Horn best fit of p onto q,
    mean gated d2 (...)).

    dT is the incremental correction: apply as T <- dT @ T. With no valid
    correspondences (weight sum < 1) dT is the identity and the mean d2 is
    0: the power iteration on a zero matrix would return an arbitrary
    rotation from its start vector."""
    sw = torch.clamp(moments[..., 0], min=1e-9)
    mu_p = moments[..., 1:4] / sw[..., None]
    mu_q = moments[..., 4:7] / sw[..., None]
    pq = moments[..., 7:16].reshape(moments.shape[:-1] + (3, 3))
    H = pq - sw[..., None, None] * (mu_p[..., :, None] * mu_q[..., None, :])
    R = _rotation_from_cross_covariance(H)
    t = mu_q - (R @ mu_p[..., None])[..., 0]
    mean_d2 = moments[..., 16] / sw
    degenerate = moments[..., 0] < 1.0
    eye = torch.eye(4, dtype=moments.dtype, device=moments.device)
    dT = torch.where(degenerate[..., None, None], eye, se3_from_rt(R, t))
    return dT, torch.where(degenerate, 0.0, mean_d2)
