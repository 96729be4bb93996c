"""Nearest-neighbour correspondence search (PyTorch port of
`icp4dradar_tpu/ops/knn.py`): the kNN-GICP inner loop's 1-NN and the
k-NN behind its covariances.

- `nearest_neighbor` -> (index (N,) int32, d2 (N,)) of the nearest valid
  target per source; `nearest_neighbor_with_coords` -> (d2 (N,), matched
  coordinates (N, 3)). Both dispatch on the device of their inputs: CPU
  tensors go to the plain version, CUDA tensors launch the hand-written
  kernel `csrc/nn_search.cu` or raise.
- `nearest_neighbor_plain` / `nearest_neighbor_with_coords_plain`: plain
  torch with the kernel's semantics, on any device.
- `knn`: the chunked k-NN, plain torch on every device (the JAX package
  leaves it to XLA everywhere).

Semantics of the 1-NN (the Pallas kernels `_nn_kernel`, `knn.py:75`, and
`_nn_coords_kernel`, `:180`): d2 = fma(dz, dz, fma(dy, dy, fma(dx, dx,
pen))) with d = t - s and pen = 1e30 on masked targets, each fused
multiply-add rounded once, as XLA evaluates the Pallas body on the CPU;
the smallest index among the exact minima wins; the reported d2 is
max(d2, 0). With every target masked all d2 are 1e30 and the index is 0.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

_BIG = 1e30

# Kernel launches of `nearest_neighbor` / `nearest_neighbor_with_coords`
# on CUDA tensors in this process; each wrapper adds one per launch of its
# kernel and nowhere else.
NN_SEARCH_LAUNCHES = 0
NN_COORDS_LAUNCHES = 0

# The CUDA kernel splits the target rows over a second grid axis so that a
# 2048-source search (16 source blocks) still fills the card's 132 SMs.
_TARGET_BLOCKS = 4 * 132
_MIN_SPLIT_ROWS = 256


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 fused multiply-add a * b + c, rounded once, on any device.
    a * b is exact in float64; the float64 sum is made round-to-odd from its
    TwoSum error, so the final rounding to float32 is the correct one."""
    a, b, c = a.double(), b.double(), c.double()
    p = a * b
    s = p + c
    bp = s - p
    err = (p - (s - bp)) + (c - bp)
    even = (s.view(torch.int64) & 1) == 0
    s = torch.where((err != 0) & even,
                    torch.nextafter(s, torch.where(err > 0, torch.inf, -torch.inf)
                                    .to(s.dtype)), s)
    return s.float()


def _check_args(name, src, tgt, tgt_mask):
    if tgt_mask is None:
        tgt_mask = torch.ones(tgt.shape[0], dtype=torch.float32, device=tgt.device)
    if src.dim() != 2 or src.shape[-1] != 3 or tgt.dim() != 2 or tgt.shape[-1] != 3 \
            or tuple(tgt_mask.shape) != (tgt.shape[0],):
        raise ValueError(f"{name}: src {tuple(src.shape)}, tgt {tuple(tgt.shape)}, "
                         f"tgt_mask {tuple(tgt_mask.shape)}; expected (N, 3), (M, 3), (M,)")
    if src.shape[0] == 0 or tgt.shape[0] == 0:
        raise ValueError(f"{name}: empty clouds, N={src.shape[0]}, M={tgt.shape[0]}")
    tensors = (src, tgt, tgt_mask)
    if all(x.device.type == "cpu" for x in tensors):
        return tgt_mask, False
    if not all(x.is_cuda and x.device == src.device for x in tensors):
        raise ValueError(f"{name}: inputs must all be on the CPU or all on one CUDA "
                         f"device, got {[str(x.device) for x in tensors]}")
    return tgt_mask, True


def nearest_neighbor(
    src: torch.Tensor,
    tgt: torch.Tensor,
    tgt_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest valid target per source: src (N, 3), tgt (M, 3), tgt_mask
    (M,) -> (indices (N,) int32, squared distances (N,)). CPU tensors run
    the plain version; CUDA tensors (float32, contiguous) launch the kernel
    or raise."""
    tgt_mask, on_cuda = _check_args("nearest_neighbor", src, tgt, tgt_mask)
    if not on_cuda:
        return nearest_neighbor_plain(src, tgt, tgt_mask)
    idx, d2, _ = _nn_cuda(src, tgt, tgt_mask, coords=False)
    return idx, d2


def nearest_neighbor_with_coords(
    src: torch.Tensor,
    tgt: torch.Tensor,
    tgt_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(squared distances (N,), matched target coordinates (N, 3)): the 1-NN
    of `nearest_neighbor`, emitting tgt[index] instead of the index."""
    tgt_mask, on_cuda = _check_args("nearest_neighbor_with_coords", src, tgt, tgt_mask)
    if not on_cuda:
        return nearest_neighbor_with_coords_plain(src, tgt, tgt_mask)
    _, d2, q = _nn_cuda(src, tgt, tgt_mask, coords=True)
    return d2, q


def nearest_neighbor_plain(
    src: torch.Tensor,
    tgt: torch.Tensor,
    tgt_mask: Optional[torch.Tensor] = None,
    max_tile_elems: int = 1 << 22,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain-torch twin of the kernel, on any device: the (sources, M)
    distances `max_tile_elems // M` sources at a time, the first argmin of
    each row (the smallest index among the exact minima)."""
    f32 = torch.float32
    if tgt_mask is None:
        tgt_mask = torch.ones(tgt.shape[0], dtype=f32, device=tgt.device)
    src, tgt = src.to(f32), tgt.to(f32)
    pen = torch.where(tgt_mask > 0.5, 0.0, _BIG).to(f32)
    M = tgt.shape[0]
    rows = max(1, max_tile_elems // M)
    idx, d2 = [], []
    for s0 in range(0, src.shape[0], rows):
        s = src[s0:s0 + rows]
        d = pen[None, :].expand(s.shape[0], M)
        for k in range(3):
            diff = tgt[None, :, k] - s[:, k, None]
            d = _fma(diff, diff, d)
        i = torch.argmin(d, dim=1)
        idx.append(i.to(torch.int32))
        d2.append(torch.gather(d, 1, i[:, None])[:, 0])
    return torch.cat(idx), torch.clamp(torch.cat(d2), min=0.0)


def nearest_neighbor_with_coords_plain(
    src: torch.Tensor,
    tgt: torch.Tensor,
    tgt_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain-torch twin of the coordinate kernel: (d2 (N,), tgt[index])."""
    idx, d2 = nearest_neighbor_plain(src, tgt, tgt_mask)
    return d2, tgt.to(torch.float32)[idx.long()]


def _lib() -> ctypes.CDLL:
    from icp4dradar_tpu_torch.ops import _build

    lib = _build.load_library()
    if lib.nn_search_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.nn_search_launch, lib.nn_coords_launch):
            fn.argtypes = [p, p, p, i, i, i, i, p, p, p, p, p]
            fn.restype = i
        lib.nn_search_threads.argtypes = []
        lib.nn_search_threads.restype = i
    return lib


def _nn_cuda(src, tgt, tgt_mask, coords: bool):
    global NN_SEARCH_LAUNCHES, NN_COORDS_LAUNCHES
    for name, x in (("src", src), ("tgt", tgt), ("tgt_mask", tgt_mask)):
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"nn_search kernel takes contiguous float32 tensors; "
                             f"{name} is {x.dtype}, contiguous={x.is_contiguous()}")
    lib = _lib()
    N, M = src.shape[0], tgt.shape[0]
    nblk = -(-N // lib.nn_search_threads())
    splits = max(1, min(-(-M // _MIN_SPLIT_ROWS), -(-_TARGET_BLOCKS // nblk)))
    rows = -(-M // splits)
    splits = -(-M // rows)
    dev = src.device
    part_d = torch.empty((splits, N), dtype=torch.float32, device=dev)
    part_i = torch.empty((splits, N), dtype=torch.int32, device=dev)
    d2 = torch.empty(N, dtype=torch.float32, device=dev)
    idx = None if coords else torch.empty(N, dtype=torch.int32, device=dev)
    q = torch.empty((N, 3), dtype=torch.float32, device=dev) if coords else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        fn = lib.nn_coords_launch if coords else lib.nn_search_launch
        rc = fn(src.data_ptr(), tgt.data_ptr(), tgt_mask.data_ptr(), N, M, rows, splits,
                part_d.data_ptr(), part_i.data_ptr(), d2.data_ptr(),
                (q if coords else idx).data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"nn_search kernel launch failed: CUDA error {rc} "
                           f"(N={N}, M={M}, splits={splits})")
    if coords:
        NN_COORDS_LAUNCHES += 1
    else:
        NN_SEARCH_LAUNCHES += 1
    return idx, d2, q


def knn(
    src: torch.Tensor,
    tgt: torch.Tensor,
    k: int,
    tgt_mask: Optional[torch.Tensor] = None,
    chunk: int = 256,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest valid targets per source -> (indices (N, k) int32, squared
    distances (N, k)), nearest first. d2 = |s|^2 - 2 s.t + |t|^2 +
    penalty (1e30 on masked targets) in chunks of `chunk` sources, as the
    JAX package forms it. The result is `lax.top_k`'s on every device: the
    first k of a stable sort of each row, i.e. among equal distances the
    lower index first (`k_smallest`). Callers mask with d2 < threshold
    when fewer than k valid targets exist."""
    M = tgt.shape[0]
    if not 0 < k <= M:
        raise ValueError(f"knn: k={k} with {M} targets")
    if tgt_mask is None:
        tgt_mask = torch.ones(M, dtype=src.dtype, device=src.device)
    t2 = torch.sum(tgt * tgt, dim=-1)
    penalty = torch.where(tgt_mask > 0.5, 0.0, _BIG).to(src.dtype)
    idx, d2 = [], []
    for s0 in range(0, src.shape[0], chunk):
        s = src[s0:s0 + chunk]
        d = (torch.sum(s * s, dim=-1, keepdim=True) - (2.0 * s) @ tgt.T
             + t2[None, :] + penalty[None, :])
        i, dk = k_smallest(d, k)
        idx.append(i.to(torch.int32))
        d2.append(dk)
    return torch.cat(idx), torch.clamp(torch.cat(d2), min=0.0)


def k_smallest(d: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(indices, values) of the first k columns of a stable ascending sort
    of each row of d: `lax.top_k` on -d, the lower index first among equal
    values. `torch.topk` promises no order among equal values; a selection
    built on it (the k-th value, a cumsum over its ties, a top-k over
    unique keys) measured slower on the card than this sort."""
    d, i = torch.sort(d, dim=-1, stable=True)
    return i[..., :k], d[..., :k]
