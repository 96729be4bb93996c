"""Nearest-neighbour correspondence search (PyTorch port of
`icp4dradar_tpu/ops/knn.py`): the kNN-GICP inner loop's 1-NN and the
k-NN behind its covariances.

- `nn_prepare(tgt, tgt_mask)` packs a registration's targets once
  (`NnOperands`; on the card one launch of the packing kernel, elsewhere
  its plain version `nn_pack_plain`): the rows as float4 (x, y, z, 0) with
  the live rows first in their original order, each packed row's original
  index, the live count on the device, and the rows and mask as given.
  `nn_search(src, ops)` -> (index (N,) int32, d2 (N,)) of the nearest
  valid target per source; `gicp_align` prepares once and searches in
  every GN iteration. CPU operands run the plain version on the same
  packed layout; CUDA operands launch the hand-written kernel
  `csrc/nn_search.cu` (one launch a search, no host sync) or raise.
- `nn_search_coords(src, ops)` -> (d2 (N,), matched coordinates (N, 3)):
  the same search, one launch of the same kernel writing tgt[index] in
  place of the index; its plain twin `nn_search_coords_plain` gathers from
  `nn_search_plain`.
- A stream axis (serving: S registrations at once, as the JAX package
  vmaps the search): `nn_prepare` takes targets (S, M, 3) with masks (S,
  M) and packs every stream in one launch; `nn_search` takes sources (S,
  N, 3) and searches all streams in one launch, each against its own
  targets, with no host sync. Stream s's result equals the single-target
  call on stream s, bit for bit.
- `nearest_neighbor(src, tgt, tgt_mask)` and `nearest_neighbor_with_coords`
  prepare for one call and search: one packing launch and one search
  launch on the card.
- `nearest_neighbor_plain` / `nearest_neighbor_with_coords_plain`: plain
  torch over all rows with the kernels' semantics, on any device.
- `knn`: the chunked k-NN, plain torch on every device (the JAX package
  leaves it to XLA everywhere).

Semantics of the 1-NN (the Pallas kernels `_nn_kernel`, `knn.py:75`, and
`_nn_coords_kernel`, `:180`): d2 = fma(dz, dz, fma(dy, dy, fma(dx, dx,
pen))) with d = t - s and pen = 1e30 on masked targets, each fused
multiply-add rounded once, as XLA evaluates the Pallas body on the CPU;
the smallest index among the exact minima wins; the reported d2 is
max(d2, 0). With every target masked all d2 are 1e30 and the index is 0.

The prepared search keeps these semantics exactly. A masked row's d2 is
>= 1e30, so it can win only where no live row gives d2 < 1e30: the search
sweeps the live rows alone (pen = 0), and a source whose best there is not
< 1e30 (no live row, or live rows at NaN, inf or beyond ~1e15 m) re-scans
all rows in their original order with the penalty, as the all-rows search
does. A live row beyond 1e15 m with the rest masked therefore loses to
masked row 0, as in the Pallas kernel.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from icp4dradar_tpu_torch.geom.linalg import fma_f32 as _fma
from icp4dradar_tpu_torch.ops import _build

_BIG = 1e30

# Kernel launches of `nn_search` (and `nearest_neighbor`, built on it) and
# of `nn_search_coords` (and `nearest_neighbor_with_coords`) on CUDA tensors
# in this process; each wrapper adds one per launch of its kernel and
# nowhere else, one whatever the number of streams.
NN_SEARCH_LAUNCHES = 0
NN_COORDS_LAUNCHES = 0
# Kernel launches of the packing (`nn_prepare` on CUDA tensors).
NN_PACK_LAUNCHES = 0

# The search kernel's cluster takes one block per 2048 rows of capacity, a
# power of two up to the kernel's limit of 8.
_ROWS_PER_RANK = 2048
_MAX_CLUSTER = 8


def _check_kernel_tensors(name, named):
    for arg, x in named:
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{name}: the CUDA kernels take contiguous float32 tensors; "
                             f"{arg} is {x.dtype}, contiguous={x.is_contiguous()}")


@dataclass(frozen=True)
class NnOperands:
    """A registration's 1-NN targets, packed once (`nn_prepare`) and read in
    place by every search (`nn_search`).

    - `rows` (M, 4) float32: [x, y, z, 0] of the live rows first, in their
      original order, then the masked rows; `orig` (M,) int32: each packed
      row's original index; `count` (1,) int32: the live rows, on the
      operands' device.
    - `tgt` (M, 3) float32 and `mask` (M,) float32: the rows and mask as
      given, which the fallback re-scan reads.
    - `cluster`: thread blocks that share a search's rows on the card,
      chosen from M.

    With a stream axis every array leads with S: rows (S, M, 4), orig (S,
    M), count (S,), tgt (S, M, 3), mask (S, M)."""

    rows: torch.Tensor
    orig: torch.Tensor
    count: torch.Tensor
    tgt: torch.Tensor
    mask: torch.Tensor
    cluster: int

    @property
    def streams(self) -> Optional[int]:
        """S with a stream axis, None for one target set."""
        return self.rows.shape[0] if self.rows.dim() == 3 else None

    def stream(self, s: int) -> "NnOperands":
        """Stream s's operands (views), as `nn_prepare` packs one target set."""
        return NnOperands(rows=self.rows[s], orig=self.orig[s], count=self.count[s:s + 1],
                          tgt=self.tgt[s], mask=self.mask[s], cluster=self.cluster)


def nn_prepare(tgt: torch.Tensor, tgt_mask: Optional[torch.Tensor] = None) -> NnOperands:
    """Pack targets (M, 3) with their mask (M,) once for every search of a
    registration: a stable partition of the live rows to the front, on the
    device; nothing is read on the host. CUDA tensors (contiguous float32)
    launch the packing kernel of `csrc/nn_search.cu`, one launch; CPU
    tensors run its plain version (`nn_pack_plain`), which gives the same
    layout. Targets (S, M, 3) with masks (S, M) pack S streams, each as
    alone, in the one launch."""
    if tgt_mask is None:
        tgt_mask = torch.ones(tgt.shape[:-1], dtype=torch.float32, device=tgt.device)
    if (tgt.dim() not in (2, 3) or tgt.shape[-1] != 3
            or tuple(tgt_mask.shape) != tuple(tgt.shape[:-1])):
        raise ValueError(f"nn_prepare: tgt {tuple(tgt.shape)}, tgt_mask "
                         f"{tuple(tgt_mask.shape)}; expected ([S,] M, 3), ([S,] M)")
    M = tgt.shape[-2]
    if tgt.numel() == 0:
        raise ValueError(f"nn_prepare: empty target cloud {tuple(tgt.shape)}")
    if tgt.device != tgt_mask.device:
        raise ValueError(f"nn_prepare: tgt on {tgt.device}, tgt_mask on {tgt_mask.device}")
    if tgt.is_cuda:
        _check_kernel_tensors("nn_prepare", (("tgt", tgt), ("tgt_mask", tgt_mask)))
    elif tgt.device.type != "cpu":
        raise ValueError(f"nn_prepare: tensors on {tgt.device}; expected the CPU or CUDA")
    f32 = torch.float32
    tgt, mask = tgt.to(f32).contiguous(), tgt_mask.to(f32).contiguous()
    rows, orig, count = (_nn_pack_cuda if tgt.is_cuda else nn_pack_plain)(tgt, mask)
    cluster = 1
    while cluster < _MAX_CLUSTER and cluster * _ROWS_PER_RANK < M:
        cluster *= 2
    return NnOperands(rows=rows, orig=orig, count=count, tgt=tgt, mask=mask, cluster=cluster)


def nn_pack_plain(tgt: torch.Tensor, mask: torch.Tensor):
    """Plain-torch twin of the packing kernel, on any device: targets ([S,]
    M, 3) float32 and mask ([S,] M) -> (rows ([S,] M, 4) [x, y, z, 0] with
    the live rows first, orig ([S,] M) int32, count (S,) int32, or (1,)
    without a stream axis), by a stable sort of each stream's rows."""
    live = mask > 0.5
    order = torch.argsort((~live).to(torch.int32), dim=-1, stable=True)
    rows = torch.cat([tgt, tgt.new_zeros(tgt.shape[:-1] + (1,))], dim=-1)
    rows = torch.gather(rows, -2, order[..., None].expand(rows.shape)).contiguous()
    return rows, order.to(torch.int32), live.sum(dim=-1, dtype=torch.int32).reshape(-1)


def nn_search(src: torch.Tensor, ops: NnOperands) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest valid target per source over prepared targets: src (N, 3) ->
    (indices (N,) int32 into the targets as given, squared distances (N,));
    with a stream axis src (S, N, 3) -> (S, N) each, stream s against its
    own targets. CPU operands run the plain version; CUDA operands (src
    contiguous float32 on their device) launch the kernel once or raise."""
    if not _check_src("nn_search", src, ops):
        return nn_search_plain(src, ops)
    global NN_SEARCH_LAUNCHES
    idx = torch.empty(src.shape[:-1], dtype=torch.int32, device=src.device)
    d2 = _nn_search_cuda(src, ops, idx.data_ptr(), None)
    NN_SEARCH_LAUNCHES += 1
    return idx, d2


def nn_search_coords(src: torch.Tensor, ops: NnOperands) -> Tuple[torch.Tensor, torch.Tensor]:
    """The search of `nn_search` emitting the matched coordinates: src ([S,]
    N, 3) -> (squared distances ([S,] N), tgt[index] ([S,] N, 3)), the rows
    exactly as given. CPU operands run the plain version; CUDA operands
    launch the same kernel once, writing the coordinates in place of the
    index, or raise."""
    if not _check_src("nn_search_coords", src, ops):
        return nn_search_coords_plain(src, ops)
    global NN_COORDS_LAUNCHES
    q = torch.empty(src.shape, dtype=torch.float32, device=src.device)
    d2 = _nn_search_cuda(src, ops, None, q.data_ptr())
    NN_COORDS_LAUNCHES += 1
    return d2, q


def _check_src(name, src, ops) -> bool:
    """Checks a search's sources against its operands; True where the
    kernel runs (CUDA), False for the plain version (CPU)."""
    lead = () if ops.streams is None else (ops.streams,)
    if (src.dim() != len(lead) + 2 or tuple(src.shape[:-2]) != lead or src.shape[-1] != 3
            or src.shape[-2] == 0):
        raise ValueError(f"{name}: src has shape {tuple(src.shape)}, expected "
                         f"{lead + ('N', 3)}, N > 0")
    if src.device != ops.rows.device:
        raise ValueError(f"{name}: src on {src.device}, the operands on {ops.rows.device}")
    if src.is_cuda:
        _check_kernel_tensors(name, (("src", src),))
    return src.is_cuda


def nn_search_plain(src: torch.Tensor, ops: NnOperands) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain-torch twin of the search kernel on the same packed layout, on
    any device: the first minimum over the live rows, mapped back to the
    original index; where that is not < 1e30, the all-rows search over the
    rows and mask as given. Reads the live count on the host; with a stream
    axis, stream by stream."""
    if ops.streams is not None:
        found = [nn_search_plain(src[s], ops.stream(s)) for s in range(ops.streams)]
        return torch.stack([f[0] for f in found]), torch.stack([f[1] for f in found])
    src = src.to(torch.float32)
    live = int(ops.count.item())
    idx = torch.zeros(src.shape[0], dtype=torch.int32, device=src.device)
    d2 = torch.full((src.shape[0],), float("inf"), dtype=torch.float32, device=src.device)
    if live:
        rows = ops.rows[:live]
        i, d2 = _first_min(src, rows[:, :3], rows[:, 3])
        idx = ops.orig[i.long()]
    fb = ~(d2 < _BIG)
    if bool(fb.any()):
        pen = torch.where(ops.mask > 0.5, 0.0, _BIG).to(torch.float32)
        idx[fb], d2[fb] = _first_min(src[fb], ops.tgt, pen)
    return idx, torch.clamp(d2, min=0.0)


def nearest_neighbor(
    src: torch.Tensor,
    tgt: torch.Tensor,
    tgt_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest valid target per source: src (N, 3), tgt (M, 3), tgt_mask
    (M,) -> (indices (N,) int32, squared distances (N,)): `nn_search` on
    targets prepared for this call. CPU tensors run the plain version; CUDA
    tensors (float32, contiguous) launch the kernel or raise."""
    return nn_search(src, nn_prepare(tgt, tgt_mask))


def nearest_neighbor_with_coords(
    src: torch.Tensor,
    tgt: torch.Tensor,
    tgt_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(squared distances (N,), matched target coordinates (N, 3)): the 1-NN
    of `nearest_neighbor`, emitting tgt[index] instead of the index;
    `nn_search_coords` on targets prepared for this call."""
    return nn_search_coords(src, nn_prepare(tgt, tgt_mask))


def nearest_neighbor_plain(
    src: torch.Tensor,
    tgt: torch.Tensor,
    tgt_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain-torch all-rows 1-NN with the kernels' semantics, on any device:
    the first minimum of each source's distances to every row, masked rows
    at the penalty."""
    f32 = torch.float32
    if tgt_mask is None:
        tgt_mask = torch.ones(tgt.shape[0], dtype=f32, device=tgt.device)
    pen = torch.where(tgt_mask > 0.5, 0.0, _BIG).to(f32)
    idx, d2 = _first_min(src.to(f32), tgt.to(f32), pen)
    return idx, torch.clamp(d2, min=0.0)


def _first_min(src, tgt, pen, max_tile_elems: int = 1 << 22):
    """(index int32, d2) of the first minimum of d2 = fma(dz, dz, fma(dy,
    dy, fma(dx, dx, pen))) over the rows of tgt (M, 3) per source, the
    (sources, M) distances `max_tile_elems // M` sources at a time."""
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
    return torch.cat(idx), torch.cat(d2)


def nn_search_coords_plain(src: torch.Tensor,
                           ops: NnOperands) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain-torch twin of `nn_search_coords`, on any device: (d2,
    tgt[index]) from `nn_search_plain`."""
    idx, d2 = nn_search_plain(src, ops)
    return d2, torch.gather(ops.tgt, -2, idx.long()[..., None].expand(idx.shape + (3,)))


def nearest_neighbor_with_coords_plain(
    src: torch.Tensor,
    tgt: torch.Tensor,
    tgt_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain-torch all-rows twin of `nearest_neighbor_with_coords`: (d2 (N,),
    tgt[index])."""
    idx, d2 = nearest_neighbor_plain(src, tgt, tgt_mask)
    return d2, tgt.to(torch.float32)[idx.long()]


def _lib() -> ctypes.CDLL:
    lib = _build.load_library()
    if lib.nn_search_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.nn_search_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, p, p, p, p]
        lib.nn_search_launch.restype = i
        lib.nn_pack_launch.argtypes = [p, p, i, i, p, p, p, p]
        lib.nn_pack_launch.restype = i
    return lib


def _nn_pack_cuda(tgt, mask):
    global NN_PACK_LAUNCHES
    M, dev = tgt.shape[-2], tgt.device
    S = tgt.shape[0] if tgt.dim() == 3 else 1
    rows = torch.empty(tgt.shape[:-1] + (4,), dtype=torch.float32, device=dev)
    orig = torch.empty(tgt.shape[:-1], dtype=torch.int32, device=dev)
    count = torch.empty(S, dtype=torch.int32, device=dev)
    rc = _build.launch(dev, _lib().nn_pack_launch, tgt.data_ptr(), mask.data_ptr(), S, M,
                       rows.data_ptr(), orig.data_ptr(), count.data_ptr())
    if rc != 0:
        raise RuntimeError(f"nn_pack kernel launch failed: CUDA error {rc} (S={S}, M={M})")
    NN_PACK_LAUNCHES += 1
    return rows, orig, count


def _nn_search_cuda(src, ops, idx_ptr, q_ptr):
    """One launch of the search kernel over every stream -> d2 ([S,] N); it
    also writes the indices ([S,] N) int32 at idx_ptr and the coordinates
    ([S,] N, 3) float32 at q_ptr, each where the pointer is not None."""
    S = 1 if ops.streams is None else ops.streams
    N, M = src.shape[-2], ops.rows.shape[-2]
    d2 = torch.empty(src.shape[:-1], dtype=torch.float32, device=src.device)
    rc = _build.launch(src.device, _lib().nn_search_launch, src.data_ptr(),
                       ops.rows.data_ptr(), ops.orig.data_ptr(), ops.count.data_ptr(),
                       ops.tgt.data_ptr(), ops.mask.data_ptr(), S, N, M, ops.cluster,
                       d2.data_ptr(), idx_ptr, q_ptr)
    if rc != 0:
        raise RuntimeError(f"nn_search kernel launch failed: CUDA error {rc} "
                           f"(S={S}, N={N}, M={M}, cluster={ops.cluster})")
    return d2


def knn(
    src: torch.Tensor,
    tgt: torch.Tensor,
    k: int,
    tgt_mask: Optional[torch.Tensor] = None,
    chunk: int = 256,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest valid targets per source -> (indices (N, k) int32, squared
    distances (N, k)), nearest first. d2 = |s|^2 - 2 s.t + |t|^2 +
    penalty (1e30 on masked targets) in chunks of `chunk` sources, the JAX
    package's expanded form, each dot product summed over x, y, z in order
    elementwise on every device (a library product need not round alike at
    every batch size). The result is `lax.top_k`'s on every device: the
    first k of a stable sort of each row, i.e. among equal distances the
    lower index first (`k_smallest`). Callers mask with d2 < threshold
    when fewer than k valid targets exist. With leading stream axes (src
    (S, N, 3), tgt (S, M, 3), tgt_mask (S, M)) each stream searches its
    own targets, in the same launches."""
    M = tgt.shape[-2]
    if not 0 < k <= M:
        raise ValueError(f"knn: k={k} with {M} targets")
    if tgt_mask is None:
        tgt_mask = torch.ones(tgt.shape[:-1], dtype=src.dtype, device=src.device)
    penalty = torch.where(tgt_mask > 0.5, 0.0, _BIG).to(src.dtype)
    t2 = _sq3(tgt, tgt)
    idx, d2 = [], []
    for s0 in range(0, src.shape[-2], chunk):
        s = src[..., s0:s0 + chunk, :]
        st = _sq3(s[..., :, None, :], tgt[..., None, :, :])
        d = _sq3(s, s)[..., None] - 2.0 * st + t2[..., None, :] + penalty[..., None, :]
        i, dk = k_smallest(d, k)
        idx.append(i.to(torch.int32))
        d2.append(dk)
    return torch.cat(idx, dim=-2), torch.clamp(torch.cat(d2, dim=-2), min=0.0)


def _sq3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot products of (..., 3) rows, summed over x, y, z in order."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def k_smallest(d: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(indices, values) of the first k columns of a stable ascending sort
    of each row of d: `lax.top_k` on -d, the lower index first among equal
    values. `torch.topk` promises no order among equal values; a selection
    built on it (the k-th value, a cumsum over its ties, a top-k over
    unique keys) measured slower on the card than this sort."""
    d, i = torch.sort(d, dim=-1, stable=True)
    return i[..., :k], d[..., :k]
