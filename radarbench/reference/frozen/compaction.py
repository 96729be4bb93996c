"""Frozen copy of `icp4dradar_tpu_torch/ops/compaction.py` at commit
03a0450, part of the benchmark's reference: its plain PyTorch paths only
(the CUDA dispatch removed; what no reference path calls left out).

Masked compaction: gather valid entries to the front of a fixed-size
buffer (PyTorch port of `icp4dradar_tpu/ops/compaction.py`), the
static-shape replacement for the reference's dynamic `push_back`
accumulation (sector query output, third_party/ikd-Tree/ikd_Tree.cpp:
1024-1140)."""

from __future__ import annotations

from typing import Tuple

import torch


def mask_compact(
    values: torch.Tensor,
    mask: torch.Tensor,
    out_size: int,
    fill: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Scatter `values[mask]` into the first slots of an (out_size, ...)
    buffer, in their original order. values: (N, ...); mask: (N,) in {0,1}.
    With a leading stream axis, values (S, N, ...) and mask (S, N), each
    stream compacts into its own (S, out_size, ...) buffer. Entries beyond
    out_size are dropped (check `count`).

    Returns (out (out_size, ...), out_mask (out_size,) of values' dtype,
    count () int32 clipped to out_size), each with the leading (S,) axis
    when given one. One cumsum and one scatter for all streams, no host
    sync: rows that are masked out or overflow all land in one extra bin
    per stream that is sliced off."""
    maskb = mask > 0.5
    count = torch.sum(maskb.to(torch.int32), dim=-1)
    # one flat cumsum for all streams (a scan along a few long rows is far
    # slower on the card), less each stream's start
    pos = torch.cumsum(maskb.reshape(-1).to(torch.int32), dim=0).reshape(maskb.shape) - 1
    if maskb.dim() == 2:
        pos = pos - (torch.cumsum(count, dim=0) - count)[:, None]
    dest = torch.where(maskb & (pos < out_size), pos, out_size).to(torch.int64)
    lead = tuple(mask.shape[:-1])                 # () or (S,)
    if lead:
        S = lead[0]
        dest = (dest + torch.arange(S, device=dest.device)[:, None] * (out_size + 1)).reshape(-1)
        values = values.reshape((-1,) + tuple(values.shape[2:]))
    rows = (out_size + 1) * (lead[0] if lead else 1)
    out = torch.full((rows,) + tuple(values.shape[1:]), fill,
                     dtype=values.dtype, device=values.device)
    out.index_copy_(0, dest, values)
    out_mask = torch.zeros(rows, dtype=values.dtype, device=values.device)
    out_mask.index_fill_(0, dest, 1)
    ax = len(lead)
    out = out.reshape(lead + (out_size + 1,) + tuple(values.shape[1:])).narrow(ax, 0, out_size)
    out_mask = out_mask.reshape(lead + (out_size + 1,)).narrow(ax, 0, out_size)
    return out, out_mask, torch.clamp(count, max=out_size).to(torch.int32)
