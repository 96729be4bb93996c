"""Masked compaction: gather valid entries to the front of a fixed-size
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
    Entries beyond out_size are dropped (check `count`).

    Returns (out (out_size, ...), out_mask (out_size,) of values' dtype,
    count () int32 clipped to out_size). No host sync: rows that are masked
    out or overflow all land in one extra bin that is sliced off."""
    maskb = mask > 0.5
    pos = torch.cumsum(maskb.to(torch.int32), dim=0) - 1
    count = torch.sum(maskb.to(torch.int32))
    dest = torch.where(maskb & (pos < out_size), pos, out_size).to(torch.int64)
    out = torch.full((out_size + 1,) + tuple(values.shape[1:]), fill,
                     dtype=values.dtype, device=values.device)
    out.index_copy_(0, dest, values)
    out_mask = torch.zeros(out_size + 1, dtype=values.dtype, device=values.device)
    out_mask.index_fill_(0, dest, 1)
    return (out[:out_size], out_mask[:out_size],
            torch.clamp(count, max=out_size).to(torch.int32))
