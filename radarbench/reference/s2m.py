"""The plain reference of the scan-to-map cells: the frozen plain copy of
the port's trackers (`reference/frozen/`), fed the benchmark's own inputs
(scans and REVE draws), on the device they lie on. It works everything out
anew: REVE, the radar covariances, the voxel maps with their inserts and
sector queries, the GN loops (the K4 sweep as plain torch) and the poses.

`tf32=True` computes it with TF32 library products, the control: one
precision below the float32 the configurations state."""

from __future__ import annotations

from contextlib import contextmanager

import torch

from radarbench.reference.frozen import config as fconfig
from radarbench.reference.frozen import scan as fscan
from radarbench.reference.frozen import scan_to_map as fs2m


@contextmanager
def precision(tf32: bool):
    """float32 library products, or TF32 ones for the control."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = bool(tf32)
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _scans(st, frames=slice(None)):
    B, F = st.mask[:, frames].shape[:2]
    t = torch.arange(F, device=st.mask.device, dtype=torch.float32).expand(B, F).contiguous()
    return fscan.RadarScan(xyz=st.xyz[:, frames], doppler=st.doppler[:, frames],
                           intensity=st.intensity[:, frames], mask=st.mask[:, frames], time=t)


def blocked_batch(st, uniforms, cfg: dict, opts: dict, tf32: bool = False) -> torch.Tensor:
    """(B, F, 4, 4) poses of the streams `st` through the blocked batch
    tracker with the options `opts`."""
    pcfg = fconfig.PipelineConfig.from_dict(cfg["pipeline"])
    with precision(tf32), torch.no_grad():
        _, out = fs2m.run_scan_to_map_batch(_scans(st), pcfg, uniforms=uniforms, **opts)
    return out.world_T

