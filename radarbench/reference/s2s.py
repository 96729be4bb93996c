"""The plain reference of the scan-to-scan cells: the frozen plain copy of
the port's `run_scan_to_scan` (`reference/frozen/`), fed the benchmark's
own scans and RANSAC draws, on the device they lie on. It works everything
out anew: the Doppler sine fit, the static split, the ego velocities, the
ICP of every frame pair (the K1 moments pass as plain torch), the tracking
gate and the pose chain. `tf32=True` computes it with TF32 library
products, the control."""

from __future__ import annotations

import torch

from radarbench.reference.frozen import config as fconfig
from radarbench.reference.frozen import scan as fscan
from radarbench.reference.frozen import scan_to_scan as fs2s
from radarbench.reference.s2m import precision


def run(st, uniforms, cfg: dict, opts: dict, tf32: bool = False) -> dict:
    """The (F, ...) velocities, frame-to-frame transforms and poses of
    stream 0 of `st`."""
    pcfg = fconfig.PipelineConfig.from_dict(cfg["pipeline"])
    F = st.mask.shape[1]
    scans = fscan.RadarScan(xyz=st.xyz[0], doppler=st.doppler[0], intensity=st.intensity[0],
                            mask=st.mask[0],
                            time=torch.arange(F, device=st.mask.device, dtype=torch.float32))
    with precision(tf32), torch.no_grad():
        out = fs2s.run_scan_to_scan(scans, pcfg, uniforms=uniforms, **opts)
    return {"velocity": out.velocity, "icp_transform": out.icp_transform,
            "world_T": out.world_T}
