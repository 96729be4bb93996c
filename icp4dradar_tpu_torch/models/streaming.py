"""Streaming (online) odometry session with checkpoint / resume-at-scan-k
(PyTorch port of `icp4dradar_tpu/models/streaming.py`).

The offline runners track whole sequences; a session serves the live case:
one step per incoming scan (or per micro-batch of scans), persistent state,
and durable snapshots, so that a crashed process resumes from the latest
{pose, map, frame index, RNG key} snapshot (SURVEY.md §5: the reference
has no failure recovery; its only analog is the CSV record/replay fixture).

The session's RNG state is the JAX session's: Threefry key data, a (2,)
uint32 array (`utils/threefry.py`), split once a call. Its REVE draws are
made on the host (3H floats a frame) and copied to the device, so that a
port session and a JAX session see the same draws, and a checkpoint's
last leaf is the key data the JAX session writes. Its file is the JAX
session's file: one loads in the other.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from icp4dradar_tpu_torch.config import PipelineConfig
from icp4dradar_tpu_torch.io.scan import RadarScan
from icp4dradar_tpu_torch.models.scan_to_map import (
    ScanToMapOutput,
    ScanToMapState,
    run_scan_to_map_blocked,
    scan_to_map_init,
    scan_to_map_step,
)
from icp4dradar_tpu_torch.preprocess.reve import reve_hypotheses
from icp4dradar_tpu_torch.utils import threefry
from icp4dradar_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint


class OdometrySession:
    """Online scan-to-map odometry with periodic durable checkpoints. The
    state is one stream's: world_T (4, 4) and a single-table map, on
    `device`."""

    def __init__(
        self,
        cfg: PipelineConfig = PipelineConfig(),
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: int = 50,
        use_doppler_prior: bool = True,
        guard_nonfinite: bool = True,
        device="cuda",
    ):
        self.cfg = cfg
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = checkpoint_every
        self.guard_nonfinite = guard_nonfinite
        self.device = torch.device(device)
        self.frame = 0
        self.skipped_frames = 0
        self.state: ScanToMapState = scan_to_map_init(cfg, device=self.device)
        self._key = threefry.key(cfg.seed)
        self._use_doppler_prior = use_doppler_prior
        self._hypotheses = reve_hypotheses(cfg.reve)

    def _split(self) -> np.ndarray:
        """key, sub = split(key): the new subkey's data."""
        self._key, sub = threefry.split(self._key, 2)
        return sub

    def _accept(self, new_state: ScanToMapState, frames: int) -> None:
        """Keep the new state unless the guard finds its pose non-finite
        (the session's one host sync a call)."""
        if self.guard_nonfinite and not bool(torch.isfinite(new_state.world_T).all()):
            self.skipped_frames += frames
        else:
            self.state = new_state

    # ------------------------------------------------------------------
    def process(self, scan: RadarScan) -> ScanToMapOutput:
        """Track one scan (fields (N, ...)); returns its output record.

        With `guard_nonfinite`, a frame whose pose goes non-finite
        (degenerate scan, solver blow-up) is skipped: the previous state is
        kept and `skipped_frames` incremented."""
        u = threefry.uniform(self._split(), 3 * self._hypotheses)
        new_state, out = scan_to_map_step(
            self.state, scan.to(self.device), torch.from_numpy(u).to(self.device), self.cfg,
            use_doppler_prior=self._use_doppler_prior)
        self._accept(new_state, 1)
        self.frame += 1
        if (self.checkpoint_dir and self.checkpoint_every
                and self.frame % self.checkpoint_every == 0):
            self.checkpoint()
        return out

    def process_batch(self, scans: RadarScan, block: int = 0) -> ScanToMapOutput:
        """Track a micro-batch of B stacked frames (fields (B, N, ...)) in
        one runner call: `run_scan_to_map_blocked` from the session's
        state, per frame for `block` <= 1, else frame-parallel blocks of
        `block` frames (B % block == 0) with one sector query and one insert
        a block. Outputs are stacked (B, ...).

        The non-finite guard applies to the whole batch: if its final pose
        is non-finite, the whole batch is skipped and skipped_frames += B."""
        B = int(scans.xyz.shape[0])
        u = threefry.reve_uniforms(self.cfg.seed, B, block, self._hypotheses,
                                   k=self._split(), continued=True)
        new_state, outs = run_scan_to_map_blocked(
            scans.to(self.device), self.cfg, uniforms=torch.from_numpy(u).to(self.device),
            block=block, use_doppler_prior=self._use_doppler_prior, init_state=self.state)
        self._accept(new_state, B)
        self.frame += B
        if (self.checkpoint_dir and self.checkpoint_every
                and self.frame % self.checkpoint_every < B):
            self.checkpoint()
        return outs

    @property
    def pose(self) -> np.ndarray:
        return self.state.world_T.cpu().numpy()

    # ------------------------------------------------------------------
    def _ckpt_path(self) -> str:
        if self.checkpoint_dir is None:
            raise ValueError("OdometrySession has no checkpoint_dir")
        return os.path.join(self.checkpoint_dir, "session")

    def checkpoint(self) -> str:
        """Durable snapshot of {pose, map, frame index, RNG key}: leaves
        world_T, the map's seven tables, then the key data."""
        path = self._ckpt_path()
        save_checkpoint(path, (self.state, self._key), {"frame": self.frame})
        return path + ".npz"

    def resume(self) -> int:
        """Restore the latest snapshot; returns the frame index to continue
        from (scans [frame, ...) must be fed again)."""
        (state, key_data), meta = load_checkpoint(self._ckpt_path(), (self.state, self._key))
        vm = state.vmap
        self.state = ScanToMapState(
            world_T=torch.from_numpy(state.world_T).to(self.device),
            vmap=vm.with_tables(torch.from_numpy(t).to(self.device) for t in vm.tables()))
        self._key = np.asarray(key_data, dtype=np.uint32)
        self.frame = int(meta["frame"])
        return self.frame

    @classmethod
    def has_checkpoint(cls, checkpoint_dir: str) -> bool:
        return os.path.exists(os.path.join(checkpoint_dir, "session.npz"))
