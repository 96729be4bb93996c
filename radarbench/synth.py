"""Synthetic 4D-radar sequences made on the device from a seed: the
benchmark's own generator, a vectorised copy of
`icp4dradar_tpu/io/dataset.py` `SyntheticSequence` (:140-243) and its
vendor degradation `_apply_vendor_profile` with `VENDOR_PROFILES`
(:88-137), as the port's `icp4dradar_tpu_torch/io/dataset.py` keeps them.

The draws are not the numpy generator's: every frame of every stream is
drawn in bulk with a `torch.Generator` on the device, from the seed and the
stream's index. The distributions are the original's:

- landmarks: half volumetric scatter (z in [-3, 8]), a quarter ground plane
  (z = -1.5 +- 0.02), a quarter on four walls;
- motion: a constant body-frame step (`speed` forward, `turn_rate` yaw) from
  the origin, each stream at its own start heading;
- a scan: the landmarks within (0.5, max_range) of the sensor, a random
  `max_points` of them when more, position noise, Doppler v_r = d . v_ego
  plus noise, a `dynamic_fraction` of off-model Doppler, intensity in
  [5, 30);
- a vendor profile: field-of-view and range cut, range-dependent dropout,
  radial and tangential noise, multipath ghosts.

A scan's live rows come first; the rest of its `max_points` rows are
padding (mask 0).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional

import torch

# (azimuth half-angle deg, elevation half-angle deg, max range m, dropout at
# r = 0, extra dropout at r = rmax, ghost fraction, sigma range m, sigma
# angle deg): `icp4dradar_tpu/io/dataset.py:92-99`
VENDOR_PROFILES = {
    "rio": (60.0, 10.0, 100.0, 0.05, 0.30, 0.02, 0.15, 0.5),
    "ti_mmwave": (60.0, 15.0, 30.0, 0.15, 0.45, 0.05, 0.10, 1.0),
    "oculii": (55.0, 22.0, 150.0, 0.05, 0.25, 0.08, 0.20, 0.25),
    "coloradar": (70.0, 20.0, 50.0, 0.10, 0.35, 0.04, 0.12, 0.7),
}

FRAME_CHUNK = 128          # frames drawn together: bounds the (frames, L) tiles


@dataclass(frozen=True)
class SequenceParams:
    max_points: int = 4096
    num_landmarks: int = 20000
    world_extent: float = 120.0
    max_range: float = 80.0
    speed: float = 1.0
    turn_rate: float = 0.02
    pos_noise: float = 0.02
    doppler_noise: float = 0.05
    dynamic_fraction: float = 0.1
    dynamic_doppler: float = 3.0
    vendor_profile: Optional[str] = None


@dataclass(frozen=True)
class Streams:
    """(B, F, N) scan fields of B streams, and their (B, F, 4, 4) ground
    truth world <- sensor poses."""

    xyz: torch.Tensor
    doppler: torch.Tensor
    intensity: torch.Tensor
    mask: torch.Tensor
    gt: torch.Tensor

    def streams(self, idx) -> "Streams":
        """The streams `idx` (an index list, a tensor or a slice), copied."""
        return Streams(*(getattr(self, f.name)[idx].clone() for f in dataclasses.fields(self)))


def stream_generator(seed: int, stream: int, device) -> torch.Generator:
    """The generator of one stream: any seed below 2**63 and any stream
    index give their own draws."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + 7919 * int(stream) + 1) % (1 << 63))
    return g


def _landmarks(p: SequenceParams, g, device) -> torch.Tensor:
    E, L = p.world_extent, p.num_landmarks
    n_plane = L // 2
    n_scatter = L - n_plane

    def u(n, lo, hi):
        return torch.rand(n, generator=g, device=device, dtype=torch.float64) * (hi - lo) + lo

    def nrm(n, mu, sd):
        return torch.randn(n, generator=g, device=device, dtype=torch.float64) * sd + mu

    scatter = torch.stack([u(n_scatter, -E, E), u(n_scatter, -E, E), u(n_scatter, -3.0, 8.0)], -1)
    ng = n_plane // 2
    ground = torch.stack([u(ng, -E, E), u(ng, -E, E), nrm(ng, -1.5, 0.02)], -1)
    n_wall = n_plane - ng
    walls, spacing = [], max(40.0, E / 3.0)
    for i in range(4):
        k = n_wall // 4 if i < 3 else n_wall - 3 * (n_wall // 4)
        a, z, c = u(k, -E, E), u(k, -1.0, 6.0), nrm(k, (i - 1.5) * spacing, 0.05)
        walls.append(torch.stack([a, c, z], -1) if i % 2 == 0 else torch.stack([c, a, z], -1))
    return torch.cat([scatter, ground] + walls).to(torch.float32)


def trajectory(p: SequenceParams, frames: int, yaw0: float, device) -> torch.Tensor:
    """(F, 4, 4) poses of a constant body step from the origin at heading
    yaw0: yaw_k = yaw0 + k w, position the sum of the earlier steps."""
    k = torch.arange(frames, device=device, dtype=torch.float64)
    yaw = yaw0 + k * p.turn_rate
    step = torch.stack([torch.cos(yaw), torch.sin(yaw)], -1) * p.speed
    pos = torch.cumsum(step, 0) - step                     # sum over j < k
    T = torch.zeros((frames, 4, 4), dtype=torch.float64, device=device)
    T[:, 0, 0], T[:, 0, 1] = torch.cos(yaw), -torch.sin(yaw)
    T[:, 1, 0], T[:, 1, 1] = torch.sin(yaw), torch.cos(yaw)
    T[:, 2, 2] = T[:, 3, 3] = 1.0
    T[:, :2, 3] = pos
    return T.to(torch.float32)


def _front(valid: torch.Tensor, *fields):
    """Reorder the rows of each frame live first (stable)."""
    order = torch.argsort((~valid).to(torch.int8), dim=-1, stable=True)
    out = [torch.gather(valid, -1, order)]
    for f in fields:
        idx = order if f.dim() == valid.dim() else order[..., None].expand(f.shape)
        out.append(torch.gather(f, 1, idx))
    return out


def _vendor(prof, pts, dop, inten, valid, g):
    """`_apply_vendor_profile` on a (C, N) chunk of live-first scans."""
    az_fov, el_fov, rmax, d0, d1, ghost_frac, s_r, s_ang = prof
    C, N = valid.shape
    dev = pts.device
    r = torch.clamp(torch.linalg.vector_norm(pts, dim=-1), min=1e-6)
    az = torch.rad2deg(torch.atan2(pts[..., 1], pts[..., 0]))
    el = torch.rad2deg(torch.arcsin(torch.clamp(pts[..., 2] / r, -1.0, 1.0)))
    keep = valid & (az.abs() < az_fov) & (el.abs() < el_fov) & (r < rmax)
    p_drop = d0 + d1 * (r / rmax) ** 2
    keep &= torch.rand((C, N), generator=g, device=dev) > p_drop
    d = pts / r[..., None]
    pts = pts + d * (torch.randn((C, N), generator=g, device=dev) * s_r)[..., None]
    tang = torch.randn((C, N, 3), generator=g, device=dev) * math.radians(s_ang) * r[..., None]
    pts = pts + tang - d * torch.sum(tang * d, -1, keepdim=True)
    keep, pts, dop, inten = _front(keep, pts, dop, inten)
    # ghosts: the first n_ghost kept rows, a random subset (rows are in a
    # random order already)
    n_ghost = (keep.sum(-1) * ghost_frac).floor()
    row = torch.arange(N, device=dev)
    scale = torch.rand((C, N), generator=g, device=dev) * 0.5 + 1.4
    gpts = pts * scale[..., None]
    gdop = dop * scale + torch.randn((C, N), generator=g, device=dev) * 0.3
    gint = inten * (torch.rand((C, N), generator=g, device=dev) * 0.4 + 0.3)
    gkeep = (row[None] < n_ghost[:, None]) & (torch.linalg.vector_norm(gpts, dim=-1) < rmax)
    v, x, dd, ii = _front(torch.cat([keep, gkeep], 1), torch.cat([pts, gpts], 1),
                          torch.cat([dop, gdop], 1), torch.cat([inten, gint], 1))
    return x[:, :N], dd[:, :N], ii[:, :N], v[:, :N]


def make_streams(p: SequenceParams, streams: int, frames: int, seed: int, device) -> Streams:
    """B = `streams` sequences of `frames` scans each, drawn on `device` from
    `seed`: stream b from its own generator (`stream_generator`), so a
    stream's scans do not depend on how many streams are drawn."""
    out = []
    for b in range(streams):
        g = stream_generator(seed, b, device)
        lm = _landmarks(p, g, device)
        yaw0 = float(torch.rand((), generator=g, device=device)) * 2.0 * math.pi
        gt = trajectory(p, frames, yaw0, device)
        parts = [_scans(p, lm, gt[f0:f0 + FRAME_CHUNK], g) for f0 in range(0, frames, FRAME_CHUNK)]
        out.append([torch.cat(x) for x in zip(*parts)] + [gt])
    return Streams(*(torch.stack(x) for x in zip(*out)))


def _scans(p: SequenceParams, lm, T, g):
    """The scans of the C frames at poses T (C, 4, 4) -> (xyz, doppler,
    intensity, mask), each (C, N, ...)."""
    C, N, dev = T.shape[0], p.max_points, T.device
    R, t = T[:, :3, :3], T[:, :3, 3]
    local = torch.einsum("clj,cjk->clk", lm[None] - t[:, None], R)   # R^T (x - t)
    r = torch.linalg.vector_norm(local, dim=-1)
    cand = (r < p.max_range) & (r > 0.5)
    key = torch.where(cand, torch.rand(cand.shape, generator=g, device=dev), 2.0)
    kk, sel = torch.topk(key, min(N, key.shape[1]), dim=-1, largest=False)
    valid = kk < 1.5
    pts = torch.gather(local, 1, sel[..., None].expand(-1, -1, 3))
    pts = pts + torch.randn(pts.shape, generator=g, device=dev) * p.pos_noise
    d = pts / torch.clamp(torch.linalg.vector_norm(pts, dim=-1), min=1e-6)[..., None]
    # body-frame ego velocity of a constant step: (speed, 0, 0) a frame
    dop = d[..., 0] * p.speed + torch.randn(valid.shape, generator=g, device=dev) * p.doppler_noise
    n_dyn = (valid.sum(-1) * p.dynamic_fraction).floor()
    dyn = torch.arange(valid.shape[1], device=dev)[None] < n_dyn[:, None]
    dop = dop + dyn * torch.abs(torch.randn(valid.shape, generator=g, device=dev)
                                + p.dynamic_doppler)
    inten = torch.rand(valid.shape, generator=g, device=dev) * 25.0 + 5.0
    if p.vendor_profile is not None:
        pts, dop, inten, valid = _vendor(VENDOR_PROFILES[p.vendor_profile], pts, dop, inten,
                                         valid, g)
    if pts.shape[1] < N:                  # fewer landmarks than rows: pad
        pad = N - pts.shape[1]
        pts = torch.cat([pts, pts.new_zeros((C, pad, 3))], 1)
        dop, inten = (torch.cat([x, x.new_zeros((C, pad))], 1) for x in (dop, inten))
        valid = torch.cat([valid, valid.new_zeros((C, pad))], 1)
    m = valid.to(torch.float32)
    return pts * m[..., None], dop * m, inten * m, m
