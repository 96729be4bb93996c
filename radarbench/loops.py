"""What the drivers share: the closed loop of whole replays and the inputs
(scans and RANSAC draws) made from the seed."""

from __future__ import annotations

import time
from contextlib import ExitStack
from dataclasses import dataclass
from typing import Callable, List

import torch

from radarbench import synth


def sequence_params(cfg: dict) -> synth.SequenceParams:
    return synth.SequenceParams(**cfg["sequence"])


def draws(seed: int, tag: int, shape, device) -> torch.Tensor:
    """Uniform RANSAC draws in [0, 1) of `shape`, from the seed: the same
    tensor for the program and for the reference."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 2_654_435_761 + 97 * tag + 12345) % (1 << 63))
    return torch.rand(tuple(shape), generator=g, device=device, dtype=torch.float32)


def stream_inputs(cfg: dict, traffic: dict, streams: int, frames: int, draws_per_frame: int,
                  seed: int, tag: int, device):
    """The (B, F) scans and (B, F, draws_per_frame) RANSAC draws of a mix's
    streams. With a `scene_seed` in the traffic, the drives and their draws
    come from it and `seed` only orders the streams: every seed asks for the
    same work (the GN's iteration counts follow the data), in another
    order. Without it, everything comes from `seed`."""
    scene = traffic.get("scene_seed")
    base = seed if scene is None else int(scene)
    st = synth.make_streams(sequence_params(cfg), streams, frames, base, device)
    u = draws(base, tag, (streams, frames, draws_per_frame), device)
    if scene is not None:
        order = sample(seed, streams, streams)
        st, u = st.streams(order), u[order]
    return st, u


def sample(seed: int, n: int, k: int) -> list:
    """k of range(n) drawn from the seed, in the drawn order."""
    g = torch.Generator()
    g.manual_seed(int(seed) % (1 << 63))
    return torch.randperm(n, generator=g)[:k].tolist()


def port_scans(st: synth.Streams, RadarScan):
    """A RadarScan class's (B, F, N) scans of the streams, frame index as
    the time stamp."""
    B, F = st.mask.shape[:2]
    t = torch.arange(F, device=st.mask.device, dtype=torch.float32).expand(B, F).contiguous()
    return RadarScan(xyz=st.xyz, doppler=st.doppler, intensity=st.intensity, mask=st.mask,
                     time=t)


@dataclass
class ClosedLoop:
    t0: float
    close: float
    completions: List[float]
    results: list
    attempted: int


def closed_loop(seconds: float, unit: Callable[[int], object], tracer=None,
                profiled=range(0)) -> ClosedLoop:
    """Run `unit(k)`, which ends with its results on the host, back to back
    until the window closes; a unit is not started after the close. The
    units of the range `profiled` run inside one trace section."""
    t0 = time.perf_counter()
    close = t0 + seconds
    completions, results, k = [], [], 0
    with ExitStack() as traced:
        while time.perf_counter() < close:
            if tracer is not None and k == profiled.start:
                traced.enter_context(tracer.section())
            results.append(unit(k))
            completions.append(time.perf_counter())
            k += 1
            if k == profiled.stop:
                traced.close()
    return ClosedLoop(t0, close, completions, results, k)
