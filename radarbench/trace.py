"""Device trace of the profiled units of a `--trace 1` run: torch.profiler
with CUDA activity only (kernels, copies and fills; no host operators, so
that a replay of some hundred thousand launches stays cheap to trace), read
back from its Chrome trace."""

from __future__ import annotations

import json
import os
import re
import tempfile
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import List, Tuple

from radarbench import stats

# Chrome-trace categories of device operations
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class DeviceTrace:
    """Device operations (name, start s, end s) of the profiled sections,
    the kernels among them, and the sections' host-clock length."""

    ops: List[Tuple[str, float, float]] = field(default_factory=list)
    kernels: List[Tuple[str, float, float]] = field(default_factory=list)
    window_s: float = 0.0

    @property
    def busy_s(self) -> float:
        return stats.union_length((s, e) for _, s, e in self.ops)

    def kernel_time(self, function: str) -> float:
        """Device seconds of the kernels of the function named `function`
        (`(anonymous namespace)::icp_moments_kernel(float const*, ...)` is
        `icp_moments_kernel`'s)."""
        pat = re.compile(r"(^|[\s:])" + re.escape(function) + r"(\(|$)")
        return sum(e - s for n, s, e in self.kernels if pat.search(n))

    def breakdown(self) -> dict:
        return {"device_ops": stats.top_ops(self.ops), "idle_gaps": stats.idle_gaps(self.ops)}


def parse_chrome_trace(doc: dict) -> Tuple[list, list]:
    """(device ops, kernels) as (name, start s, end s) from a Chrome trace."""
    ops, kernels = [], []
    for ev in doc.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        cat = str(ev.get("cat", "")).lower()
        if cat not in _DEVICE_CATS:
            continue
        s = float(ev["ts"]) * 1e-6
        item = (str(ev.get("name", "")), s, s + float(ev.get("dur", 0.0)) * 1e-6)
        ops.append(item)
        if cat == "kernel":
            kernels.append(item)
    return ops, kernels


class Tracer:
    """Profiles the sections a driver marks with `section()`; their device
    operations accumulate in `trace`."""

    def __init__(self, device):
        self.device = device
        self.trace = DeviceTrace()

    def warm(self):
        """Start the profiler once on an empty section: its first start
        (CUPTI's initialisation) takes seconds, which belong to no unit."""
        with self.section():
            pass
        self.trace = DeviceTrace()

    @contextmanager
    def section(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        cuda = self.device.type == "cuda"

        def sync():
            if cuda:
                torch.cuda.synchronize(self.device)

        sync()
        # on the CPU (the tests) the trace holds host operators only: no
        # device operation is read from it
        with profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]) as prof:
            t0 = time.perf_counter()
            yield
            sync()
            t1 = time.perf_counter()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                ops, kernels = parse_chrome_trace(json.load(f))
        finally:
            os.unlink(path)
        self.trace.ops += ops
        self.trace.kernels += kernels
        self.trace.window_s += t1 - t0
