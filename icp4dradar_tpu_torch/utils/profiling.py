"""Per-stage wall-clock timing with device synchronization (PyTorch port of
`icp4dradar_tpu/utils/profiling.py`).

Replaces the reference's dormant TicToc (include/tic_toc.h:10-32, included
but never called): a timer whose `toc` synchronizes the CUDA devices of the
tensors it is given, so device work is actually measured, plus
`profile_trace`, a torch.profiler run written as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from collections import defaultdict
from typing import Any, Dict

import torch


def _cuda_devices(tree: Any, out: set) -> set:
    """The CUDA devices of the tensors in a tensor, dataclass, dict or
    sequence."""
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            out.add(tree.device)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            _cuda_devices(getattr(tree, f.name), out)
    elif isinstance(tree, dict):
        for v in tree.values():
            _cuda_devices(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _cuda_devices(v, out)
    return out


class StageTimer:
    """Accumulates per-stage elapsed seconds and call counts."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self._start: Dict[str, float] = {}

    def tic(self, stage: str) -> None:
        self._start[stage] = time.perf_counter()

    def toc(self, stage: str, sync: Any = None) -> float:
        """Stop `stage`; with `sync` (a tensor or a tree of them), first
        wait for every CUDA device that holds one of its tensors."""
        for dev in _cuda_devices(sync, set()):
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - self._start[stage]
        self.totals[stage] += dt
        self.counts[stage] += 1
        return dt

    class _Ctx:
        def __init__(self, timer, stage, sync_fn):
            self.timer, self.stage, self.sync_fn = timer, stage, sync_fn

        def __enter__(self):
            self.timer.tic(self.stage)
            return self

        def __exit__(self, *exc):
            self.timer.toc(self.stage, self.sync_fn() if self.sync_fn else None)

    def stage(self, name: str, sync_fn=None) -> "_Ctx":
        return StageTimer._Ctx(self, name, sync_fn)

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {
                "total_s": self.totals[k],
                "count": self.counts[k],
                "mean_ms": 1e3 * self.totals[k] / max(self.counts[k], 1),
            }
            for k in self.totals
        }


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Context manager around torch.profiler with the CPU activity and, where
    a CUDA device is present, the CUDA activity; on exit it writes the
    Chrome trace `log_dir/trace.json` (chrome://tracing, Perfetto). Yields
    the profiler (its `key_averages()` sums the time by op and kernel)."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
