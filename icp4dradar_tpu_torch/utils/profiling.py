"""Per-stage wall-clock timing with device synchronization (PyTorch port of
`icp4dradar_tpu/utils/profiling.py`), and the trackers' spans and counters.

Replaces the reference's dormant TicToc (include/tic_toc.h:10-32, included
but never called): a timer whose `toc` synchronizes the CUDA devices of the
tensors it is given, so device work is actually measured, plus
`profile_trace`, a torch.profiler run written as a Chrome trace.

The trackers mark their layers with `span(name)` and count the calls that
make the host wait for the device with `count("host_syncs")`. Both record
into memory only inside `recording()` or while a torch.profiler profile is
active in the process, and never synchronize; `recorded()` returns what
was held. Span times are `time.time_ns()`, the clock a torch.profiler
Chrome trace counts its `ts` from (`ts` in us + `baseTimeNanoseconds`), so
spans and device kernels can be laid on one timeline. The device's
timestamps reach that clock through the profiler's own conversion, which
drifts, by up to milliseconds a second: under a profile on a CUDA device, a
span opened with `anchor=True` (a tracker's call) marks its start and end
with clock anchors, and so does each loop read (`drained`): each anchor is
one 4-byte pinned host-to-device copy ("Memcpy HtoD (Pinned -> Device)" on
the trace, no kernel) issued on an idle device right after a clock read,
whose device start gives the conversion's error there. Recording is for one thread: spans nest by the order they open and
close.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from collections import defaultdict
from typing import Any, Dict, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler


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


# ---- spans and counters ------------------------------------------------

# spans held at most; beyond it a span is counted in `dropped` and not kept
MAX_SPANS = 1_000_000


class Span(NamedTuple):
    """One recorded span: its name, host-clock start and end (`time.time_ns`;
    end -1 while open), and the indices in `recorded().spans` of its parent
    (-1 for a root) and of its root (its own for a root)."""

    name: str
    start_ns: int
    end_ns: int
    parent: int
    root: int


class Recorded(NamedTuple):
    """Spans in the order they opened, counters, the spans dropped past
    MAX_SPANS, and the host-clock times of the clock anchors (`span`'s
    `anchor`, `drained`), in the order of their copies."""

    spans: List[Span]
    counters: Dict[str, int]
    dropped: int
    anchors: List[int]


_recording_depth = 0      # open recording() contexts
_spans: list = []         # [name, start, end, parent, root] per span
_open: list = []          # indices of the open spans, innermost last
_counters: Dict[str, int] = {}
_dropped = 0
_generation = 0           # bumped by reset(): an open span never writes into a new buffer
_anchors: list = []       # time.time_ns() of each clock anchor
_anchor_buffers: dict = {}    # device index -> (pinned source, device destination)


def _clock_anchor(dev: Optional[int] = None, synchronize: bool = True) -> None:
    """Under a profile, on CUDA device `dev` (the current one by default):
    wait for it (unless the caller just did), read the clock and issue one
    pinned 4-byte host-to-device copy, which starts on the idle device right
    away."""
    if not (_autograd_profiler._is_profiler_enabled and torch.cuda.is_initialized()):
        return
    dev = torch.cuda.current_device() if dev is None else dev
    if dev not in _anchor_buffers:
        # made without a kernel: an anchor adds no launch to a trace
        _anchor_buffers[dev] = (torch.zeros(1, dtype=torch.int32).pin_memory(),
                                torch.empty(1, dtype=torch.int32, device=dev))
    src, dst = _anchor_buffers[dev]
    if synchronize:
        torch.cuda.synchronize(dev)
    _anchors.append(time.time_ns())
    dst.copy_(src, non_blocking=True)


def drained(device: torch.device) -> None:
    """Call right after a blocking read from `device`, whose stream then has
    no work left: under a profile, a clock anchor there at no further
    synchronize. The loops take one each pass, so that the anchors come
    every few milliseconds and a few lost device records leave the rest."""
    if _autograd_profiler._is_profiler_enabled and device.type == "cuda":
        _clock_anchor(device.index, synchronize=False)


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "anchor", "index", "generation", "annotation")

    def __init__(self, name, anchor):
        self.name, self.anchor = name, anchor
        self.index = -1
        self.annotation = None

    def __enter__(self):
        global _dropped
        if len(_spans) >= MAX_SPANS:
            _dropped += 1
            return self
        if _autograd_profiler._is_profiler_enabled:
            # the span on the profiler's own timeline, a user annotation
            self.annotation = _autograd_profiler.record_function(self.name)
            self.annotation.__enter__()
        if self.anchor:
            _clock_anchor()
        parent = _open[-1] if _open else -1
        i = len(_spans)
        _spans.append([self.name, time.time_ns(), -1, parent,
                       i if parent < 0 else _spans[parent][4]])
        _open.append(i)
        self.index, self.generation = i, _generation
        return self

    def __exit__(self, *exc):
        if self.index >= 0 and self.generation == _generation:
            _spans[self.index][2] = time.time_ns()
            _open.pop()
            if self.anchor:
                _clock_anchor()
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        return False


def span(name: str, anchor: bool = False):
    """A context manager marking one layer's work as a span `name`, child of
    the innermost open span; with `anchor`, clock anchors at its start and
    end while a profile is active. Off (outside `recording()` and any
    profile) it is one shared no-op object."""
    if not (_recording_depth or _autograd_profiler._is_profiler_enabled):
        return _NO_SPAN
    return _Span(name, anchor)


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name` while recording."""
    if _recording_depth or _autograd_profiler._is_profiler_enabled:
        _counters[name] = _counters.get(name, 0) + n


@contextlib.contextmanager
def recording():
    """Record spans and counters inside this block (they are also recorded
    while a torch.profiler profile is active)."""
    global _recording_depth
    _recording_depth += 1
    try:
        yield
    finally:
        _recording_depth -= 1


def recorded() -> Recorded:
    """The spans and counters recorded since the last `reset()`, in the
    order the spans opened; nothing is cleared."""
    return Recorded([Span(*s) for s in _spans], dict(_counters), _dropped, list(_anchors))


def reset() -> None:
    """Clear the recorded spans, counters, drop count and anchors."""
    global _dropped, _generation
    _spans.clear()
    _open.clear()
    _counters.clear()
    _anchors.clear()
    _dropped = 0
    _generation += 1
