"""The program's spans and counters (`icp4dradar_tpu_torch.utils.profiling`:
`span`, `count`, `recorded`), laid on the device trace's clock, and the
interval arithmetic the span metrics read.

The program records spans while a torch.profiler profile is active, so a
`--trace 1` run holds exactly the spans of its profiled replays. A span's
times are `time.time_ns()`; the device trace's times (`radarbench/
trace.py`) are the Chrome trace's `ts`, counted from the trace's
`baseTimeNanoseconds` on the same clock. `trace_base_ns` recovers that base
from a CPU profile of one annotation. The profiler brings the device's
timestamps onto that clock with an error that drifts, by up to
milliseconds a second; the program's clock anchors (a pinned 4-byte copy
to an idle device right after a clock read: at the start and end of each
replay and after each loop read) measure it, and `on_trace_clock` moves
the spans by it, interpolated between anchors. Everything but the recovery is plain Python,
so that tests check it on synthetic timelines. Every reader returns None
where the program recorded nothing, a program without the recorder
included."""

from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

# a kernel launched inside a span may start this long after the span ends
# (queued behind earlier work), and no earlier than this before it starts
LATE_S, EARLY_S = 2e-3, 50e-6
# the device operation of a clock anchor (`profiling._clock_anchor`)
ANCHOR_OP = "Memcpy HtoD (Pinned -> Device)"
# pairing anchors with their copies (`anchor_corrections`): a copy's
# tolerance about its predicted place (s) at the first pair and after it,
# plus a share of the time since the last pair (the drift seen was up to
# 1% of a replay)
START_TOL_S = 1e-3
PAIR_TOL_S, PAIR_DRIFT = 2e-4, 0.02


class Span(NamedTuple):
    """A span on the trace's clock (seconds); parent and root index the
    span list (-1: no parent)."""

    name: str
    start: float
    end: float
    parent: int
    root: int


def recorded():
    """What the program recorded (its `profiling.recorded()`: spans,
    counters, dropped), or None where it recorded no span or has no
    recorder."""
    try:
        from icp4dradar_tpu_torch.utils import profiling
    except ImportError:
        return None
    get = getattr(profiling, "recorded", None)
    rec = get() if get is not None else None
    if rec is None or not rec.spans:
        return None
    return rec


_base_ns: Optional[int] = None


def trace_base_ns() -> int:
    """The host clock (`time.time_ns`) at the device trace's zero, from a
    CPU profile of one annotation: its export's `baseTimeNanoseconds`, or,
    where the export writes none, the clock read just before the annotation
    less the annotation's `ts`. Once per process."""
    global _base_ns
    if _base_ns is None:
        from torch.profiler import ProfilerActivity, profile, record_function

        with profile(activities=[ProfilerActivity.CPU]) as prof:
            t = time.time_ns()
            with record_function("radarbench.clock"):
                pass
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                doc = json.load(f)
        finally:
            os.unlink(path)
        base = doc.get("baseTimeNanoseconds")
        if base is None:
            ev = next(e for e in doc["traceEvents"] if e.get("name") == "radarbench.clock")
            base = t - round(float(ev["ts"]) * 1e3)
        _base_ns = int(base)
    return _base_ns


def anchor_corrections(anchors_ns: Sequence[int], base_ns: int,
                       ops) -> List[Tuple[float, float]]:
    """(host time of each clock anchor on the trace's clock, the device start
    of its copy less that time), both in seconds, in time order, for the
    anchors whose copy is on the trace (`ANCHOR_OP`): the profiler can lose
    device records, most often at a profile's start. Walking the anchors in
    order, each takes the copy nearest its predicted place, when within the
    tolerance of it: first no correction, within START_TOL_S (the
    conversion starts close and drifts), then the last pair's correction,
    within PAIR_TOL_S; both widen by PAIR_DRIFT of the time since the last
    pair. Empty where under half the anchors pair."""
    copies = sorted(s for n, s, _ in ops if n == ANCHOR_OP)
    host = sorted((a - base_ns) * 1e-9 for a in anchors_ns)
    if not host or not copies:
        return []
    out: List[Tuple[float, float]] = []
    pred, tol, last = 0.0, START_TOL_S, host[0]
    for t in host:
        i = bisect.bisect_left(copies, t + pred)
        near = min(copies[max(i - 1, 0):i + 1], key=lambda c: abs(c - t - pred))
        if abs(near - t - pred) <= tol + PAIR_DRIFT * (t - last):
            pred, tol, last = near - t, PAIR_TOL_S, t
            out.append((t, pred))
    return out if 2 * len(out) >= len(host) else []


def correction_at(t: float, corr: Sequence[Tuple[float, float]]) -> float:
    """The anchors' correction at host time t: linear between the anchors
    around it, the nearest anchor's outside them, 0 without anchors."""
    if not corr:
        return 0.0
    i = bisect.bisect_right(corr, (t, float("inf")))
    if i == 0:
        return corr[0][1]
    if i == len(corr):
        return corr[-1][1]
    (t0, c0), (t1, c1) = corr[i - 1], corr[i]
    return c0 + (c1 - c0) * (t - t0) / (t1 - t0) if t1 > t0 else c1


def on_trace_clock(spans, base_ns: int, corr: Sequence[Tuple[float, float]] = ()) -> List[Span]:
    """The program's spans in seconds of the trace's clock, each time moved
    by the anchors' correction there; a span still open ends where it
    starts."""
    out = []
    for s in spans:
        start = (s.start_ns - base_ns) * 1e-9
        end = (s.end_ns - base_ns) * 1e-9 if s.end_ns >= 0 else start
        out.append(Span(s.name, start + correction_at(start, corr),
                        end + correction_at(end, corr), s.parent, s.root))
    return out


def merged(intervals) -> List[Tuple[float, float]]:
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def covered(busy: Sequence[Tuple[float, float]], s: float, e: float) -> float:
    """Length of the disjoint sorted intervals `busy` inside [s, e]."""
    i = max(bisect.bisect_right(busy, (s, float("inf"))) - 1, 0)
    total = 0.0
    while i < len(busy) and busy[i][0] < e:
        total += max(0.0, min(e, busy[i][1]) - max(s, busy[i][0]))
        i += 1
    return total


def idle_inside(spans: Sequence[Span], busy, names) -> Tuple[float, float]:
    """(device idle seconds, length) of the union of the spans named in
    `names`, against the disjoint sorted busy intervals."""
    idle = length = 0.0
    for s, e in merged((x.start, x.end) for x in spans if x.name in names):
        length += e - s
        idle += (e - s) - covered(busy, s, e)
    return idle, length


def host_length(spans: Sequence[Span], name: str) -> float:
    """Host-clock length of the union of the spans named `name`."""
    return sum(e - s for s, e in merged((x.start, x.end) for x in spans if x.name == name))


def innermost(spans: Sequence[Span]) -> List[Tuple[float, float, str]]:
    """(start, end, name) segments: at each moment inside a root span, the
    innermost span open then (spans nest, as one thread opens them)."""
    out: List[Tuple[float, float, str]] = []
    stack: List[Span] = []
    t = None
    for sp in sorted(spans, key=lambda x: (x.start, -x.end)):
        while stack and stack[-1].end <= sp.start:
            top = stack.pop()
            if top.end > t:
                out.append((t, top.end, top.name))
                t = top.end
        if stack and sp.start > t:
            out.append((t, sp.start, stack[-1].name))
        t = sp.start if t is None else max(t, sp.start)
        stack.append(sp)
    while stack:
        top = stack.pop()
        if top.end > t:
            out.append((t, top.end, top.name))
            t = top.end
    return out


def idle_by_span(spans: Sequence[Span], ops) -> Dict[str, float]:
    """The device's idle seconds inside the root spans, put down to the
    innermost span open at each idle moment, largest first. `ops`: device
    operations (name, start, end)."""
    busy = merged((s, e) for _, s, e in ops)
    by: Dict[str, float] = {}
    for s, e, name in innermost(spans):
        idle = (e - s) - covered(busy, s, e)
        if idle > 0:
            by[name] = by.get(name, 0.0) + idle
    return dict(sorted(by.items(), key=lambda kv: -kv[1]))


def starts_by_span(spans: Sequence[Span], ops) -> Dict[str, int]:
    """Device operations (name, start, end) counted by the innermost span
    open when each started, most first; a launch into an idle device
    starts within microseconds, so on a host-paced timeline this is close
    to the launches each span made."""
    segs = innermost(spans)
    starts = [s for s, _, _ in segs]
    by: Dict[str, int] = {}
    for _, t, _ in ops:
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t < segs[i][1]:
            by[segs[i][2]] = by.get(segs[i][2], 0) + 1
    return dict(sorted(by.items(), key=lambda kv: -kv[1]))


def _kernel_pattern(function: str):
    return re.compile(r"(^|[\s:])" + re.escape(function) + r"(\(|$)")


def launch_alignment(spans: Sequence[Span], kernels, names, function: str) -> dict:
    """How the kernels of `function` line up with the spans named in `names`
    that launch them, one each, in order: the share that starts within
    [span start - EARLY_S, span end + LATE_S], the earliest start before
    its span (s) and the latest after its span's end (s)."""
    pat = _kernel_pattern(function)
    ks = sorted(s for n, s, _ in kernels if pat.search(n))
    ss = sorted((x.start, x.end) for x in spans if x.name in names)
    pairs = list(zip(ks, ss))
    if not pairs:
        return {"kernels": len(ks), "spans": len(ss), "within": None, "early_s": None,
                "late_s": None}
    within = sum(1 for k, (s, e) in pairs if s - EARLY_S <= k <= e + LATE_S)
    return {"kernels": len(ks), "spans": len(ss), "within": within / len(pairs),
            "early_s": max(s - k for k, (s, _) in pairs),
            "late_s": max(k - e for k, (_, e) in pairs)}


# ---- what the readers under metrics/ call ----

def mapped(rec, ops) -> List[Span]:
    """What the program recorded, on the clock of the device operations
    `ops`, corrected by its clock anchors where it has them."""
    base = trace_base_ns()
    corr = anchor_corrections(getattr(rec, "anchors", ()), base, ops)
    return on_trace_clock(rec.spans, base, corr)


def idle_share(run, name: str) -> Optional[float]:
    """Device idle time inside the spans `name` over their length, in the
    profiled replays of a `--trace 1` run."""
    rec = recorded()
    if run.trace is None or not run.trace.ops or rec is None:
        return None
    spans = mapped(rec, run.trace.ops)
    idle, length = idle_inside(spans, merged((s, e) for _, s, e in run.trace.ops), {name})
    return idle / length if length > 0 else None


def host_share(name: str, of: str) -> Optional[float]:
    """Host-clock length of the spans `name` over that of the spans `of`."""
    rec = recorded()
    if rec is None:
        return None
    spans = on_trace_clock(rec.spans, 0)
    whole = host_length(spans, of)
    return host_length(spans, name) / whole if whole > 0 else None


def per_scan(run, counter: str) -> Optional[float]:
    """The program's counter over the scans the profiled replays tracked
    (0 where the program recorded spans and never counted)."""
    rec, n = recorded(), run.counters.get("profiled_scans", 0)
    if rec is None or not n:
        return None
    return rec.counters.get(counter, 0) / n
