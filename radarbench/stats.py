"""The benchmark's arithmetic: rates, spreads and device busy time.
Plain Python, so that tests check it on synthetic timelines."""

from __future__ import annotations

import statistics
from typing import Iterable, List, Optional, Sequence, Tuple


def rate(units_per_replay: int, t0: float, completions: Sequence[float],
         t_close: float) -> Optional[float]:
    """Work of the whole replays completed in the window [t0, t_close],
    over the time from t0 to the last of those completions; None when
    none completed. A replay that completes after the close is partial
    and not counted."""
    done = [t for t in completions if t <= t_close]
    if not done:
        return None
    return units_per_replay * len(done) / (max(done) - t0)


def spread(values: Sequence[float]) -> float:
    """Inter-quartile distance over the median, with Python's
    `statistics.quantiles(values, n=4)` quartiles."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med


def union_length(intervals: Iterable[Tuple[float, float]]) -> float:
    """Total length covered by the (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(events: Sequence[Tuple[str, float, float]], top: int = 10) -> List[list]:
    """Gaps between device operations (name, start, end), summed by the
    name of the operation that ended each gap, longest first: [[
    "before_<name>", total], ...], at most `top` entries."""
    by: dict = {}
    cur_e = None
    for name, s, e in sorted(events, key=lambda x: x[1]):
        if cur_e is not None and s > cur_e:
            key = "before_" + name[:56]
            by[key] = by.get(key, 0.0) + (s - cur_e)
        cur_e = e if cur_e is None else max(cur_e, e)
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def top_ops(events: Sequence[Tuple[str, float, float]], top: int = 10) -> List[list]:
    """Device time summed by operation name, largest first."""
    by: dict = {}
    for name, s, e in events:
        key = name[:64]
        by[key] = by.get(key, 0.0) + (e - s)
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]
