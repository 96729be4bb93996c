"""Share of the profiled replays' window in which no operation ran on the
device: 1 - (union of device operation intervals) / (host-clock length of
the profiled sections)."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0 or not t.ops:
        return None
    return 1.0 - t.busy_s / t.window_s
