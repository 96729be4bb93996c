"""Blocking host transfers per scan in the profiled replays: the program's
`host_syncs` counter (each read or copy that makes the host wait for the
device, counted at its call site while the profiler records) over the
scans those replays tracked."""

from radarbench import spans


def read(run):
    return spans.per_scan(run, "host_syncs")
