"""CUDA kernels launched per scan in the profiled replays: the trace's
kernel count over the scans those replays tracked."""


def read(run):
    t, n = run.trace, run.counters.get("profiled_scans", 0)
    if t is None or not n or not t.kernels:
        return None
    return len(t.kernels) / n
