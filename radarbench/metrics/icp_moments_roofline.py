"""K1's share of its roofline in the profiled replays: the least time an
H100 needs for every moments launch those replays made (`radarbench/
roofline.py`, over the live pairs each launch swept, read from the
per-pair ICP iteration counts) over the device time of
`icp_moments_kernel`, in percent."""

from radarbench.roofline import icp_launches_bound_s


def read(run):
    sets = run.counters.get("k1_launch_sets")
    if run.trace is None or not sets:
        return None
    t = run.trace.kernel_time("icp_moments_kernel")
    if t <= 0:
        return None
    return 100.0 * sum(icp_launches_bound_s(*s) for s in sets) / t
