"""K4's share of its roofline in the profiled replay: the least time an
H100 needs for every sweep launch of that replay (`radarbench/
roofline.py`, each launch's frames against each stream's live submap
rows, launches read from the per-frame GN iteration counts) over the
device time of `vgicp_sweep_kernel`, in percent."""

from radarbench.roofline import vgicp_launches_bound_s


def read(run):
    sets = run.counters.get("k4_launch_sets")
    if run.trace is None or not sets:
        return None
    t = run.trace.kernel_time("vgicp_sweep_kernel")
    if t <= 0:
        return None
    bound = sum(vgicp_launches_bound_s(it, sp, n, groups) for it, sp, n, groups in sets)
    return 100.0 * bound / t
