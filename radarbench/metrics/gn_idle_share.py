"""Share of the joint GN phase (the program's `s2m.gn` spans: the scan
covariances, the sweeps, solves and syncs of every GN loop of the profiled
replay) in which no operation ran on the device: the spans' length less
the union of device operations inside them, over their length."""

from radarbench import spans


def read(run):
    return spans.idle_share(run, "s2m.gn")
