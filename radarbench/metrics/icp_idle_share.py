"""Share of the batched ICP (the program's `s2s.icp` spans: the clouds
packed, every moments launch with its Horn step and sync, the fitness
pass) in which no operation ran on the device, in the profiled replays."""

from radarbench import spans


def read(run):
    return spans.idle_share(run, "s2s.icp")
