"""The map insert's share of a fleet replay on the host's clock: the
program's `s2m.insert` spans over its `s2m.replay` spans in the profiled
replay (neither synchronizes the device)."""

from radarbench import spans


def read(run):
    return spans.host_share("s2m.insert", "s2m.replay")
