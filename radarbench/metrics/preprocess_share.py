"""The Doppler preprocessing's share of a scan-to-scan replay on the host's
clock: the program's `s2s.preprocess` spans over its `s2s.replay` spans in
the profiled replays (neither synchronizes the device)."""

from radarbench import spans


def read(run):
    return spans.host_share("s2s.preprocess", "s2s.replay")
