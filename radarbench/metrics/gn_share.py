"""The GN phase's share of a replay's host-clock phase split
(`models/scan_to_map.py` `phase_times`: reve, sort, sector_query, gn,
insert), from one untimed replay after the window: phase_times["gn"] over
the sum of all phases."""


def read(run):
    pt = run.counters.get("phase_times")
    if not pt or "gn" not in pt or sum(pt.values()) <= 0:
        return None
    return pt["gn"] / sum(pt.values())
