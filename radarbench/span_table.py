"""Where a cell's device idle time goes, by the program's spans. One run of
a cell with `--trace 1`, as `run.py` makes it, then, over its profiled
replays: the device's idle time put down to the innermost span open at
each idle moment, the device operations counted by the innermost span open
when each started, and how the launches of K4 and K1 line up with the
spans that launch them (`spans.launch_alignment`). From the root of a
checkout, on a machine with an NVIDIA GPU:

    python3 radarbench/span_table.py --workload <cell> --seed <n> --seconds <s>

Standard output: the run's result line, then one JSON object: the
profiled window's busy time, the root spans' length and the device's idle
time inside them, the idle seconds and the operations started by span,
each span name's count, the program's counters, the clock anchors'
corrections, and the launch alignment with and without them.
"""

import json
import os
import sys
import time
from collections import Counter

T_START = time.perf_counter()


def table(trace, rec) -> dict:
    from radarbench import spans

    base = spans.trace_base_ns()
    corr = spans.anchor_corrections(getattr(rec, "anchors", ()), base, trace.ops)
    mapped = spans.on_trace_clock(rec.spans, base, corr)
    raw = spans.on_trace_clock(rec.spans, base)
    roots = [s for s in mapped if s.parent < 0]
    busy = spans.merged((s, e) for _, s, e in trace.ops)
    idle_roots, len_roots = spans.idle_inside(mapped, busy, {s.name for s in roots})
    return {
        "window_s": trace.window_s, "busy_s": trace.busy_s,
        "roots": len(roots), "roots_s": len_roots, "idle_in_roots_s": idle_roots,
        "idle_by_span_s": spans.idle_by_span(mapped, trace.ops),
        "ops_started_by_span": spans.starts_by_span(mapped, trace.ops),
        "k4_gn_sweep": spans.launch_alignment(mapped, trace.kernels, {"gn.sweep"},
                                              "vgicp_sweep_kernel"),
        "k1_icp_pass": spans.launch_alignment(mapped, trace.kernels,
                                              {"icp.iteration", "icp.fitness"},
                                              "icp_moments_kernel"),
        "anchor_corrections_us": [round(c * 1e6, 3) for _, c in corr],
        "uncorrected_k4_gn_sweep": spans.launch_alignment(raw, trace.kernels, {"gn.sweep"},
                                                          "vgicp_sweep_kernel"),
        "uncorrected_k1_icp_pass": spans.launch_alignment(raw, trace.kernels,
                                                          {"icp.iteration", "icp.fitness"},
                                                          "icp_moments_kernel"),
        "spans": dict(Counter(s.name for s in mapped)), "counters": rec.counters,
        "dropped": rec.dropped,
    }


if __name__ == "__main__":
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    if sys.path[1:2] == [os.path.dirname(os.path.abspath(__file__))]:
        del sys.path[1]
    from radarbench import harness, spans, trace

    kept = []

    class KeptTracer(trace.Tracer):
        def __init__(self, device):
            super().__init__(device)
            kept.append(self)

    trace.Tracer = KeptTracer            # run_cell imports it from the module
    rc = harness.main(sys.argv[1:] + ["--trace", "1"], T_START)
    rec = spans.recorded()
    if rc == 0 and kept and rec is not None:
        print(json.dumps(table(kept[-1].trace, rec)))
    raise SystemExit(rc)
