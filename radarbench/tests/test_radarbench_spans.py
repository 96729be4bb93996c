"""`radarbench/spans.py`: the interval arithmetic of the span metrics on
synthetic timelines, the clock recovery on a CPU profile, and None where
the program recorded nothing."""

import json
from types import SimpleNamespace

import pytest

from radarbench import spans
from radarbench.harness import Run
from radarbench.trace import DeviceTrace


def S(name, start, end, parent=-1, root=0):
    return spans.Span(name, start, end, parent, root)


def _ns(x):                     # seconds -> the program's nanosecond stamps
    return round(x * 1e9)


def recorded_of(timeline, counters=None):
    """A program's `recorded()` from (name, start s, end s, parent) rows."""
    rows, roots = [], []
    for i, (name, s, e, parent) in enumerate(timeline):
        roots.append(i if parent < 0 else roots[parent])
        rows.append(SimpleNamespace(name=name, start_ns=_ns(s), end_ns=_ns(e), parent=parent,
                                    root=roots[-1]))
    return SimpleNamespace(spans=rows, counters=counters or {}, dropped=0)


def test_idle_inside_and_host_share():
    busy = spans.merged([(1.0, 3.0), (2.0, 4.0), (8.0, 12.0)])
    assert busy == [(1.0, 4.0), (8.0, 12.0)]
    assert spans.covered(busy, 0.0, 10.0) == pytest.approx(5.0)
    assert spans.covered(busy, 2.5, 3.0) == pytest.approx(0.5)
    tl = [S("gn", 0.0, 10.0), S("gn", 9.0, 11.0), S("other", 20.0, 30.0)]
    idle, length = spans.idle_inside(tl, busy, {"gn"})
    assert (idle, length) == (pytest.approx(5.0), pytest.approx(11.0))     # the union [0, 11]
    tl = [S("replay", 0.0, 10.0), S("insert", 1.0, 2.0, 0), S("insert", 5.0, 7.0, 0)]
    assert spans.host_length(tl, "insert") / spans.host_length(tl, "replay") == pytest.approx(0.3)


def test_idle_goes_to_the_innermost_open_span():
    tl = [S("r", 0.0, 10.0), S("a", 1.0, 4.0, 0), S("b", 2.0, 3.0, 1), S("c", 6.0, 9.0, 0)]
    assert spans.innermost(tl) == [(0.0, 1.0, "r"), (1.0, 2.0, "a"), (2.0, 3.0, "b"),
                                   (3.0, 4.0, "a"), (4.0, 6.0, "r"), (6.0, 9.0, "c"),
                                   (9.0, 10.0, "r")]
    ops = [("k", 0.0, 1.5), ("k", 8.0, 10.0)]
    got = spans.idle_by_span(tl, ops)
    assert got == {"r": pytest.approx(2.0), "c": pytest.approx(2.0), "a": pytest.approx(1.5),
                   "b": pytest.approx(1.0)}
    assert list(got)[-1] == "b"                                  # largest first
    started = spans.starts_by_span(tl, [("k", 0.5, 0.6), ("k", 2.5, 2.6), ("k", 2.7, 2.8),
                                        ("k", 7.0, 7.1), ("k", 11.0, 11.1)])
    assert started == {"b": 2, "r": 1, "c": 1}                   # none outside the root


def test_launch_alignment_pairs_kernels_with_their_spans_in_order():
    tl = [S("gn.sweep", 1.0, 1.1), S("gn.solve", 1.1, 1.2), S("gn.sweep", 2.0, 2.1),
          S("gn.sweep", 3.0, 3.1)]
    kernels = [("void (anonymous namespace)::vgicp_sweep_kernel(float const*)", 1.05, 1.06),
               ("vgicp_sweep_kernel", 2.5, 2.6),                 # 0.4 s after its span
               ("vgicp_sweep_kernel", 3.0 - 4e-5, 3.05),         # 40 us before its span
               ("vgicp_frozen_kernel", 1.07, 1.08)]
    a = spans.launch_alignment(tl, kernels, {"gn.sweep"}, "vgicp_sweep_kernel")
    assert (a["kernels"], a["spans"]) == (3, 3)
    assert a["within"] == pytest.approx(2 / 3)
    assert a["early_s"] == pytest.approx(4e-5) and a["late_s"] == pytest.approx(0.4)
    none = spans.launch_alignment(tl, kernels, {"gn.sweep"}, "icp_moments_kernel")
    assert none["within"] is None and none["kernels"] == 0


def test_clock_anchors_move_the_spans_by_their_interpolated_correction():
    base = 10**18
    # anchors read at 1 s and 3 s on the host; their copies start 200 us and
    # 400 us later on the trace: the conversion is off by 200 us, drifting
    ops = [("k", 1.5, 1.6), (spans.ANCHOR_OP, 1.0002, 1.0003), (spans.ANCHOR_OP, 3.0004, 3.0005)]
    corr = spans.anchor_corrections([base + 3 * 10**9, base + 10**9], base, ops)
    assert [t for t, _ in corr] == [1.0, 3.0]
    assert [c for _, c in corr] == [pytest.approx(2e-4), pytest.approx(4e-4)]
    assert spans.correction_at(2.0, corr) == pytest.approx(3e-4)
    assert spans.correction_at(0.0, corr) == pytest.approx(2e-4)      # the nearest outside
    assert spans.correction_at(9.0, corr) == pytest.approx(4e-4)
    rec = recorded_of([("r", 1.0, 3.0, -1), ("a", 2.0, 2.5, 0)])
    got = spans.on_trace_clock(rec.spans, 0, corr)
    assert [(s.start, s.end) for s in got] == [
        (pytest.approx(1.0002), pytest.approx(3.0004)), (pytest.approx(2.0003),
                                                         pytest.approx(2.50035))]
    assert spans.on_trace_clock(rec.spans, 0, [])[1].start == pytest.approx(2.0)


@pytest.mark.parametrize("lost", [(), (0,), (0, 1, 2), (11,), (5, 6), tuple(range(4, 12))])
def test_anchors_pair_with_their_copies_when_records_are_lost(lost):
    # a replay's anchors: its start, twelve loop reads 5 ms apart, its end;
    # the conversion drifts by 1% (the most seen) and some copies are lost
    host = [1.0] + [1.004 + 0.005 * k for k in range(12)] + [1.07]

    def err(t):
        return 8e-5 - 0.01 * (t - 1.0)

    copies = [(spans.ANCHOR_OP, t + err(t) + 1e-5, t + err(t) + 2e-5)
              for k, t in enumerate(host) if k not in lost]
    corr = spans.anchor_corrections([round(t * 1e9) for t in host], 0, copies)
    if 2 * (len(host) - len(lost)) < len(host):
        assert corr == []                     # too few to trust: no correction
        return
    assert [t for t, _ in corr] == pytest.approx([t for k, t in enumerate(host) if k not in lost])
    assert all(abs(c - err(t) - 1e-5) < 1e-9 for t, c in corr)


def test_readers_on_a_synthetic_run(monkeypatch):
    rec = recorded_of([("s2m.replay", 0.0, 10.0, -1), ("s2m.gn", 1.0, 5.0, 0),
                       ("gn.sweep", 1.0, 2.0, 1), ("s2m.insert", 6.0, 8.0, 0)],
                      {"host_syncs": 30})
    monkeypatch.setattr(spans, "recorded", lambda: rec)
    monkeypatch.setattr(spans, "_base_ns", 0)
    run = Run(DeviceTrace(ops=[("k", 1.5, 2.5), ("k", 4.0, 9.0)], window_s=10.0),
              {"profiled_scans": 60})
    assert spans.idle_share(run, "s2m.gn") == pytest.approx((4.0 - 2.0) / 4.0)
    assert spans.host_share("s2m.insert", "s2m.replay") == pytest.approx(0.2)
    assert spans.per_scan(run, "host_syncs") == pytest.approx(0.5)
    assert spans.idle_share(run, "s2s.icp") is None              # no such span
    assert spans.idle_share(Run(None, {}), "s2m.gn") is None      # untraced


def test_clock_recovery_on_a_cpu_profile(tmp_path):
    from icp4dradar_tpu_torch.utils import profiling as P

    base = spans.trace_base_ns()           # also the process's first annotation
    P.reset()
    with P.profile_trace(str(tmp_path)):
        with P.span("clock.check"):
            pass
    rec = P.recorded()
    P.reset()
    doc = json.loads((tmp_path / "trace.json").read_text())
    if "baseTimeNanoseconds" in doc:
        assert doc["baseTimeNanoseconds"] == base
    ev = next(e for e in doc["traceEvents"] if e.get("name") == "clock.check")
    span = spans.on_trace_clock(rec.spans, base)[0]
    # the annotation opens just before the span reads the clock
    assert -2e-4 <= span.start - float(ev["ts"]) * 1e-6 <= 1e-3


def test_nothing_recorded_reads_none(monkeypatch):
    from icp4dradar_tpu_torch.utils import profiling as P

    P.reset()
    run = Run(DeviceTrace(ops=[("k", 0.0, 1.0)], window_s=2.0), {"profiled_scans": 8})
    assert spans.recorded() is None
    assert spans.idle_share(run, "s2m.gn") is None
    assert spans.host_share("s2s.preprocess", "s2s.replay") is None
    assert spans.per_scan(run, "host_syncs") is None
    monkeypatch.delattr(P, "recorded")                    # a program without the recorder
    assert spans.recorded() is None
