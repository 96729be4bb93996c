"""The trackers' spans and the `host_syncs` counter
(`icp4dradar_tpu_torch.utils.profiling`): the span tree of a scan-to-scan
replay and of a blocked batch replay, the loop spans against the iteration
counts the outputs carry, outputs bit for bit with recording on and off,
nothing recorded when off, the spans on a `profile_trace` timeline, the
buffer bound and the synchronized `phase_times`. CPU, small inputs."""

import collections
import dataclasses
import json
import math

import pytest
import torch

from icp4dradar_tpu_torch.config import PipelineConfig
from icp4dradar_tpu_torch.io import SyntheticSequence
from icp4dradar_tpu_torch.io.scan import stack_scans
from icp4dradar_tpu_torch.models import scan_to_map as s2m
from icp4dradar_tpu_torch.models.scan_to_scan import run_scan_to_scan
from icp4dradar_tpu_torch.utils import profiling as P
from tests._torch_threads import one_torch_thread  # noqa: F401

BLOCK = 8


def _frames(num_frames, n, seed):
    seq = SyntheticSequence(num_frames=num_frames, max_points=n, num_landmarks=3000, seed=seed)
    return stack_scans([seq.scan(k, device="cpu") for k in range(num_frames)])


def _s2m_cfg():
    return PipelineConfig().override(**{"voxel_map.capacity": 1 << 14,
                                        "voxel_map.submap_max_points": 1 << 12})


def _recorded(fn):
    P.reset()
    with P.recording():
        out = fn()
    rec = P.recorded()
    P.reset()
    return out, rec


def _equal(a, b):
    return all(torch.equal(getattr(a, f.name), getattr(b, f.name))
               for f in dataclasses.fields(a))


@pytest.fixture(scope="module")
def s2s_runs():
    scans = _frames(64, 256, 3)

    def run():
        return run_scan_to_scan(scans, PipelineConfig(), use_doppler_prior=True)

    off = run()
    on, rec = _recorded(run)
    return off, on, rec


@pytest.fixture(scope="module")
def s2m_runs():
    bs = stack_scans([_frames(24, 256, s) for s in (1, 2)])

    def run():
        return s2m.run_scan_to_map_batch(bs, _s2m_cfg(), block=BLOCK,
                                         use_const_velocity_rot=True)[1]

    off = run()
    on, rec = _recorded(run)
    return off, on, rec


def _children(spans):
    kids = collections.defaultdict(list)
    for i, s in enumerate(spans):
        kids[s.parent].append(i)
    return kids


def _assert_tree(spans, root_name):
    """One root, every span closed, inside its parent and under its root."""
    assert [s.name for s in spans if s.parent < 0] == [root_name]
    for i, s in enumerate(spans):
        assert s.start_ns <= s.end_ns
        if s.parent < 0:
            assert s.root == i
            continue
        p = spans[s.parent]
        assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns, (p.name, s.name)
        assert s.root == p.root


def _names(spans, idx):
    return [spans[i].name for i in idx]


def test_scan_to_scan_span_tree_and_icp_iterations(s2s_runs):
    _, out, rec = s2s_runs
    spans = rec.spans
    _assert_tree(spans, "s2s.replay")
    kids = _children(spans)
    assert _names(spans, kids[0]) == ["s2s.preprocess", "s2s.icp", "s2s.gate", "s2s.chain"]
    pre, icp = kids[0][0], kids[0][1]
    assert _names(spans, kids[pre]) == ["doppler.chunk"] * math.ceil(64 / 128)
    inner = _names(spans, kids[icp])
    n_iter = int(out.iterations.max())
    assert inner == ["icp.prepare"] + ["icp.iteration"] * n_iter + ["icp.fitness"]
    # every pass but the cap's last ends with the read that decides the next
    iters = [i for i in kids[icp] if spans[i].name == "icp.iteration"]
    syncs = [_names(spans, kids[i]) for i in iters]
    assert syncs[:-1] == [["icp.sync"]] * (n_iter - 1)
    assert syncs[-1] == ([] if n_iter == PipelineConfig().icp.max_iterations else ["icp.sync"])
    assert _names(spans, kids[kids[icp][0]]) == ["icp.sync"]
    # the loop's reads, and the copies from the host (each Horn step's
    # start vector, the rigid transforms' constant row, the gate's seed)
    assert set(rec.counters) == {"host_syncs"}
    assert rec.counters["host_syncs"] > 2 * (n_iter + 1)


def test_blocked_batch_span_tree(s2m_runs):
    _, _, rec = s2m_runs
    spans = rec.spans
    _assert_tree(spans, "s2m.replay")
    kids = _children(spans)
    top = _names(spans, kids[0])
    assert top[:4] == ["s2m.sort", "s2m.warmup", "s2m.reve", "s2m.gn"]
    nblocks = (24 - BLOCK) // BLOCK
    assert top[4:] == ["s2m.sector_query", "s2m.sort", "s2m.gn", "s2m.insert"] * nblocks
    warm = kids[0][1]
    assert _names(spans, kids[warm]) == [
        "s2m.reve", "s2m.sector_query", "s2m.gn", "s2m.insert"] * BLOCK
    allowed = {"gn.prepare": {"gn.sync"}, "gn.iteration": {"gn.sweep", "gn.solve", "gn.sync"},
               "s2m.gn": {"gn.prepare", "gn.iteration", "s2m.fallback"}}
    for i, s in enumerate(spans):
        if s.name in allowed:
            assert set(_names(spans, kids[i])) <= allowed[s.name], s.name


def test_gn_iteration_spans_equal_each_block_and_frames_largest_count(s2m_runs):
    _, out, rec = s2m_runs
    spans = rec.spans
    kids = _children(spans)

    def iterations(i):
        return _names(spans, kids[i]).count("gn.iteration")

    warm = kids[0][1]
    frame_gn = [i for i in kids[warm] if spans[i].name == "s2m.gn"]
    assert [iterations(i) for i in frame_gn] == out.iterations[:, :BLOCK].amax(0).tolist()
    block_gn = [i for i in kids[0] if spans[i].name == "s2m.gn"][1:]   # after the precompute
    want = [int(out.iterations[:, f:f + BLOCK].max()) for f in range(BLOCK, 24, BLOCK)]
    assert [iterations(i) for i in block_gn] == want
    for i in block_gn:            # one K4 sweep and one solve an iteration
        for it in (j for j in kids[i] if spans[j].name == "gn.iteration"):
            assert _names(spans, kids[it])[:2] == ["gn.sweep", "gn.solve"]
    names = collections.Counter(s.name for s in spans)
    assert rec.counters["host_syncs"] >= names["gn.sync"] > 0


@pytest.mark.parametrize("runs", ["s2s_runs", "s2m_runs"])
def test_outputs_bit_identical_with_recording_on_and_off(runs, request):
    off, on, _ = request.getfixturevalue(runs)
    assert _equal(off, on)


def test_recording_off_records_nothing():
    P.reset()
    assert P.span("s2s.replay") is P.span("gn.sweep")          # the shared no-op
    run_scan_to_scan(_frames(8, 128, 4), PipelineConfig(), use_doppler_prior=True)
    P.count("host_syncs")
    rec = P.recorded()
    assert rec.spans == [] and rec.counters == {} and rec.dropped == 0


def test_profile_trace_records_the_spans_as_user_annotations(tmp_path):
    P.reset()
    with P.profile_trace(str(tmp_path)):
        run_scan_to_scan(_frames(8, 128, 4), PipelineConfig(), use_doppler_prior=True)
    rec = P.recorded()
    P.reset()
    names = collections.Counter(s.name for s in rec.spans)
    assert names["s2s.replay"] == 1 and names["icp.iteration"] > 0
    assert rec.anchors == []                    # clock anchors only on a CUDA device
    doc = json.loads((tmp_path / "trace.json").read_text())
    ann = collections.Counter(e["name"] for e in doc["traceEvents"]
                              if e.get("cat") == "user_annotation" and e["name"] in names)
    assert ann == names
    # the spans' clock is the trace's, ts (us) + baseTimeNanoseconds: each
    # annotation holds its span (it opens first and closes last), to within
    # the 0.2 ms the profiler's clock conversion may be off by
    events = sorted((e for e in doc["traceEvents"]
                     if e.get("cat") == "user_annotation" and e["name"] in names),
                    key=lambda e: float(e["ts"]))
    base = doc["baseTimeNanoseconds"]
    for e, s in zip(events, sorted(rec.spans, key=lambda s: s.start_ns)):
        start = round(float(e["ts"]) * 1e3) + base
        end = start + round(float(e["dur"]) * 1e3)
        assert e["name"] == s.name
        assert start - 200_000 <= s.start_ns and s.end_ns <= end + 200_000, s.name


def test_buffer_bound_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(P, "MAX_SPANS", 3)
    P.reset()
    with P.recording():
        with P.span("a"):
            for _ in range(4):
                with P.span("b"):
                    with P.span("c"):
                        P.count("host_syncs", 2)
        with P.span("d"):
            pass
    rec = P.recorded()
    P.reset()
    assert [s.name for s in rec.spans] == ["a", "b", "c"]
    assert all(s.end_ns >= s.start_ns for s in rec.spans)
    assert rec.dropped == 7 and rec.counters == {"host_syncs": 8}


def test_phase_times_keep_their_synchronized_phases(monkeypatch):
    bs = stack_scans([_frames(16, 256, s) for s in (1,)])
    times = {}
    P.reset()
    with P.recording():
        s2m.run_scan_to_map_batch(bs, _s2m_cfg(), block=BLOCK, use_const_velocity_rot=True,
                                  phase_times=times)
    names = {s.name for s in P.recorded().spans}
    P.reset()
    assert {"reve", "sort", "sector_query", "gn", "insert"} <= set(times)
    assert all(v > 0 for v in times.values())
    assert {"s2m." + k for k in times} <= names
    # on a card a timed phase synchronizes before and after; its span never does
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: calls.append(device))
    cuda = torch.device("cuda")
    with P.recording():
        with s2m._phase(times, "pg_check", cuda, "pg."):
            pass
        with s2m._phase(None, "front_end", cuda, "pg."):
            pass
    assert calls == [cuda, cuda] and "pg_check" in times
    assert [s.name for s in P.recorded().spans] == ["pg.pg_check", "pg.front_end"]
    P.reset()
