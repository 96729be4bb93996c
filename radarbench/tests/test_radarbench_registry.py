"""A later change adds a configuration, a traffic mix, a cell and a
per-layer metric as new files and entries, and edits no file that is there:
the harness finds each by its name."""

import copy
import json

import torch

from radarbench.harness import Registry, run_cell


def test_added_files_are_found_and_run(tiny, benchmark_json):
    d = tiny.dir
    before = {p: p.read_bytes() for p in d.rglob("*") if p.is_file()}
    # a configuration: the dense sensor at another landmark count
    cfg = json.loads((d / "configs" / "dense4096.json").read_text())
    cfg["name"] = "dense-sparse-scene"
    cfg["sequence"]["num_landmarks"] = 900
    (d / "configs" / "dense-sparse-scene.json").write_text(json.dumps(cfg))
    # a traffic mix: a shorter fleet of more streams
    (d / "traffic" / "fleet-6x16-b8.json").write_text(json.dumps(
        {"driver": "fleet", "why": "a test mix", "streams": 6, "frames": 16}))
    (d / "limits" / "fleet-sparse.json").write_text(json.dumps(
        {"pose_gap_m": 1e-3, "rot_gap_rad": 1e-4, "track_rpe_m": 1.0}))
    # a per-layer metric: replays in the profiled window
    (d / "metrics" / "profiled_scans.fleet.py").write_text(
        "def read(run):\n    return run.counters.get('profiled_scans') or None\n")
    bench = copy.deepcopy(benchmark_json)
    bench["configs"].append({"name": "dense-sparse-scene", "source": "a test",
                             "file": "radarbench/configs/dense-sparse-scene.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "fleet-sparse", "config": "dense-sparse-scene",
                               "traffic": "fleet-6x16-b8", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if "workloads" in m and m["name"] == "scans_per_s":
            m["workloads"].append("fleet-sparse")
    bench["per_layer"].append({"name": "profiled_scans.fleet", "unit": "scans", "better": "higher",
                               "source": "program_counter", "layer": "entry", "moves":
                               "scans_per_s", "workloads": ["fleet-sparse"]})
    reg = Registry(d, bench)
    assert reg.workload("fleet-sparse")["config"] == "dense-sparse-scene"
    assert reg.config("dense-sparse-scene")["sequence"]["num_landmarks"] == 900
    assert reg.traffic("fleet-6x16-b8")["streams"] == 6
    assert [m["name"] for m in reg.metrics_for("per_layer", "fleet-sparse")] == [
        "profiled_scans.fleet"]
    r = run_cell(reg, "fleet-sparse", 77, 6.0, True, torch.device("cpu"), 0.0,
                 log=lambda *a, **k: None)
    assert r["correct"], r["checks"]
    assert r["metrics"]["profiled_scans.fleet"]["value"] == 6 * 16
    after = {p: p.read_bytes() for p in before}
    assert after == before                  # no file that was there changed
