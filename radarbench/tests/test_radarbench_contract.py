"""BENCHMARK.json against the benchmark's contract: names, units, keys and
the files each entry names."""

import re

from conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")


def test_names_and_units_use_allowed_characters(benchmark_json):
    b = benchmark_json
    names = [c["name"] for c in b["configs"]] + [w["name"] for w in b["workloads"]]
    names += [w["config"] for w in b["workloads"]] + [w["traffic"] for w in b["workloads"]]
    names += [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    names += [k for c in b["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    units = [m["unit"] for m in b["end_to_end"] + b["per_layer"]]
    assert all(UNIT.match(u) for u in units)
    texts = [w["why"] for w in b["workloads"]] + [c["why"] for c in b["configs"]]
    texts += [c["source"] for c in b["configs"]] + [m["layer"] for m in b["per_layer"]]
    texts += b["command"]
    assert all(LINE.match(t) for t in texts)
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        got = [x["name"] for x in b[group]]
        assert len(got) == len(set(got))


def test_entries_have_exactly_the_contract_keys(benchmark_json):
    b = benchmark_json
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        e2e = {x["name"]: x for x in b["end_to_end"]}
        assert m["moves"] in e2e
        # every cell that lists the metric reports the metric it moves
        assert set(m["workloads"]) <= set(e2e[m["moves"]].get("workloads", m["workloads"]))
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])


def test_every_named_file_exists(benchmark_json):
    b = benchmark_json
    for c in b["configs"]:
        assert (ROOT / c["file"]).is_file()
    for w in b["workloads"]:
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (BENCH / "limits" / f"{w['name']}.json").is_file()
    for m in b["per_layer"]:        # its own reader, or the one of its name up to the first dot
        assert any((BENCH / "metrics" / f"{n}.py").is_file()
                   for n in (m["name"], m["name"].split(".")[0]))
    assert b["paths"] == ["radarbench"] and b["command"] == ["python3", "radarbench/run.py"]
