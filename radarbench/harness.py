"""One run of one cell of the benchmark (`radarbench/run.py`).

Everything a cell is made of is found by name: the cell in
`BENCHMARK.json`, its configuration in `configs/<name>.json`, its traffic
mix in `traffic/<name>.json`, the loop that drives the mix in
`drivers/<traffic's driver>.py`, the limits of its compared numbers in
`limits/<cell name>.json`, and each per-layer metric in
`metrics/<metric name>.py`, or in `metrics/<the name up to its first
dot>.py` where one reader serves names that differ by a suffix only
(`gn_share.fleet` and a later `gn_share.live`). Adding any of them is
adding files and an entry.

A run: set-up (inputs made on the card from the seed, every shape the
cell's traffic uses warmed), the measured window, the device peak read,
the program's state freed, the plain reference over the compared answers,
the per-layer readers, then the check that nothing of JAX was loaded, and
only then the result line.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import re
import resource
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent

# top-level module names a run may not load: JAX and the JAX package
FORBIDDEN_MODULES = frozenset({"jax", "jaxlib", "flax", "icp4dradar_tpu"})


def forbidden_modules(names=None) -> list:
    """The forbidden top-level names among loaded modules (or `names`),
    compared whole: `icp4dradar_tpu_torch` is not `icp4dradar_tpu`."""
    names = sys.modules.keys() if names is None else names
    return sorted({n.split(".")[0] for n in names} & FORBIDDEN_MODULES)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Registry:
    """Finds a benchmark's parts by name under `bench_dir`, with the cell
    and metric entries of `benchmark` (the parsed BENCHMARK.json)."""

    def __init__(self, bench_dir: Path, benchmark: dict):
        self.dir = Path(bench_dir)
        self.benchmark = benchmark

    @classmethod
    def from_root(cls, root: Path = ROOT, bench_dir: Path = BENCH_DIR) -> "Registry":
        with open(Path(root) / "BENCHMARK.json") as f:
            return cls(bench_dir, json.load(f))

    def workload(self, name: str) -> dict:
        for w in self.benchmark["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def _json(self, kind: str, name: str) -> dict:
        with open(self.dir / kind / f"{name}.json") as f:
            return json.load(f)

    def config(self, name: str) -> dict:
        return self._json("configs", name)

    def traffic(self, name: str) -> dict:
        return self._json("traffic", name)

    def driver(self, kind: str):
        return load_module(self.dir / "drivers" / f"{kind}.py", f"radarbench_driver_{kind}")

    def limits(self, workload: str) -> dict:
        return self._json("limits", workload)

    def metric(self, name: str):
        """The reader of the per-layer metric `name`: `metrics/<name>.py`,
        else `metrics/<name up to its first dot>.py`."""
        path = self.dir / "metrics" / f"{name}.py"
        if not path.is_file():
            path = self.dir / "metrics" / f"{name.split('.')[0]}.py"
        return load_module(path, "radarbench_metric_" + re.sub(r"\W", "_", name))

    def metrics_for(self, section: str, workload: str) -> list:
        """The `end_to_end` or `per_layer` entries a cell reports."""
        return [m for m in self.benchmark[section]
                if "workloads" not in m or workload in m["workloads"]]


@dataclass
class Window:
    """What a driver's measured window gives the harness."""

    metrics: dict                       # end-to-end metric name -> value
    attempted: int
    failed: int
    counters: dict = field(default_factory=dict)   # for the per-layer readers


@dataclass
class Run:
    """What a per-layer metric's reader reads: the device trace of the
    profiled units (None without `--trace 1`) and the driver's counters."""

    trace: Optional[object]
    counters: dict


def host_sample() -> dict:
    """The host's state for the diagnostics line: wall clock, this process's
    CPU seconds and involuntary context switches, the machine's stolen and
    total CPU ticks (Linux `/proc/stat`), and the time a fixed piece of
    plain Python takes (the host's speed at that moment)."""
    t = time.perf_counter()
    x = 0
    for i in range(200_000):
        x += i & 7
    probe = time.perf_counter() - t
    ru = resource.getrusage(resource.RUSAGE_SELF)
    steal = total = 0
    try:
        with open("/proc/stat") as f:
            ticks = [int(v) for v in f.readline().split()[1:]]
        steal, total = (ticks[7] if len(ticks) > 7 else 0), sum(ticks)
    except OSError:
        pass
    return {"t": time.perf_counter(), "cpu": ru.ru_utime + ru.ru_stime, "nivcsw": ru.ru_nivcsw,
            "steal": steal, "ticks": total, "probe_ms": 1e3 * probe}


def host_line(a: dict, b: dict) -> str:
    """What the host did between two `host_sample`s."""
    wall = b["t"] - a["t"]
    ticks = max(b["ticks"] - a["ticks"], 1)
    load = os.getloadavg() if hasattr(os, "getloadavg") else (math.nan,) * 3
    return (f"host: window {wall:.3f} s, process cpu {b['cpu'] - a['cpu']:.3f} s, "
            f"involuntary switches {b['nivcsw'] - a['nivcsw']}, stolen "
            f"{100.0 * (b['steal'] - a['steal']) / ticks:.3f}% of the machine's cpu, "
            f"probe {a['probe_ms']:.3f} / {b['probe_ms']:.3f} ms, "
            f"loadavg {load[0]:.2f} {load[1]:.2f} {load[2]:.2f}")


def _forbidden(log) -> bool:
    bad = forbidden_modules()
    if bad:
        log(f"forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
    return bool(bad)


def run_cell(reg: Registry, workload: str, seed: int, seconds: float, trace: bool,
             device, t_start: float, log=print) -> Optional[dict]:
    """Set up, measure and check one cell on `device`; returns the result
    (with `checks` last), or None when a forbidden module was loaded."""
    import torch

    from radarbench.trace import Tracer

    wl = reg.workload(workload)
    cfg, traffic = reg.config(wl["config"]), reg.traffic(wl["traffic"])
    drv = reg.driver(traffic["driver"]).Driver(cfg, traffic, seed, device, seconds)
    t_drv = time.perf_counter()
    drv.setup()
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    log(f"setup {setup_s:.3f} s (the driver's inputs and warm-up "
        f"{time.perf_counter() - t_drv:.3f} s)", file=sys.stderr)

    tracer = None
    if trace:
        tracer = Tracer(device)
        t_warm = time.perf_counter()
        tracer.warm()
        log(f"profiler start {time.perf_counter() - t_warm:.3f} s", file=sys.stderr)
    h0 = host_sample()
    win = drv.window(seconds, tracer)
    h1 = host_sample()
    log(host_line(h0, h1), file=sys.stderr)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if _forbidden(log):
        return None
    drv.release()
    if cuda:
        torch.cuda.empty_cache()
    checks = drv.check(reg.limits(workload))

    metrics = {}
    if trace:
        run = Run(tracer.trace, win.counters)
        for m in reg.metrics_for("per_layer", workload):
            value = reg.metric(m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(win.metrics, setup_s=setup_s)
        for m in reg.metrics_for("end_to_end", workload):
            v = values[m["name"]]
            if v is None or not math.isfinite(v):
                raise RuntimeError(f"{m['name']} not measured: {v} (no whole unit in the window?)")
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    from radarbench.compare import all_pass

    # after the reference and every reader has loaded what it needs
    if _forbidden(log):
        return None
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": wl["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": all_pass(checks), "attempted": win.attempted, "failed": win.failed,
              "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = tracer.trace.busy_s
        dev["window_s"] = tracer.trace.window_s
        result["breakdown"] = tracer.trace.breakdown()
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    return result


def _json_number(x):
    return x if isinstance(x, (int, bool)) or (isinstance(x, float) and math.isfinite(x)) \
        else str(x)


def main(argv, t_start: float) -> int:
    ap = argparse.ArgumentParser(description="Run one cell of the benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    reg = Registry.from_root()
    wl = reg.workload(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        print(f"{args.workload} needs {wl['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    # float32 as the configurations state it: no TF32 in library products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # one process, one host thread for the port's CPU operations: the host
    # paces these cells, so nothing of the run competes with its main thread
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.zeros(1, device=device)
    print(f"torch imported and the device up {time.perf_counter() - t_start:.3f} s",
          file=sys.stderr)
    result = run_cell(reg, args.workload, args.seed, args.seconds, bool(args.trace), device,
                      t_start)
    if result is None:
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    result["checks"] = {k: {kk: _json_number(vv) for kk, vv in v.items()}
                        for k, v in result["checks"].items()}
    print(json.dumps(result))
    return 0
