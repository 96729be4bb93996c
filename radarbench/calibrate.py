"""Readings for the limits of a cell's compared numbers, on the card:

    python3 radarbench/calibrate.py --workload <name> --seeds 1,2,3 --seconds 10 [--control]

For each seed, in one process: the cell's set-up and a window of
`--seconds`, then each compared number against the float32 reference (the
sound reading) and, with `--control`, against the reference computed with
TF32 library products (the control, one precision below the float32 the
configurations state). One JSON line a seed."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)

    import torch

    from radarbench.harness import Registry

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    reg = Registry.from_root()
    wl = reg.workload(args.workload)
    cfg, traffic = reg.config(wl["config"]), reg.traffic(wl["traffic"])
    lim = reg.limits(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        drv = reg.driver(traffic["driver"]).Driver(cfg, traffic, seed, device, args.seconds)
        drv.setup()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        win = drv.window(args.seconds, None)
        peak = torch.cuda.max_memory_allocated(device)
        drv.release()
        torch.cuda.empty_cache()
        t2 = time.perf_counter()
        sound = {c["name"]: c["value"] for c in drv.check(lim)}
        t3 = time.perf_counter()
        row = {"workload": args.workload, "seed": seed, "setup_s": t1 - t0,
               "metrics": win.metrics, "attempted": win.attempted, "failed": win.failed,
               "memory_peak_bytes": peak, "reference_s": t3 - t2, "sound": sound}
        if args.control:
            row["control"] = {c["name"]: c["value"] for c in drv.check(lim, control=True)}
        print(json.dumps(row), flush=True)
        del drv
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    if sys.path[1:2] == [os.path.dirname(os.path.abspath(__file__))]:
        del sys.path[1]
    raise SystemExit(main(sys.argv[1:]))
