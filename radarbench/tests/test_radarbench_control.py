"""The control, on the card: the plain reference computed one precision
below the float32 the configurations state (TF32 library products) in the
program's place must come out not correct against each cell's limits. At a
size a test run holds: 1024-row scans, short sequences, few streams; the
readings at the cells' own sizes are `calibrate.py --control`'s."""

import pytest
import torch

from conftest import BENCH, tiny_copy
from radarbench.harness import Registry
from radarbench.compare import all_pass


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["fleet-dense4096", "s2s-dense4096"])
def test_tf32_control_is_not_correct(tmp_path, benchmark_json, cuda_device, cell):
    reg = Registry(tiny_copy(tmp_path / "bench", streams=4, frames=64, max_points=1024),
                   benchmark_json)
    wl = reg.workload(cell)
    cfg, traffic = reg.config(wl["config"]), reg.traffic(wl["traffic"])
    lim = Registry(BENCH, benchmark_json).limits(cell)      # the cell's own limits
    torch.backends.cuda.matmul.allow_tf32 = False
    drv = reg.driver(traffic["driver"]).Driver(cfg, traffic, 31, cuda_device, 6.0)
    drv.setup()
    drv.window(6.0, None)
    drv.release()
    # the gaps to the reference: the track's own limit is for 4096-row scans
    def gaps(checks):
        return [c for c in checks if c["name"] != "track_rpe_m"]

    assert all_pass(gaps(drv.check(lim)))                   # the program, sound
    assert not all_pass(gaps(drv.check(lim, control=True))) # the control
