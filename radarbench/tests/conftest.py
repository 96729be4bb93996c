"""Fixtures of the benchmark's own tests: a tiny copy of the benchmark (the
same drivers, metrics and references; tiny configurations and traffic) that
runs on the CPU. Tests that need the card carry the `gpu` marker and skip
where there is none (decided inside the test, never at import)."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

BENCH = ROOT / "radarbench"


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA device; skips without one")


def tiny_copy(dst: Path, streams=4, frames=24, max_points=256) -> Path:
    """The benchmark's folder copied to `dst` with every configuration and
    traffic mix cut to a CPU test's size."""
    shutil.copytree(BENCH, dst, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for f in (dst / "configs").glob("*.json"):
        c = json.loads(f.read_text())
        c["sequence"].update(max_points=max_points, num_landmarks=1500)
        c["pipeline"].update(max_points=max_points)
        c["pipeline"]["voxel_map"].update(capacity=1 << 12, submap_max_points=1 << 10)
        f.write_text(json.dumps(c))
    for f in (dst / "traffic").glob("*.json"):
        t = json.loads(f.read_text())
        t.update(frames=40) if t["driver"] == "s2s" else t.update(streams=streams, frames=frames)
        f.write_text(json.dumps(t))
    # the gaps to the reference keep the cells' limits; a track of 256-row
    # scans follows the ground truth less closely than one of 4096 rows
    for f in (dst / "limits").glob("*.json"):
        lim = json.loads(f.read_text())
        lim["track_rpe_m"] = TINY_TRACK_RPE_M
        f.write_text(json.dumps(lim))
    return dst


# what tracks of the tiny copy's scans read against their ground truth: up
# to 0.55 m (0.035 and 0.067 m at the cells' 4096 rows)
TINY_TRACK_RPE_M = 0.9


@pytest.fixture
def benchmark_json():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.fixture
def tiny(tmp_path, benchmark_json):
    from radarbench.harness import Registry

    return Registry(tiny_copy(tmp_path / "bench"), benchmark_json)


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
