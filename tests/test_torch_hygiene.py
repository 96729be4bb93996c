"""The port stands alone: no source of `icp4dradar_tpu_torch` (or
`chip_smoke.py`) imports jax, flax or the JAX package, and running the whole
slice leaves them out of sys.modules."""

import pathlib
import re
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|flax|icp4dradar_tpu)\b(?!_)", re.M)


def test_port_sources_import_no_jax():
    files = sorted((REPO / "icp4dradar_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    offenders = {str(f.relative_to(REPO)): FORBIDDEN.findall(f.read_text())
                 for f in files}
    assert {f: m for f, m in offenders.items() if m} == {}


def test_forbidden_pattern_catches_jax_imports():
    for bad in ("import jax", "from jax import numpy", "import flax.struct",
                "from icp4dradar_tpu.geom import se3_exp", "import icp4dradar_tpu"):
        assert FORBIDDEN.search(bad), bad
    for ok in ("import icp4dradar_tpu_torch", "from icp4dradar_tpu_torch.io import x",
               "import jaxtyping", "# jax is never imported here"):
        assert not FORBIDDEN.search(ok), ok


def test_slice_runs_without_jax_in_a_fresh_process():
    code = """
import sys
import torch
import icp4dradar_tpu_torch
from icp4dradar_tpu_torch import geom, interop, io, ops, preprocess, registration, utils
from icp4dradar_tpu_torch.models import run_odometry, run_scan_to_scan
from icp4dradar_tpu_torch.io import SyntheticSequence, stack_scans
seq = SyntheticSequence(num_frames=3, max_points=64, num_landmarks=2000, seed=1)
scans = stack_scans([seq.scan(k) for k in range(3)])
out = run_scan_to_scan(scans, icp4dradar_tpu_torch.PipelineConfig(),
                       use_doppler_prior=True)
assert torch.isfinite(out.world_T).all()
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'icp4dradar_tpu'))
print('LOADED', bad)
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "LOADED []" in proc.stdout, proc.stdout
