"""The port stands alone: no source of `icp4dradar_tpu_torch` (or
`chip_smoke.py`) imports jax, flax or the JAX package, and running its
slices (scan-to-scan, the blocked VGICP tracker, the kNN-GICP tracker,
scan accumulation and the rigid block union, the roofline module, a
streaming session, the pose-graph pipeline, the distributed pipeline in a
world of one, the host side: a bag through
the native streamer with IMU priors, the replay, PCD and the native .bin
loader) leaves them out of sys.modules. Its native libraries build under
`build/`, never beside their sources, and it exports the JAX package's
public names of `io`, `utils`, `preprocess`, `models`, `parallel`, `ops`
(three oracles under the port's names), `geom`, `graph`, `mapping` and
`registration`."""

import pathlib
import re
import subprocess
import sys

import pytest

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
from icp4dradar_tpu_torch import (geom, interop, io, mapping, ops, preprocess,
                                  registration, utils)
from icp4dradar_tpu_torch.registration import vgicp
from icp4dradar_tpu_torch.models import (run_odometry, run_scan_to_scan, run_scan_to_map,
                                         run_scan_to_map_blocked, scan_to_map)
from icp4dradar_tpu_torch.io import SyntheticSequence, stack_scans
seq = SyntheticSequence(num_frames=3, max_points=64, num_landmarks=2000, seed=1)
scans = stack_scans([seq.scan(k) for k in range(3)])
out = run_scan_to_scan(scans, icp4dradar_tpu_torch.PipelineConfig(),
                       use_doppler_prior=True)
assert torch.isfinite(out.world_T).all()
seq = SyntheticSequence(num_frames=8, max_points=128, num_landmarks=2000, seed=1)
scans = stack_scans([seq.scan(k) for k in range(8)])
cfg = icp4dradar_tpu_torch.PipelineConfig().override(
    **{"voxel_map.capacity": 1 << 12, "voxel_map.submap_max_points": 1 << 10})
_, out = run_scan_to_map_blocked(scans, cfg, block=4, use_const_velocity_rot=True)
assert torch.isfinite(out.world_T).all() and out.world_T.shape == (8, 4, 4)
_, out = run_scan_to_map(scans[:4], cfg.override(**{"gicp.use_vgicp": False}))
assert torch.isfinite(out.world_T).all() and out.world_T.shape == (4, 4, 4)
_, out = run_scan_to_map(scans[:4], cfg.override(accumulate_scans=2))
assert torch.isfinite(out.world_T).all()
_, out = run_scan_to_map_blocked(scans, cfg, block=4, use_const_velocity_rot=True,
                                 rigid_union=True)
assert torch.isfinite(out.world_T).all() and out.world_T.shape == (8, 4, 4)
from icp4dradar_tpu_torch.utils import cache, roofline
assert roofline.vgicp_sweep_bound(8, 2048, [801]).bound()[1] == 'operations'
assert cache.setup_compilation_cache() == ''
from icp4dradar_tpu_torch.models import local_map, streaming, submap
from icp4dradar_tpu_torch.utils import checkpoint
sess = streaming.OdometrySession(cfg, device="cpu")
for k in range(3):
    sess.process(scans[k])
assert sess.frame == 3 and bool(torch.isfinite(torch.as_tensor(sess.pose)).all())
from icp4dradar_tpu_torch import graph, parallel
from icp4dradar_tpu_torch.parallel import (distributed_pipeline, dryrun, multihost, ring_vgicp,
                                           sharded_map)
# the multi-process entry point without a launcher: a world of one (gloo)
_, dout = multihost.run_scan_to_map_multihost(scans, cfg, block=4, device='cpu')
assert torch.isfinite(dout['world_T']).all() and dout['world_T'].shape == (8, 4, 4)
from icp4dradar_tpu_torch.models import run_pose_graph_odometry
res = run_pose_graph_odometry(scans, cfg, keyframe_every=2, loop_radius=0.01)
assert res.poses.shape == (8, 4, 4) and res.num_loop_closures == 0
import os, tempfile
from icp4dradar_tpu_torch.io import (BinSequenceDataset, PcdSequenceDataset, RadarBagDataset,
                                     write_pcd, write_radar_bin, write_synthetic_bag)
from icp4dradar_tpu_torch.models import run_scan_to_scan_replay
from icp4dradar_tpu_torch.preprocess import imu_prior_deltas
from icp4dradar_tpu_torch.utils import checked, export_map_ply, profile_trace
d = tempfile.mkdtemp()
write_synthetic_bag(os.path.join(d, 'a.bag'), seq, compression='bz2')
ds = RadarBagDataset(os.path.join(d, 'a.bag'), '/radar', '/gt', '/imu', max_points=128,
                     use_native=True)
assert ds.native_used and len(ds) == 8
_, out = run_scan_to_map(ds.stacked_scans(), cfg,
                         prior_deltas=torch.from_numpy(imu_prior_deltas(ds.frames)))
assert torch.isfinite(out.world_T).all()
rep = run_scan_to_scan_replay(scans, out.world_T, icp4dradar_tpu_torch.PipelineConfig())
assert torch.isfinite(rep.world_T).all()
write_pcd(os.path.join(d, 'pcd', '00000.pcd'), {'x': [1.0], 'y': [2.0], 'z': [3.0]})
assert len(PcdSequenceDataset(d)) == 1
write_radar_bin(os.path.join(d, 'data', 'radar_pointcloud_0.bin'), scans[0].to_numpy_valid())
assert BinSequenceDataset(d, max_points=128).native_used
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'icp4dradar_tpu'))
print('LOADED', bad)
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "LOADED []" in proc.stdout, proc.stdout


def test_native_libraries_build_under_build_dir():
    """g++ writes the native libraries into build/icp4dradar_tpu_torch/native/
    (gitignored), named by a hash of the source and flags, and nothing into
    the package."""
    from icp4dradar_tpu_torch.native import bagloader, loader

    libs = [loader.build_native(), bagloader.build_native()]
    build = REPO / "build" / "icp4dradar_tpu_torch" / "native"
    assert loader.BUILD_DIR == build
    for lib, name in zip(libs, ("radario", "bagio")):
        path = pathlib.Path(lib)
        assert path.parent == build and path.is_file()
        assert re.fullmatch(rf"lib{name}-[0-9a-f]{{16}}\.so", path.name), path.name
    assert loader.build_native() == libs[0]          # cached: no rebuild
    assert not list((REPO / "icp4dradar_tpu_torch").rglob("*.so"))


# `parallel` names not ported yet: none since the sharded map, the ring
# VGICP, the distributed pipeline and the multi-process runtime (ROADMAP.md
# queue 1 items 6b and 6c)
PARALLEL_NOT_YET = []


def test_port_exports_the_jax_public_names():
    """Every public name of the JAX package's `io`, `utils`, `preprocess`,
    `models` and `parallel` (its 25) is exported by the port's; the names
    are read from the sources, so no jax is imported."""
    import ast
    import importlib

    for sub in ("io", "utils", "preprocess", "models", "parallel"):
        tree = ast.parse((REPO / "icp4dradar_tpu" / sub / "__init__.py").read_text())
        names = {a.asname or a.name for node in ast.walk(tree)
                 if isinstance(node, ast.ImportFrom) for a in node.names}
        port = importlib.import_module(f"icp4dradar_tpu_torch.{sub}")
        missing = sorted(n for n in names if not hasattr(port, n))
        assert missing == (PARALLEL_NOT_YET if sub == "parallel" else []), (sub, missing)
        if sub == "parallel":
            assert len(names) == 25


# The JAX package's `ops` oracles the port names otherwise: the Pallas
# kernels' wrappers are the port's CUDA wrappers (on targets packed once,
# `nn_prepare`), the XLA oracle its plain version
OPS_RENAMED = {"nearest_neighbor_pallas": "nn_search",
               "nearest_neighbor_coords_pallas": "nn_search_coords",
               "nearest_neighbor_xla": "nearest_neighbor_plain"}


@pytest.mark.parametrize("sub", ["ops", "geom", "graph", "mapping", "registration"])
def test_port_exports_the_jax_public_names_of(sub):
    """Every public name of the JAX package's `sub` is exported by the
    port's `sub`, under its own name or, for `ops`, under the name
    `OPS_RENAMED` gives it; any other missing name fails."""
    import ast
    import importlib

    tree = ast.parse((REPO / "icp4dradar_tpu" / sub / "__init__.py").read_text())
    names = {a.asname or a.name for node in ast.walk(tree)
             if isinstance(node, ast.ImportFrom) for a in node.names}
    assert names
    port = importlib.import_module(f"icp4dradar_tpu_torch.{sub}")
    renamed = OPS_RENAMED if sub == "ops" else {}
    missing = sorted(n for n in names if not hasattr(port, renamed.get(n, n)))
    assert missing == [], (sub, missing)
    assert set(renamed) <= names
