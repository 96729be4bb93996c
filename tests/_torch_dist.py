"""Rank work of tests/test_torch_parallel.py, run on spawned gloo ranks.

Spawned ranks import the module of the function they run, so it lives
here, apart from the test file: this module imports torch and the port and
nothing of JAX (tests/conftest.py, which imports JAX and pins its virtual
devices, is never loaded by the ranks). Its inputs come from the test as
numpy arrays, and it returns numpy arrays."""

import numpy as np
import torch
import torch.distributed as dist

from icp4dradar_tpu_torch.config import PoseGraphConfig
from icp4dradar_tpu_torch.interop import config_from_dict, pose_graph_from_numpy, scans_from_numpy
from icp4dradar_tpu_torch.models import run_pose_graph_odometry
from icp4dradar_tpu_torch.parallel import (
    batched_icp_pairs,
    batched_preprocess,
    device_count,
    distributed_block_normal_equations,
    distributed_normal_equations,
    distributed_optimize_pose_graph,
    distributed_optimize_pose_graph_block,
    make_mesh,
    pad_factors_for_mesh,
    shard_scan_batch,
    sharded_scan_to_map_batch,
)
from icp4dradar_tpu_torch.parallel.dryrun import _dryrun_rank
from icp4dradar_tpu_torch.utils import threefry

FACTORS = ("rel", "points", "lines", "planes", "planes3")


def _np(x):
    return x.detach().cpu().numpy()


def graph_arrays(graph):
    """A port PoseGraph as the numpy dict `pose_graph_from_numpy` reads."""
    out = {"poses": _np(graph.poses)}
    for name in FACTORS:
        fac = getattr(graph, name)
        if fac is not None:
            out[name] = {k: _np(v) for k, v in vars(fac).items()}
    return out


def parallel_case(inp: dict) -> dict:
    """Every `parallel` name, `run_pose_graph_odometry(mesh=...)` and the
    dry run's stages on this rank's process group; every result as numpy
    (the same on every rank)."""
    n = dist.get_world_size()
    mesh = make_mesh(device_type="cpu")
    out = {"world": n, "device_count": device_count(), "mesh_shape": tuple(mesh.shape)}
    try:
        make_mesh(n, ("dp", "map"), device_type="cpu")
    except ValueError:
        out["multi_axis_needs_shape"] = True
    cfg = config_from_dict(inp["cfg"])
    pg_cfg = PoseGraphConfig(**inp["pg_cfg"])

    scans = shard_scan_batch(scans_from_numpy(inp["scans"], device="cpu"), mesh)
    est = batched_preprocess(scans, threefry.key(0), mesh, cfg)
    out["reve"] = {k: _np(getattr(est, k)) for k in ("velocity", "sigma", "inlier_mask",
                                                     "valid")}
    src = shard_scan_batch(scans_from_numpy(inp["src"], device="cpu"), mesh)
    tgt = shard_scan_batch(scans_from_numpy(inp["tgt"], device="cpu"), mesh)
    out["icp"] = _np(batched_icp_pairs(src, tgt, mesh, cfg))

    streams = scans_from_numpy(inp["streams"], device="cpu")
    st, so = sharded_scan_to_map_batch(streams, mesh, cfg, block=inp["block"],
                                       use_const_velocity_rot=True)
    out["s2m"] = {k: _np(v) for k, v in vars(so).items()}
    out["s2m_world_T"] = _np(st.world_T)
    out["s2m_tables"] = [_np(t) for t in st.vmap.tables()]
    if n > 1:
        try:
            sharded_scan_to_map_batch(streams[:1], mesh, cfg, block=inp["block"])
        except ValueError:
            out["batch_mod_n_raises"] = True

    graph = pose_graph_from_numpy(inp["graph"], device="cpu")
    out["padded"] = graph_arrays(pad_factors_for_mesh(graph, 3))
    out["dense_ne"] = [_np(x) for x in distributed_normal_equations(graph, mesh, pg_cfg)]
    gd, cd = distributed_optimize_pose_graph(graph, mesh, pg_cfg)
    out["dense_opt"] = (_np(gd.poses), _np(cd))
    out["block_ne"] = [_np(x) for x in distributed_block_normal_equations(graph, mesh, pg_cfg)]
    gb, cb = distributed_optimize_pose_graph_block(graph, mesh, pg_cfg)
    out["block_opt"] = (_np(gb.poses), _np(cb))
    out["block_rel_kept"] = gb.rel is graph.rel
    out["chains"] = [_np(distributed_optimize_pose_graph_block(
        pose_graph_from_numpy(c, device="cpu"), mesh, PoseGraphConfig(max_iterations=10))[0].poses)
        for c in inp["chains"]]

    circle = inp["circle"]
    res = run_pose_graph_odometry(scans_from_numpy(circle["scans"], device="cpu"),
                                  config_from_dict(circle["cfg"]),
                                  uniforms=torch.from_numpy(circle["uniforms"]), mesh=mesh,
                                  **circle["kw"])
    out["pipeline"] = dict(poses=res.poses, odom_poses=res.odom_poses,
                           closures=res.num_loop_closures,
                           keyframes=np.asarray(res.keyframe_indices))
    out["dryrun"] = _dryrun_rank("cpu")
    return out
