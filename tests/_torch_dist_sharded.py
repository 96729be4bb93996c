"""Rank work of tests/test_torch_sharded_map.py and
tests/test_torch_distributed.py, run on spawned gloo ranks.

As tests/_torch_dist.py: spawned ranks import the module of the function
they run, so it lives apart from the test files and imports torch and the
port and nothing of JAX. Its inputs come as numpy arrays, and it returns
numpy arrays (every rank the same results)."""

import numpy as np
import torch

from icp4dradar_tpu_torch.interop import config_from_dict, scans_from_numpy
from icp4dradar_tpu_torch.parallel import (
    load_distributed_state,
    make_mesh,
    ring_vgicp_align,
    ring_vgicp_normal_equations,
    run_scan_to_map_distributed,
    save_distributed_state,
    sharded_map_create,
    sharded_map_insert,
    sharded_map_rehash,
    sharded_sector_search_with_stats,
)
from icp4dradar_tpu_torch.parallel.sharded_map import forget_far, shard_local_maybe_rehash

TABLES = ("keys", "points", "intensity", "occupied", "stat_n", "stat_sum", "stat_sq")


def _np(x):
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_np(v) for v in x)
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def _t(x):
    return torch.from_numpy(np.asarray(x))


def tables(smap) -> dict:
    """The gathered (C, ...) tables of a sharded map, as numpy."""
    vm = smap.gather()
    return {k: _np(getattr(vm, k)) for k in TABLES}


def map_case(inp: dict) -> dict:
    """The sharded map and the ring VGICP on this rank's process group."""
    mesh = make_mesh(device_type="cpu")
    out = {}
    bat = {k: tuple(map(_t, v)) for k, v in inp["batches"].items()}

    def insert(sm, k):
        return sharded_map_insert(sm, mesh, *bat[k])

    def fresh():
        return sharded_map_create(mesh, capacity=1 << 12)

    # one insert, with a mask; a second; the sector query, every shard's
    # block in rank order; forget-far (elementwise on each shard), then the
    # distributed rehash, and its trigger below and above its fraction
    sm = insert(fresh(), "pts")
    out["insert"] = tables(sm)
    sm = insert(sm, "b")
    out["incremental"] = tables(sm)
    out["sector"] = _np(sharded_sector_search_with_stats(
        sm, mesh, torch.zeros(3), 30.0, torch.tensor(0.0), 180.0, 1024))
    out["num_voxels"] = float(sm.num_voxels)
    sm = forget_far(sm, torch.zeros(3), 12.0)
    out["forgotten"] = tables(sm)
    out["kept_below_trigger"] = shard_local_maybe_rehash(sm, 0.99).local is sm.local
    out["rehash"] = tables(sharded_map_rehash(sm, mesh))
    out["maybe_rehash"] = tables(shard_local_maybe_rehash(sm, 0.01))
    try:
        sharded_map_create(mesh, capacity=3)
    except ValueError:
        out["capacity_mod_n_raises"] = True
    r = inp["ring"]
    args = [_t(r[k]) for k in ("src", "smask", "scov", "tgt", "tcov", "tmask")]
    out["ring_ne"] = _np(ring_vgicp_normal_equations(_t(r["T"]), *args, mesh))
    try:
        ring_vgicp_normal_equations(_t(r["T"]), *args[:3], args[3][:9], args[4][:9],
                                    args[5][:9], mesh)
    except ValueError:
        out["rows_mod_n_raises"] = True
    a = inp["align"]
    out["ring_align"] = _np(ring_vgicp_align(*[_t(a[k]) for k in (
        "src", "smask", "scov", "tgt", "tcov", "tmask")], mesh))
    return out


def pipeline_case(inp: dict) -> dict:
    """The distributed pipeline, its checkpoints and the multihost run's
    reference on this rank's process group."""
    mesh = make_mesh(device_type="cpu")
    out = {}
    cfg = config_from_dict(inp["cfg"])
    scans = scans_from_numpy(inp["scans"], device="cpu")
    priors = _t(inp["priors"])
    U = _t(inp["uniforms"])

    # per-frame with IMU-style priors; the checkpoint split of the same run
    # at frame `split`: saved, loaded, continued with the rest of the draws
    vm, o = run_scan_to_map_distributed(scans, mesh, cfg, priors=priors)
    out["prior"] = _np(o)
    out["prior_map"] = tables(vm)
    s = inp["split"]
    vm_a, o_a = run_scan_to_map_distributed(scans[:s], mesh, cfg, priors=priors[:s],
                                            uniforms=U[:s])
    save_distributed_state(inp["port_ckpt"], vm_a, o_a["world_T"][-1], frame=s)
    vm_r, pose_r, frame_r = load_distributed_state(inp["port_ckpt"], mesh)
    out["resume_frame"] = frame_r
    out["saved_map"], out["loaded_map"] = tables(vm_a), tables(vm_r)
    _, o_b = run_scan_to_map_distributed(scans[s:], mesh, cfg, priors=priors[s:],
                                         uniforms=U[s:], init_map=vm_r, init_pose=pose_r)
    out["resumed"] = _np(o_b)
    jm, jpose, jframe = load_distributed_state(inp["jax_ckpt"], mesh)
    out["jax_ckpt"] = (tables(jm), _np(jpose), jframe)

    # blocked: block 4, cv-rot, forget and the distributed rehash on
    bcfg = config_from_dict(inp["blocked_cfg"])
    vm, o = run_scan_to_map_distributed(scans, mesh, bcfg, block=4,
                                        use_const_velocity_rot=True)
    out["blocked"] = _np(o)
    out["blocked_map"] = tables(vm)
    for name, kw in (("no_vgicp", {"gicp.use_vgicp": False}),
                     ("capacity", {"voxel_map.capacity": (1 << 12) + 1})):
        try:
            run_scan_to_map_distributed(scans, mesh, cfg.override(**kw))
        except ValueError:
            out[f"{name}_raises"] = True
    try:
        run_scan_to_map_distributed(scans, mesh, cfg, block=3)
    except ValueError:
        out["block_raises"] = True

    # the multihost launcher's run on the same scans, at this world size
    mh = inp["multihost"]
    _, o = run_scan_to_map_distributed(scans_from_numpy(mh["scans"], device="cpu"), mesh,
                                       config_from_dict(mh["cfg"]))
    out["multihost_ref"] = _np(o["world_T"])
    return out


def cli_direct(inp: dict) -> dict:
    """`run_scan_to_map_distributed` on the CLI's scans and flags, as a
    user calls it: the CLI's `--distributed` run must give these poses."""
    mesh = make_mesh(device_type="cpu")
    _, o = run_scan_to_map_distributed(
        scans_from_numpy(inp["scans"], device="cpu"), mesh, config_from_dict(inp["cfg"]),
        block=inp["block"], use_const_velocity_rot=True)
    return _np(o)
