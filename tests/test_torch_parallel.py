"""The port's multi-device layer (`icp4dradar_tpu_torch.parallel`) on gloo
ranks on the CPU, against the JAX package (its `parallel` on a 2-device
mesh of the 8 virtual CPU devices, or the per-device bodies of its sharded
programs) and against the port's single-device functions, on the same
numpy inputs.

One module fixture spawns the rank work of `tests/_torch_dist.py` twice,
at world sizes 1 and 2, and computes the JAX references meanwhile (two
spawned processes and its own); every case below reads its results.
Scenes: REVE and pairwise ICP over 4 frames of 256 points; two streams of
8 frames of 512 points through the blocked scan-to-map batch (block 4,
VGICP);
a K = 12 pose graph with every factor type; four K = 24 loop chains from
perturbed starts; `tests/test_torch_pose_graph.py`'s circle through
`run_pose_graph_odometry(mesh=...)`; the dry run's stages.

What is held to JAX where. Every name, the pipeline with a mesh and the
dry run's stages are held to the JAX package at world size 2 (the pipeline
at world size 1 too). The five pose-graph names
(`pad_factors_for_mesh`, both distributed assemblies, the dry run's
included, and both distributed optimisers) and `run_pose_graph_odometry`
are compared with JAX's on a 2-device mesh (`make_mesh(2)`, or its layout
over devices 2 and 3). The data-parallel functions are
compared with the JAX package's per-device bodies: its shard_map of each is
a jax.vmap of the per-item function, so the vmap over all items (REVE over
split(key, F), ICP over the pairs, `run_scan_to_map_blocked` over
split(key(seed), B)) gives each item's result without compiling the
sharded programs (20-110 s each on this CPU); the Threefry draws the ranks
make are held to jax.random's at these shapes. The data-parallel functions
and the pipeline are also held to the port's single-device functions.

Tolerances:
- across world sizes and against the single-device functions: REVE, ICP
  and the scan-to-map batch bit for bit (each frame or stream is computed
  alone, its draws indexed globally); the normal equations within 1e-5 of
  their largest entry (the ranks' partial sums add in another order),
  optimised poses within 1e-4 m and cost rtol 1e-4, as
  tests/test_torch_graph.py holds two solvers; the pipeline's odometry bit
  for bit, its refined poses within 1e-4 m;
- against JAX: padding exact, normal equations within 1e-5 of the largest
  entry, optimised poses within 1e-4 m and cost rtol 1e-4
  (tests/test_torch_graph.py's); REVE's masks and flags equal, velocity
  and sigma within 1e-5 of their largest entry (the LSQ solve's f32
  round-off, summed in another order), ICP within 1e-4
  (tests/test_torch_icp_moments.py),
  each stream of the scan-to-map batch as tests/test_torch_batch.py holds
  a stream (`_assert_tracks`), the pipeline as
  tests/test_torch_pose_graph.py holds it (keyframes equal, closures
  within one, ATE within 5e-3 m and 0.05 m)."""

import functools
import multiprocessing
import threading
from concurrent.futures import ProcessPoolExecutor
from types import SimpleNamespace

import jax
import jax.numpy as jnp
from jax.sharding import Mesh
import numpy as np
import pytest
import torch

from icp4dradar_tpu import graph as jg
from icp4dradar_tpu import parallel as jpar
from icp4dradar_tpu.config import PipelineConfig as JaxConfig
from icp4dradar_tpu.config import PoseGraphConfig as JaxPoseGraphConfig
from icp4dradar_tpu.io import SyntheticSequence as JaxSequence
from icp4dradar_tpu.io.scan import stack_scans as jax_stack
from icp4dradar_tpu.models import run_pose_graph_odometry as jax_pipeline
from icp4dradar_tpu.models.scan_to_map import run_scan_to_map_blocked as j_blocked
from icp4dradar_tpu.preprocess.reve import estimate_ego_velocity as j_reve
from icp4dradar_tpu.registration.icp import icp_point_to_point as j_icp
from icp4dradar_tpu_torch import graph as pg
from icp4dradar_tpu_torch import parallel as ppar
from icp4dradar_tpu_torch.config import PoseGraphConfig
from icp4dradar_tpu_torch.interop import (
    SCAN_FIELDS,
    config_from_dict,
    pose_graph_from_numpy,
    scans_from_numpy,
)
from icp4dradar_tpu_torch.graph import solve_pose_graph_step
from icp4dradar_tpu_torch.io import SyntheticSequence
from icp4dradar_tpu_torch.io.scan import stack_scans
from icp4dradar_tpu_torch.models import run_pose_graph_odometry
from icp4dradar_tpu_torch.mapping import voxel_map_create, voxel_map_insert
from icp4dradar_tpu_torch.mapping.voxel_hash import voxel_map_sector_search_with_stats
from icp4dradar_tpu_torch.models import scan_to_map as pm
from icp4dradar_tpu_torch.ops import vgicp_fused as pv
from icp4dradar_tpu_torch.parallel.dryrun import run_on_ranks
from icp4dradar_tpu_torch.preprocess.reve import estimate_ego_velocity, reve_hypotheses
from icp4dradar_tpu_torch.registration.icp import icp_point_to_point
from icp4dradar_tpu_torch.utils import ate_rmse, doppler_uniforms, reve_batch_uniforms, threefry
from tests._torch_dist import FACTORS, parallel_case
from tests._torch_threads import one_torch_thread  # noqa: F401
from tests.test_torch_batch import _assert_tracks
from tests.test_torch_graph import loop_graph, single_pose_factors

CPU = torch.device("cpu")
N, NS, BLOCK, B, FS = 256, 512, 4, 2, 8
PG_KW = dict(keyframe_every=4, loop_radius=8.0, min_loop_gap=24)
_JAX_TYPES = {"rel": jg.RelPoseFactors, "points": jg.PointFactors, "lines": jg.LineFactors,
              "planes": jg.PlaneFactors, "planes3": jg.Plane3Factors}


def _jcfg():
    return JaxConfig().override(**{
        "voxel_map.capacity": 1 << 14, "voxel_map.submap_max_points": 1 << 12,
        "icp.max_iterations": 15, "gicp.max_iterations": 15})


def _scan_arrays(js):
    return {k: np.asarray(getattr(js, k)) for k in SCAN_FIELDS}


def _jax_graph(arrays):
    return jg.PoseGraph(poses=jnp.asarray(arrays["poses"]), **{
        name: _JAX_TYPES[name](**{f: jnp.asarray(v) for f, v in arrays[name].items()})
        for name in FACTORS if name in arrays})


def _inputs():
    jcfg = _jcfg()
    seq = JaxSequence(num_frames=2 * FS, max_points=N, num_landmarks=4000, world_extent=80.0,
                      max_range=60.0, dynamic_fraction=0.05, pos_noise=0.01, speed=1.0,
                      turn_rate=0.03, seed=0)
    frames = [seq.scan(k) for k in range(2 * FS)]
    # the streams at tests/test_torch_batch.py's 512 points: at 256 the
    # scene's tracks walk off (3.4 m of z on the first frame) and the
    # blocked runner's sequential re-track is chaotic there, so that JAX's
    # own eager, jitted and vmapped runs of one stream part by metres
    sseq = JaxSequence(num_frames=2 * FS, max_points=NS, num_landmarks=4000,
                       world_extent=80.0, max_range=60.0, dynamic_fraction=0.05,
                       pos_noise=0.01, speed=1.0, turn_rate=0.03, seed=0)
    sframes = [sseq.scan(k) for k in range(2 * FS)]
    js = {"scans": jax_stack(frames[:4]), "src": jax_stack(frames[1:5]),
          "tgt": jax_stack(frames[:4]),
          "streams": jax.tree.map(lambda *x: jnp.stack(x), jax_stack(sframes[:FS]),
                                  jax_stack(sframes[FS:]))}
    K = 12
    gt, poses, rel = loop_graph(K, 10.0, 2, 0.01, seed=3)
    graph = {"poses": poses, "rel": rel, **single_pose_factors(K, gt, 3, P=13, L=9, Q=7)}
    chains = [dict(zip(("gt", "poses", "rel"), loop_graph(24, 20.0, 3, 0.02, seed=s)))
              for s in range(4)]
    cseq = JaxSequence(num_frames=48, max_points=N, num_landmarks=600, world_extent=40.0,
                       max_range=35.0, speed=1.0, turn_rate=2 * np.pi / 48, pos_noise=0.02,
                       dynamic_fraction=0.05)
    ccfg = JaxConfig().override(**{"icp.max_iterations": 15, "pose_graph.max_iterations": 10})
    cjs = jax_stack([cseq.scan(k) for k in range(48)])
    inp = dict(cfg=jcfg.to_dict(), pg_cfg={"max_iterations": 10}, block=BLOCK,
               graph={"poses": poses, "rel": rel, **graph},
               chains=[{"poses": c["poses"], "rel": c["rel"]} for c in chains],
               circle=dict(scans=_scan_arrays(cjs), cfg=ccfg.to_dict(), kw=PG_KW,
                           uniforms=doppler_uniforms(ccfg.seed, 48,
                                                     ccfg.doppler.num_hypotheses)),
               **{k: _scan_arrays(v) for k, v in js.items()})
    gt = np.stack([np.linalg.inv(sseq.poses[k0]) @ sseq.poses[k0:k0 + FS] for k0 in (0, FS)])
    return inp, js, chains, (cseq, cjs, ccfg), gt


def _np_tree(x):
    return jax.tree.map(np.asarray, x)


def _jax_tasks(inp, js, circle, jmesh, jmesh23):
    """The JAX references, as three lists of (name, thunk), each list in a
    process of its own: programs on `make_mesh(2)` (devices 0 and 1), programs on the
    same layout over devices 2 and 3, and the vmapped per-device bodies (no
    collectives). Each thunk returns numpy."""
    jgraph = _jax_graph(inp["graph"])
    pcfg = JaxPoseGraphConfig(**inp["pg_cfg"])
    cfg = _jcfg()
    cseq, cjs, ccfg = circle

    def opt(fn, mesh):
        out, cost = fn(jgraph, mesh, pcfg)
        return np.asarray(out.poses), float(cost)

    def pipeline():
        r = jax_pipeline(cjs, ccfg, mesh=jmesh23, **PG_KW)
        return SimpleNamespace(keyframe_indices=np.asarray(r.keyframe_indices),
                               num_loop_closures=r.num_loop_closures,
                               odom_poses=np.asarray(r.odom_poses), poses=np.asarray(r.poses))

    def s2m():
        keys = jax.random.split(jax.random.key(cfg.seed), B)
        return _np_tree(jax.jit(jax.vmap(lambda s, k: j_blocked(
            s, cfg, key=k, block=BLOCK, use_const_velocity_rot=True)))(js["streams"], keys)[1])

    dcfg, dscans = _dryrun_inputs()
    head, tail = (jax.tree.map(lambda x, s=s: x[s], dscans) for s in (slice(4), slice(1, None)))
    def dryrun_pipeline():
        dseq = JaxSequence(num_frames=16, max_points=256, num_landmarks=1500,
                           world_extent=60.0, max_range=50.0, seed=7)
        out = jpar.run_scan_to_map_distributed(
            jax_stack([dseq.scan(k) for k in range(16)]), jmesh, _dryrun_pipeline_cfg(dcfg, 2),
            block=4, use_const_velocity_rot=True)[1]
        return _np_tree(out), np.asarray(dseq.poses[:16])

    mesh_tasks = [
        ("dryrun_pipeline", dryrun_pipeline),
        ("padded", lambda: _np_tree(jpar.pad_factors_for_mesh(jgraph, 3))),
        ("dense_ne", lambda: _np_tree(jpar.distributed_normal_equations(jgraph, jmesh, pcfg))),
        ("block_ne", lambda: _np_tree(jpar.distributed_block_normal_equations(jgraph, jmesh,
                                                                              pcfg))),
        ("dense_opt", lambda: opt(jpar.distributed_optimize_pose_graph, jmesh)),
    ]
    mesh23_tasks = [
        ("block_opt", lambda: opt(jpar.distributed_optimize_pose_graph_block, jmesh23)),
        ("pipeline", pipeline),
    ]
    vmap_tasks = [
        ("reve", lambda: _np_tree(_jax_reve(js["scans"], jax.random.split(jax.random.key(0), 4),
                                            cfg.reve))),
        ("icp", lambda: np.asarray(_jax_icp(js["src"], js["tgt"], cfg.icp))),
        ("s2m", s2m),
        ("dryrun_reve", lambda: _np_tree(_jax_reve(head, jax.random.split(jax.random.key(0), 4),
                                                   dcfg.reve))),
        ("dryrun_icp", lambda: np.asarray(_jax_icp(tail, head, dcfg.icp))),
    ]
    return mesh_tasks, mesh23_tasks, vmap_tasks


def _jax_meshes():
    return jpar.make_mesh(2), Mesh(np.asarray(jax.devices()[2:4]), ("dp",))


def _jax_references(group: int) -> dict:
    """The JAX references of `_jax_tasks`' list `group`, in a process of
    their own (tests/conftest.py's JAX_PLATFORMS and XLA_FLAGS reach it
    through the environment); the inputs are made anew from their seeds."""
    assert jax.default_backend() == "cpu" and len(jax.devices()) == 8
    inp, js, _, circle, _ = _inputs()
    return {name: thunk() for name, thunk in _jax_tasks(inp, js, circle, *_jax_meshes())[group]}


@pytest.fixture(scope="module")
def case():
    """The inputs, the JAX scans, the rank results at world sizes 1 and 2
    (a list of rank results each), and the JAX references (`jax`). The
    ranks and JAX run at once: the two lists of JAX's mesh programs each in
    a spawned process (XLA compiles a program on one core), the vmapped
    bodies here, while the ranks work."""
    inp, js, chains, circle, gt = _inputs()
    jmesh = _jax_meshes()[0]
    runs, errors = {}, []

    def run(n):
        try:
            runs[n] = run_on_ranks(parallel_case, n, inp)
        except Exception as e:                           # reported below
            errors.append(e)

    with ProcessPoolExecutor(2, mp_context=multiprocessing.get_context("spawn")) as pool:
        futures = [pool.submit(_jax_references, g) for g in (0, 1)]
        threads = [threading.Thread(target=run, args=(n,)) for n in (1, 2)]
        for t in threads:
            t.start()
        refs = {name: thunk() for name, thunk in _jax_tasks(inp, js, circle, *_jax_meshes())[2]}
        for t in threads:
            t.join()
        for f in futures:
            refs.update(f.result())
    if errors:
        raise errors[0]
    return dict(inp=inp, js=js, chains=chains, circle=circle, gt=gt, w1=runs[1], w2=runs[2],
                jax=refs, jmesh=jmesh)


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _close_to_largest(a, b, rel=1e-5):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, atol=rel * max(np.abs(b).max(), 1e-30))


def _walk(x, y, fn):
    if isinstance(x, dict):
        assert set(x) == set(y)
        for k in x:
            _walk(x[k], y[k], fn)
    elif isinstance(x, (list, tuple)):
        assert len(x) == len(y)
        for a, b in zip(x, y):
            _walk(a, b, fn)
    else:
        fn(x, y)


def test_mesh_and_device_count(case):
    for n in (1, 2):
        for r in case[f"w{n}"]:
            assert r["world"] == r["device_count"] == n and r["mesh_shape"] == (n,)
            assert r["multi_axis_needs_shape"]
    with pytest.raises(RuntimeError):
        ppar.make_mesh(device_type="cpu")                    # no process group here
    with pytest.raises(RuntimeError):
        ppar.device_count()


def test_ranks_agree_and_the_batch_shards_bit_for_bit(case):
    """Rank 1 returns what rank 0 returns; REVE, ICP and the scan-to-map
    batch are equal at world sizes 1 and 2; B % n raises."""
    r0, r1 = case["w2"]
    _walk(r0, r1, _eq)
    w1 = case["w1"][0]
    for key in ("reve", "icp", "s2m", "s2m_world_T", "s2m_tables"):
        _walk(w1[key], r0[key], _eq)
    assert r0["batch_mod_n_raises"]


def _reve_draws(cfg, F):
    H = reve_hypotheses(cfg.reve)
    return torch.from_numpy(threefry.uniform(threefry.split(threefry.key(0), F), 3 * H))


# The JAX package's per-device bodies of its sharded dp functions: its
# shard_map of each is a jax.vmap of the per-item function over the device's
# share, so the vmap over all items is each item's result without the
# sharded compiles. Jitted with the config static, so that two calls at the
# same shapes and config compile once.
@functools.partial(jax.jit, static_argnums=2)
def _jax_reve(scans, keys, cfg):
    return jax.vmap(lambda s, k: j_reve(s, k, cfg))(scans, keys)


@functools.partial(jax.jit, static_argnums=2)
def _jax_icp(src, tgt, cfg):
    return jax.vmap(lambda s, t: j_icp(s.xyz, t.xyz, s.mask, t.mask, cfg=cfg).transform)(
        src, tgt)


def _dryrun_pipeline_cfg(cfg, n):
    """The dry run's stage 3c config at mesh size n (`__graft_entry__.py`)."""
    return cfg.override(**{
        "voxel_map.capacity": 512 * n, "voxel_map.submap_max_points": 64 * n,
        "voxel_map.forget_radius": 100.0, "gicp.max_iterations": 4})


def _dryrun_inputs():
    """The dry run's config and its F + 1 scans, as the JAX package's."""
    jcfg = JaxConfig().override(**{
        "max_points": 256, "icp.max_iterations": 3, "reve.use_ransac": True})
    seq = JaxSequence(num_frames=5, max_points=256, num_landmarks=1500, world_extent=60.0,
                      max_range=50.0)
    return jcfg, jax_stack([seq.scan(k) for k in range(5)])


def _assert_reve_like_jax(got, want):
    """Masks equal; velocity within 1e-5 of its largest entry (a component
    of a few mm/s in a 2 m/s velocity carries ~5e-6 of the LSQ solve's f32
    round-off, whose sums the two packages order differently)."""
    _eq(got["inlier_mask"], want.inlier_mask)
    _close_to_largest(got["velocity"], want.velocity)


def test_threefry_draws_match_jax_at_these_shapes():
    """The rank's draws in one call over its keys: `threefry.split` and
    `threefry.uniform` over many keys equal jax.random's, key by key, at
    the shapes the data-parallel functions draw (F = 4 frames of 3H REVE
    draws; B = 2 stream keys split further as the blocked runner splits)."""
    cfg = config_from_dict(_jcfg().to_dict())
    H = reve_hypotheses(cfg.reve)
    for seed, n in ((0, 4), (cfg.seed, B)):
        keys = jax.random.split(jax.random.key(seed), n)
        got = threefry.split(threefry.key(seed), n)
        _eq(got, jax.random.key_data(keys))
        u = threefry.uniform(got, 3 * H)
        for i in range(n):
            _eq(u[i], jax.random.uniform(keys[i], (3 * H,)))
        _eq(threefry.split(got, 2)[1], jax.random.key_data(jax.random.split(keys[1], 2)))


def test_batched_preprocess_matches_single_device(case):
    """Frame f draws from split(key, F)[f]: the single-device REVE on the
    same draws, bit for bit."""
    inp, got = case["inp"], case["w2"][0]["reve"]
    cfg = config_from_dict(inp["cfg"])
    est = estimate_ego_velocity(scans_from_numpy(inp["scans"], device=CPU), _reve_draws(cfg, 4),
                                cfg.reve)
    for k in got:
        _eq(got[k], getattr(est, k).numpy())


def test_batched_preprocess_matches_jax(case):
    """At world size 2 against the JAX package's per-device body, its
    vmapped REVE over split(key(0), F), on the same scans; the validity
    flags and sigmas too."""
    got, want = case["w2"][0]["reve"], case["jax"]["reve"]
    _assert_reve_like_jax(got, want)
    _eq(got["valid"], want.valid)
    _close_to_largest(got["sigma"], want.sigma)


def test_batched_icp_pairs_match_jax(case):
    """At world size 2 against the JAX package's vmapped ICP on the same
    pairs: tests/test_torch_icp_moments.py's 1e-4."""
    np.testing.assert_allclose(case["w2"][0]["icp"], case["jax"]["icp"], atol=1e-4)


def test_batched_icp_pairs_match_single_device(case):
    inp, got = case["inp"], case["w2"][0]["icp"]
    cfg = config_from_dict(inp["cfg"])
    src, tgt = (scans_from_numpy(inp[k], device=CPU) for k in ("src", "tgt"))
    _eq(got, icp_point_to_point(src.xyz, tgt.xyz, src.mask, tgt.mask, cfg=cfg.icp)
        .transform.numpy())


def test_sharded_scan_to_map_batch_matches_single_device(case):
    """The sharded batch equals `run_scan_to_map_batch` on the same draws
    (the JAX package's per-stream keys, split over all B streams) with the
    blocked runner's sequential fallback on, as the JAX package's sharded
    batch leaves it: every output, pose and table bit for bit."""
    inp, got = case["inp"], case["w2"][0]
    cfg = config_from_dict(inp["cfg"])
    U = reve_batch_uniforms(cfg.seed, B, FS, BLOCK, reve_hypotheses(cfg.reve))
    st, so = pm.run_scan_to_map_batch(scans_from_numpy(inp["streams"], device=CPU), cfg,
                                      uniforms=torch.from_numpy(U), block=BLOCK,
                                      use_const_velocity_rot=True, sequential_fallback=True)
    _walk(got["s2m"], {k: v.numpy() for k, v in vars(so).items()}, _eq)
    _eq(got["s2m_world_T"], st.world_T.numpy())
    _walk(got["s2m_tables"], [t.numpy() for t in st.vmap.tables()], _eq)
    assert np.isfinite(got["s2m_world_T"]).all()


def test_sharded_scan_to_map_batch_matches_jax(case):
    """At world size 2 against the JAX package's per-device body, its
    vmapped `run_scan_to_map_blocked` with the keys split(key(seed), B),
    on the same streams: each stream as tests/test_torch_batch.py holds a
    stream to JAX's batch (`_assert_tracks`)."""
    got, jo = case["w2"][0]["s2m"], case["jax"]["s2m"]
    for b in range(B):
        po = SimpleNamespace(**{k: torch.from_numpy(v[b]) for k, v in got.items()})
        _assert_tracks(po, jax.tree.map(lambda x: x[b], jo), case["gt"][b])


def test_pad_factors_for_mesh_matches_jax(case):
    got, want = case["w2"][0]["padded"], case["jax"]["padded"]
    for name in FACTORS:
        for f, v in got[name].items():
            _eq(v, np.asarray(getattr(getattr(want, name), f)))
            assert v.shape[0] % 3 == 0


def _poses_cost(res):
    return [res[0].poses.numpy(), res[1].numpy()]


@pytest.mark.parametrize("name", ["dense_ne", "dense_opt", "block_ne", "block_opt"])
def test_distributed_gn_matches_single_device(case, name):
    """Each of the four distributed GN functions at world sizes 1 and 2
    against the port's single-device assembly or solver on the same graph
    (every factor type)."""
    graph = pose_graph_from_numpy(case["inp"]["graph"], device=CPU)
    cfg = PoseGraphConfig(**case["inp"]["pg_cfg"])
    if name == "dense_ne":
        single = [x.numpy() for x in pg.pose_graph_normal_equations(graph, cfg)]
    elif name == "dense_opt":
        single = _poses_cost(pg.optimize_pose_graph(graph, cfg))
    elif name == "block_ne":
        chain, _ = pg.split_chain_loops(graph.rel)
        ne = pg.block_normal_equations(graph.replace(rel=None), chain, None, cfg)
        single = [x.numpy() for x in (ne.diag, ne.off, ne.g, ne.cost)]
    else:
        single = _poses_cost(pg.optimize_pose_graph_block(graph, cfg))
    for n in (1, 2):
        got = case[f"w{n}"][0][name]
        for a, s in zip(got, single):
            if name.endswith("_ne"):
                _close_to_largest(a, s)
            elif a.ndim:                                       # poses
                np.testing.assert_allclose(a, s, atol=1e-4)
            else:                                              # cost
                np.testing.assert_allclose(a, s, rtol=1e-4, atol=1e-6)
    assert case["w2"][0]["block_rel_kept"]


@pytest.mark.parametrize("name", ["dense_ne", "block_ne"])
def test_distributed_assembly_matches_jax(case, name):
    """The two distributed assemblies at world size 2 against JAX's on its
    2-device mesh, same graph."""
    for a, w in zip(case["w2"][0][name], case["jax"][name]):
        _close_to_largest(a, w)


@pytest.mark.parametrize("name", ["dense_opt", "block_opt"])
def test_distributed_optimizers_match_jax(case, name):
    """The two distributed optimisers at world size 2 against JAX's on its
    2-device mesh, same graph: poses within 1e-4 m, cost rtol 1e-4."""
    (poses, cost), (jposes, jcost) = case["w2"][0][name], case["jax"][name]
    np.testing.assert_allclose(poses, jposes, atol=1e-4)
    np.testing.assert_allclose(cost, jcost, rtol=1e-4, atol=1e-6)


def test_distributed_block_solve_converges_from_the_same_starts(case):
    """Four perturbed K = 24 chains: the distributed block GN at world
    sizes 1 and 2 converges (max error below 0.05 m) from exactly the
    starts the single-device block GN converges from, to the same poses."""
    cfg = PoseGraphConfig(max_iterations=10)
    for c, arrays, d1, d2 in zip(case["chains"], case["inp"]["chains"],
                                 case["w1"][0]["chains"], case["w2"][0]["chains"]):
        single = pg.optimize_pose_graph_block(pose_graph_from_numpy(arrays, device=CPU),
                                              cfg)[0].poses.numpy()
        errs = [np.linalg.norm(p[:, :3, 3] - c["gt"][:, :3, 3], axis=-1).max()
                for p in (single, d1, d2)]
        assert len({e < 0.05 for e in errs}) == 1, errs
        np.testing.assert_allclose(d1, single, atol=1e-4)
        np.testing.assert_allclose(d2, single, atol=1e-4)


def test_pose_graph_odometry_with_a_mesh(case):
    """`run_pose_graph_odometry(mesh=...)` on the circle at world sizes 1
    and 2 against the port's run without a mesh: the same odometry,
    keyframes and closures, refined poses within 1e-4 m."""
    circle = case["inp"]["circle"]
    ref = run_pose_graph_odometry(scans_from_numpy(circle["scans"], device=CPU),
                                  config_from_dict(circle["cfg"]),
                                  uniforms=torch.from_numpy(circle["uniforms"]), **PG_KW)
    for n in (1, 2):
        got = case[f"w{n}"][0]["pipeline"]
        _eq(got["odom_poses"], ref.odom_poses)
        _eq(got["keyframes"], ref.keyframe_indices)
        assert got["closures"] == ref.num_loop_closures >= 1
        np.testing.assert_allclose(got["poses"], ref.poses, atol=1e-4)


def _ate(poses, seq):
    return ate_rmse(poses[:, :3, 3], seq.poses[:len(poses), :3, 3], align=False)


def test_pose_graph_odometry_with_a_mesh_matches_jax(case):
    """`run_pose_graph_odometry(mesh=...)` at world sizes 1 and 2 against
    the JAX package's run with its 2-device mesh, as
    tests/test_torch_pose_graph.py holds the run without one: the same
    keyframes, closures within one, the odometry's ATE within 5e-3 m and
    the refined ATE within 0.05 m of JAX's."""
    cseq, jres = case["circle"][0], case["jax"]["pipeline"]
    for n in (1, 2):
        got = case[f"w{n}"][0]["pipeline"]
        _eq(got["keyframes"], jres.keyframe_indices)
        assert abs(got["closures"] - jres.num_loop_closures) <= 1
        assert abs(_ate(got["odom_poses"], cseq) - _ate(jres.odom_poses, cseq)) <= 5e-3
        assert abs(_ate(got["poses"], cseq) - _ate(jres.poses, cseq)) <= 0.05


def test_dryrun_multichip_stages(case):
    """The dry run's stages at world size 2 (`dryrun_multichip(2)`'s rank
    work): REVE and pairwise ICP bit for bit the single-device functions on
    the same scans and key, and against the JAX package's vmapped REVE
    (split(key(0), F)) and ICP on the same scans (masks equal, velocity
    within 1e-5 of its largest entry, transforms within 1e-4); stage 4's normal
    equations within 1e-5 of JAX's distributed assembly of the same factors
    on its mesh, and its solve and stage 4b's block GN within 1e-4 m of the
    single-device solvers; stage 3's sharded map the single-device map's
    voxels and sector count, stage 3b's ring normal equations the
    single-device sweep's, stage 3c's distributed run JAX's on its mesh."""
    got = case["w2"][0]["dryrun"]
    cfg = config_from_dict(_dryrun_inputs()[0].to_dict())
    F = 4
    _assert_reve_like_jax(got, case["jax"]["dryrun_reve"])
    np.testing.assert_allclose(got["T_rel"], case["jax"]["dryrun_icp"], atol=1e-4)
    seq = SyntheticSequence(num_frames=F + 1, max_points=256, num_landmarks=1500,
                            world_extent=60.0, max_range=50.0)
    scans = stack_scans([seq.scan(k) for k in range(F + 1)])
    est = estimate_ego_velocity(scans[:F], _reve_draws(cfg, F), cfg.reve)
    _eq(got["velocity"], est.velocity.numpy())
    _eq(got["inlier_mask"], est.inlier_mask.numpy())
    src, tgt = scans[1:], scans[:F]
    _eq(got["T_rel"], icp_point_to_point(src.xyz, tgt.xyz, src.mask, tgt.mask, cfg=cfg.icp)
        .transform.numpy())
    rel = jg.RelPoseFactors.build(i=np.arange(F, dtype=np.int32),
                                  j=np.arange(1, F + 1, dtype=np.int32),
                                  T_meas=jnp.asarray(got["T_rel"]))
    jgraph = jg.PoseGraph(poses=jnp.broadcast_to(jnp.eye(4), (F + 1, 4, 4)), rel=rel)
    H, g, cost = jpar.distributed_normal_equations(jgraph, case["jmesh"],
                                                   JaxPoseGraphConfig(max_iterations=3))
    _close_to_largest(got["H"], H)
    _close_to_largest(got["g"], g)
    np.testing.assert_allclose(got["cost"], float(cost), rtol=1e-4)
    pcfg = PoseGraphConfig(max_iterations=3)
    graph = pg.PoseGraph(poses=torch.eye(4).repeat(F + 1, 1, 1), rel=pg.RelPoseFactors.build(
        np.arange(F), np.arange(1, F + 1), torch.from_numpy(got["T_rel"])))
    Hs, gs, _ = pg.pose_graph_normal_equations(graph, pcfg)
    poses, _ = solve_pose_graph_step(graph, Hs, gs, pcfg)
    np.testing.assert_allclose(got["poses"], poses.numpy(), atol=1e-4)
    gb, _ = pg.optimize_pose_graph_block(graph, pcfg)
    np.testing.assert_allclose(got["block_poses"], gb.poses.numpy(), atol=1e-4)
    assert np.isfinite(got["block_cost"])

    # 3) the sharded map of scan 0 (capacity 2^12): the single-device map's
    #    voxels, and its sector count
    s0 = scans[0]
    single = voxel_map_insert(voxel_map_create(1 << 12, device="cpu"), s0.xyz, s0.mask)
    tables = dict(zip(("keys", "points", "intensity", "occupied", "stat_n"),
                      got["map_tables"][:5]))
    occ = tables["occupied"] > 0.5
    socc = single.occupied.numpy() > 0.5
    assert dict(zip(map(tuple, tables["keys"][occ]), tables["stat_n"][occ])) == \
        dict(zip(map(tuple, single.keys.numpy()[socc]), single.stat_n.numpy()[socc]))
    _, _, sub_n, _, _ = voxel_map_sector_search_with_stats(
        single, torch.zeros(3), 80.0, torch.tensor(0.0), 180.0, 1024)
    assert int(got["sub_n"]) == int(sub_n) > 0
    # 3b) the ring normal equations on 256 x 2 tiled targets against the
    #     single-device sweep of the same targets (tests/test_parallel.py's
    #     1e-4): duplicate rows across the two shards, so the ring's tie
    #     rule and the sweep's tie average pick the same payload
    s1, M = scans[1], 512
    ring = pv.vgicp_iteration(torch.eye(4), s1.xyz, s1.mask,
                              pv.radar_point_covariances_packed(s1.xyz),
                              s0.xyz[:256].repeat(2, 1),
                              torch.tensor([0.05, 0.05, 0.05, 0.0, 0.0, 0.0]).expand(M, 6),
                              torch.ones(M))
    for a, b in zip(got["ring"], ring):
        np.testing.assert_allclose(a, b.numpy(), rtol=1e-4, atol=1e-4)
    # 3c) the blocked distributed run (16 frames, forget on) against JAX's
    #     on its 2-device mesh: tests/test_torch_batch.py's `_assert_tracks`
    jout, jgt = case["jax"]["dryrun_pipeline"]
    gt = np.linalg.inv(jgt[0]) @ jgt
    _assert_tracks(SimpleNamespace(**{k: torch.from_numpy(v)
                                      for k, v in got["pipeline"].items()}),
                   SimpleNamespace(**jout), gt)
    assert got["pipeline_voxels"] > 0
