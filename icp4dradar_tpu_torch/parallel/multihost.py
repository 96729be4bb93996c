"""Multi-process runtime: joining the process group, the global mesh and
the per-process frame feed (PyTorch port of
`icp4dradar_tpu/parallel/multihost.py`).

In torch every rank is already a process, so the runtime is how a process
joins the group and how the frames reach the ranks:

- `maybe_initialize_distributed(device)` joins the process group when the
  launcher announces one through `ICP4D_COORDINATOR` (host:port),
  `ICP4D_NUM_PROCESSES` and `ICP4D_PROCESS_ID`, over
  `init_method="tcp://host:port"`: NCCL for device "cuda" (which needs a
  card), gloo for "cpu". The backend follows from the device the caller
  names, never from what the machine has.
- `global_mesh()` is `make_mesh` over the whole world.
- `process_frame_slice()` is the feed contract: process p reads only its
  contiguous share of the sequence, sizes differing by at most one.
- `assemble_global_scans()` gathers the shares so that every rank holds
  the whole sequence, which the distributed pipeline takes replicated.
- `run_scan_to_map_multihost()` chains them into
  `run_scan_to_map_distributed`; `main` is its launcher:

      ICP4D_COORDINATOR=host0:29500 ICP4D_NUM_PROCESSES=2 ICP4D_PROCESS_ID=$RANK \\
          python -m icp4dradar_tpu_torch.parallel.multihost --synthetic 64 \\
          --map-interval 8 --device cuda --out /tmp/radar

The JAX package's assembly never pads its shares (its
`pad_frames_for_mesh` is not called), so it fails when F is not a
multiple of the process count; here each share is padded to the largest
one for the collective and the result trimmed back to F frames, the
contract its docstrings state (ROADMAP.md queue 3, "Unused padding")."""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from icp4dradar_tpu_torch.io.scan import RadarScan, stack_scans
from icp4dradar_tpu_torch.parallel.mesh import (
    all_gather_rows,
    all_reduce_max,
    make_mesh,
    mesh_device,
)

COORD_ENV = "ICP4D_COORDINATOR"
NPROC_ENV = "ICP4D_NUM_PROCESSES"
PID_ENV = "ICP4D_PROCESS_ID"


def _backend(device: str) -> str:
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' without a CUDA device; pass device='cpu' for "
                               "gloo ranks")
        return "nccl"
    if device == "cpu":
        return "gloo"
    raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")


def maybe_initialize_distributed(device: str = "cuda") -> Tuple[int, int]:
    """Join the process group when the launcher's environment announces one
    -> (process index, process count). An initialised group returns its own
    (rank, world); without the three variables and without a group, (0, 1)
    and nothing is joined. With device "cuda" each process takes the card
    of its index modulo the cards it sees."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    coord = os.environ.get(COORD_ENV)
    if not coord:
        return 0, 1
    nproc, pid = int(os.environ[NPROC_ENV]), int(os.environ[PID_ENV])
    backend = _backend(device)
    if backend == "nccl":
        torch.cuda.set_device(pid % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{coord}", rank=pid,
                            world_size=nproc)
    return pid, nproc


def _join_world_of_one(device: str) -> None:
    """A process group of this process alone, through a FileStore in a
    fresh temporary directory (no network)."""
    backend = _backend(device)
    store = os.path.join(tempfile.mkdtemp(prefix="icp4d_pg_"), "store")
    dist.init_process_group(backend, init_method=f"file://{store}", rank=0, world_size=1)


def global_mesh(axis: str = "dp", device_type: str = "cuda") -> DeviceMesh:
    """A 1-D mesh over every rank of the process group (one device a rank);
    call `maybe_initialize_distributed` first."""
    return make_mesh(axis_names=(axis,), device_type=device_type)


def process_frame_slice(num_frames: int, process_count: int,
                        process_index: int) -> Tuple[int, int]:
    """The contiguous [start, stop) frame range process `process_index`
    loads. Remainder frames go to the leading processes, so sizes differ by
    at most one and the ranges tile [0, num_frames) exactly."""
    if not 0 <= process_index < process_count:
        raise ValueError(f"process_index {process_index} outside [0, {process_count})")
    base, rem = divmod(num_frames, process_count)
    start = process_index * base + min(process_index, rem)
    stop = start + base + (1 if process_index < rem else 0)
    return start, stop


def assemble_global_scans(scans_local: RadarScan, mesh: DeviceMesh, axis: str = "dp",
                          process_count: int = 1) -> RadarScan:
    """This process's share of the frames (its `process_frame_slice`, the
    shares in process order) -> the whole (F, ...) sequence on every rank.
    One process: the share is returned as it is. Several: each share is
    padded to the largest one (one all-reduce of the share sizes), gathered
    with a flag of its real frames (one all-gather) and trimmed back to the
    F real frames."""
    if process_count == 1:
        return scans_local
    dev = mesh_device(mesh)
    scans_local = scans_local.to(dev)
    F_l = scans_local.xyz.shape[0]
    F_max = int(all_reduce_max(torch.tensor(F_l, device=dev), mesh, axis))
    names = [f.name for f in dataclasses.fields(RadarScan)]
    parts = []
    for k in names:
        x = getattr(scans_local, k)
        parts.append(torch.cat([x, x.new_zeros((F_max - F_l,) + tuple(x.shape[1:]))]))
    real = torch.arange(F_max, device=dev) < F_l
    whole = all_gather_rows(parts + [real], mesh, axis)
    keep = whole[-1]
    return RadarScan(**{k: x[keep] for k, x in zip(names, whole[:-1])})


def run_scan_to_map_multihost(
    scans_or_dataset,
    cfg=None,
    block: int = 0,
    use_doppler_prior: bool = True,
    use_const_velocity_rot: bool = False,
    priors=None,
    axis: str = "dp",
    device: str = "cuda",
):
    """The multi-process entry point of the distributed tracker:
    `maybe_initialize_distributed` -> `global_mesh` -> this process loads
    only its `process_frame_slice` of a dataset (anything with len() and
    [k] -> RadarScan) -> `assemble_global_scans` ->
    `run_scan_to_map_distributed`. A stacked RadarScan is taken as this
    process's share as it is. Without a launcher and without a group the
    process joins a group of its own (a world of one). Returns what
    `run_scan_to_map_distributed` returns, the outputs the same on every
    process."""
    from icp4dradar_tpu_torch.config import PipelineConfig
    from icp4dradar_tpu_torch.parallel.distributed_pipeline import run_scan_to_map_distributed

    cfg = cfg or PipelineConfig()
    pid, nproc = maybe_initialize_distributed(device)
    if not dist.is_initialized():
        _join_world_of_one(device)
    mesh = global_mesh(axis, device_type=device)
    if isinstance(scans_or_dataset, RadarScan):
        scans_local = scans_or_dataset
    else:
        ds = scans_or_dataset
        start, stop = process_frame_slice(len(ds), nproc, pid)
        scans_local = stack_scans([ds[k] for k in range(start, stop)])
    scans = assemble_global_scans(scans_local.to(mesh_device(mesh)), mesh, axis,
                                  process_count=nproc)
    return run_scan_to_map_distributed(
        scans, mesh, cfg, axis=axis, block=block, use_doppler_prior=use_doppler_prior,
        use_const_velocity_rot=use_const_velocity_rot, priors=priors)


class _SyntheticFrames:
    """A synthetic sequence as a dataset: frame k made when it is read."""

    def __init__(self, seq):
        self.seq = seq

    def __len__(self) -> int:
        return len(self.seq)

    def __getitem__(self, k: int) -> RadarScan:
        return self.seq.scan(k)


def main(argv: Optional[list] = None) -> int:
    """The launcher: one process a device (see the module docstring).
    Process 0 writes radar_odometry.txt and odom_tum.txt (every process with
    --all-procs-write) and prints one JSON line."""
    import argparse
    import json

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dataset", help=".bin sequence directory")
    p.add_argument("--synthetic", type=int, default=0)
    p.add_argument("--max-points", type=int, default=2048)
    p.add_argument("--map-interval", type=int, default=0)
    p.add_argument("--out", default="radar")
    p.add_argument("--all-procs-write", action="store_true")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)

    from icp4dradar_tpu_torch.config import PipelineConfig
    from icp4dradar_tpu_torch.utils import write_rt_txt, write_tum

    cfg = PipelineConfig().override(max_points=args.max_points)
    if args.dataset:
        from icp4dradar_tpu_torch.io import BinSequenceDataset

        ds = BinSequenceDataset(args.dataset, max_points=args.max_points)
    elif args.synthetic:
        from icp4dradar_tpu_torch.io import SyntheticSequence

        ds = _SyntheticFrames(SyntheticSequence(num_frames=args.synthetic,
                                                max_points=args.max_points))
    else:
        p.error("provide --dataset or --synthetic F")

    _, outs = run_scan_to_map_multihost(ds, cfg, block=args.map_interval, device=args.device)
    pid, _ = maybe_initialize_distributed(args.device)
    if pid == 0 or args.all_procs_write:
        os.makedirs(args.out, exist_ok=True)
        poses = outs["world_T"].cpu().numpy()
        write_rt_txt(os.path.join(args.out, "radar_odometry.txt"), poses)
        write_tum(os.path.join(args.out, "odom_tum.txt"), poses)
        print(json.dumps({"frames": int(poses.shape[0]), "process_index": pid}))
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
