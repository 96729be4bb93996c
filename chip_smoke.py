#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (`icp4dradar_tpu_torch`) on one
NVIDIA GPU: the quickest proof that the port builds, agrees with its plain
versions and runs its main path at full size.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and ignored):
1. device  — requires CUDA; prints torch/CUDA versions and the card's name
             and power limit (nvidia-smi).
2. build   — compiles csrc/*.cu with nvcc (sm_90a) and prints the seconds
             and the ptxas resource report.
3. kernel  — the ICP-moments kernel against its plain PyTorch version on the
             card: 8 bench pairs (2048 x 2048) under random poses, a ragged
             case with random masks and fully masked pairs, exact ties, and
             the full bench batch (1024 pairs); tolerance rtol 1e-4 /
             atol 1e-3 on every moment. Times both at 1024 x 2048 x 2048
             (one ICP iteration; CUDA events, median of 10, in
             turns plain / kernel / kernel / plain).
4. slice   — the bench sequence of `bench.py` (1024 frames x 2048 points,
             5000 landmarks, seed 0) through
             run_scan_to_scan(use_doppler_prior=True): warm-up, then one
             timed run with the kernel launch count reset just before and
             read just after (launches must equal ICP iterations + 1). Fails
             on non-finite outputs, on any rejected frame, or on an ATE
             (align=False) outside 1.976 +- 0.05 m. Also checks that the CUDA
             path agrees with the CPU path on a 16-frame x 256-point input.

The second-to-last line is a JSON record of the kernels; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np

RTOL, ATOL = 1e-4, 1e-3
ATE_EXPECTED, ATE_BAND = 1.976, 0.05
BENCH_FRAMES, BENCH_POINTS = 1024, 2048
MOMENT_GROUPS = {"sw": slice(0, 1), "swp": slice(1, 4), "swq": slice(4, 7),
                 "swpq": slice(7, 16), "swd2": slice(16, 17),
                 "ungated": slice(17, 19)}
KERNEL_SOURCE = "icp4dradar_tpu_torch/csrc/icp_moments.cu"
KERNEL_REPLACES = "icp4dradar_tpu/ops/icp_fused.py:36"


def log(msg):
    print(msg, flush=True)


def phase_device(torch):
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: chip_smoke "
                           "needs an NVIDIA GPU")
    log(f"[device] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} devices {torch.cuda.device_count()} "
        f"name {torch.cuda.get_device_name(0)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(f"[device] nvidia-smi: {card}")
    return card


def phase_build():
    from icp4dradar_tpu_torch.ops import _build

    t0 = time.perf_counter()
    path = _build.build_library()
    _build.load_library()
    log(f"[build] {path.name} in {time.perf_counter() - t0:.2f} s")
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"[build] {line.strip()}")


def compare(name, kern, plain):
    """Max abs / rel error per moment group; raises beyond RTOL/ATOL."""
    kern, plain = kern.double().cpu(), plain.double().cpu()
    if not (np.isfinite(kern.numpy()).all() and np.isfinite(plain.numpy()).all()):
        raise RuntimeError(f"[kernel] {name}: non-finite moments")
    parts = []
    for g, sl in MOMENT_GROUPS.items():
        d = (kern[..., sl] - plain[..., sl]).abs()
        rel = d / plain[..., sl].abs().clamp(min=1e-30)
        parts.append(f"{g} abs {d.max().item():.3e} rel {rel.max().item():.3e}")
    bad = (kern - plain).abs() > ATOL + RTOL * plain.abs()
    log(f"[kernel] {name}: " + "; ".join(parts))
    if bool(bad.any()):
        raise RuntimeError(f"[kernel] {name}: {int(bad.sum())} moments beyond "
                           f"rtol {RTOL} / atol {ATOL}")
    return (kern - plain).abs().max().item()


def time_cuda(torch, fn, reps=10, warmup=2):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def phase_kernel(torch, scans):
    from icp4dradar_tpu_torch.geom import se3_exp
    from icp4dradar_tpu_torch.ops.icp_fused import (
        icp_iteration_moments, icp_iteration_moments_plain,
    )

    dev = scans.xyz.device
    rng = np.random.default_rng(0)
    max_err = 0.0

    def both(name, T, src, sm, tgt, tm):
        k = icp_iteration_moments(T, src, sm, tgt, tm)
        torch.cuda.synchronize()
        p = icp_iteration_moments_plain(T, src, sm, tgt, tm)
        return compare(name, k, p), k

    # 8 bench pairs (frame k onto k-1) under random poses
    xi = rng.normal(0.0, [0.5, 0.5, 0.1, 0.01, 0.01, 0.05], (8, 6)).astype(np.float32)
    T = se3_exp(torch.from_numpy(xi).to(dev)).contiguous()
    src, sm = scans.xyz[1:9].contiguous(), scans.mask[1:9].contiguous()
    tgt, tm = scans.xyz[0:8].contiguous(), scans.mask[0:8].contiguous()
    max_err = max(max_err, both("bench B=8 2048x2048", T, src, sm, tgt, tm)[0])

    # ragged: N=1000, M=1234, random masks; pair 2 has no valid target,
    # pair 3 no valid source
    B, N, M = 4, 1000, 1234
    src = torch.from_numpy(rng.normal(0, 20, (B, N, 3)).astype(np.float32)).to(dev)
    tgt = torch.from_numpy(rng.normal(0, 20, (B, M, 3)).astype(np.float32)).to(dev)
    sm = torch.from_numpy((rng.uniform(size=(B, N)) > 0.2).astype(np.float32)).to(dev)
    tm = torch.from_numpy((rng.uniform(size=(B, M)) > 0.3).astype(np.float32)).to(dev)
    tm[2] = 0.0
    sm[3] = 0.0
    xi = rng.normal(0.0, [1.0, 1.0, 0.2, 0.02, 0.02, 0.1], (B, 6)).astype(np.float32)
    T = se3_exp(torch.from_numpy(xi).to(dev)).contiguous()
    both("ragged B=4 1000x1234 masked", T, src, sm, tgt, tm)

    # exact ties: two targets at d2 = 5 from the source average to (1, 0, 0)
    src = torch.zeros((1, 1, 3), device=dev)
    tgt = torch.tensor([[[1.0, 2.0, 0.0], [1.0, -2.0, 0.0], [50.0, 50.0, 50.0]]],
                       device=dev)
    _, k = both("exact tie", torch.eye(4, device=dev)[None], src,
                torch.ones((1, 1), device=dev), tgt, torch.ones((1, 3), device=dev))
    want = torch.tensor([1.0, 0.0, 0.0], device=dev)
    if not torch.allclose(k[0, 4:7], want, atol=1e-6) or abs(k[0, 16].item() - 5.0) > 5e-6:
        raise RuntimeError(f"[kernel] exact tie: swq {k[0, 4:7].tolist()} "
                           f"swd2 {k[0, 16].item()}, expected [1, 0, 0] and 5")

    # the full bench batch: one ICP iteration of the main path
    src, sm = scans.xyz, scans.mask
    tgt = torch.cat([scans.xyz[:1], scans.xyz[:-1]]).contiguous()
    tm = torch.cat([scans.mask[:1], scans.mask[:-1]]).contiguous()
    T = torch.eye(4, device=dev).expand(src.shape[0], 4, 4).contiguous()
    max_err = max(max_err, both(f"bench B={src.shape[0]} 2048x2048",
                                T, src, sm, tgt, tm)[0])
    # in turns, plain / kernel / kernel / plain; each a median of 10
    def kernel():
        return icp_iteration_moments(T, src, sm, tgt, tm)

    def plain():
        return icp_iteration_moments_plain(T, src, sm, tgt, tm)

    p1, k1, k2, p2 = (time_cuda(torch, f) for f in (plain, kernel, kernel, plain))
    ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
    pairs = src.shape[0] * src.shape[1] * tgt.shape[1]
    log(f"[kernel] time at B={src.shape[0]} x {src.shape[1]} x {tgt.shape[1]}: "
        f"kernel {k1:.3f} / {k2:.3f} ms, plain {p1:.3f} / {p2:.3f} ms; "
        f"kernel {pairs / (ms * 1e-3) / 1e9:.1f} G point pairs/s")
    return max_err, ms, plain_ms


def phase_slice(torch, seq, scans):
    from icp4dradar_tpu_torch.config import PipelineConfig
    from icp4dradar_tpu_torch.io import SyntheticSequence
    from icp4dradar_tpu_torch.io.scan import stack_scans
    from icp4dradar_tpu_torch.models import run_scan_to_scan
    from icp4dradar_tpu_torch.ops import icp_fused
    from icp4dradar_tpu_torch.preprocess import draw_uniforms
    from icp4dradar_tpu_torch.utils import ate_rmse

    cfg = PipelineConfig()
    F = scans.xyz.shape[0]

    def run():
        out = run_scan_to_scan(scans, cfg, use_doppler_prior=True)
        torch.cuda.synchronize()
        return out

    t0 = time.perf_counter()
    run()
    log(f"[slice] warm-up run {time.perf_counter() - t0:.3f} s")
    torch.cuda.reset_peak_memory_stats()
    icp_fused.ICP_MOMENTS_LAUNCHES = 0
    t0 = time.perf_counter()
    out = run()
    dt = time.perf_counter() - t0
    launches = icp_fused.ICP_MOMENTS_LAUNCHES
    iters = int(out.iterations.max().item())
    repeats = []
    for _ in range(3):
        t1 = time.perf_counter()
        run()
        repeats.append(time.perf_counter() - t1)
    log(f"[slice] {F} frames in {dt * 1e3:.2f} ms = {F / dt:.1f} scans/s "
        f"(repeats: {', '.join(f'{F / r:.1f}' for r in repeats)} scans/s); "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"[slice] icp_moments launches {launches}, ICP iterations {iters} "
        f"(per-pair mean {out.iterations.float().mean().item():.2f})")
    if launches <= 0 or launches != iters + 1:
        raise RuntimeError(f"[slice] launch count {launches} != ICP "
                           f"iterations {iters} + 1")
    for f in ("icp_transform", "world_T", "velocity", "fitness", "sine_A", "sine_b"):
        x = getattr(out, f)
        if x.shape[0] != F or not bool(torch.isfinite(x).all()):
            raise RuntimeError(f"[slice] {f}: shape {tuple(x.shape)} or non-finite")
    n_acc = int(out.accepted.sum().item())
    poses = out.world_T.cpu().numpy()
    ate = ate_rmse(poses[:, :3, 3], seq.poses[:, :3, 3], align=False)
    log(f"[slice] accepted {n_acc}/{F}, converged "
        f"{int(out.converged.sum().item())}/{F}, ATE (align=False) {ate:.4f} m")
    if n_acc != F:
        raise RuntimeError(f"[slice] only {n_acc}/{F} frames accepted")
    if not abs(ate - ATE_EXPECTED) <= ATE_BAND:
        raise RuntimeError(f"[slice] ATE {ate:.4f} m outside "
                           f"{ATE_EXPECTED} +- {ATE_BAND} m")

    # small input: the CUDA path against the CPU path on the same draws
    small = SyntheticSequence(num_frames=16, max_points=256, num_landmarks=2000,
                              seed=0)
    s_cpu = stack_scans([small.scan(k) for k in range(16)])
    g = torch.Generator().manual_seed(0)
    u = draw_uniforms((16,), cfg.doppler.num_hypotheses, g)
    o_cpu = run_scan_to_scan(s_cpu, cfg, uniforms=u, use_doppler_prior=True)
    o_gpu = run_scan_to_scan(s_cpu.to("cuda"), cfg, uniforms=u.cuda(),
                             use_doppler_prior=True)
    d = (o_gpu.world_T.cpu() - o_cpu.world_T).abs().max().item()
    log(f"[slice] 16x256 CUDA vs CPU: max |world_T| diff {d:.3e}, accepted "
        f"equal {bool((o_gpu.accepted.cpu() == o_cpu.accepted).all())}")
    if d > 1e-3 or not bool((o_gpu.accepted.cpu() == o_cpu.accepted).all()):
        raise RuntimeError("[slice] CUDA and CPU paths disagree on 16x256")
    return launches, F / dt, ate


def main() -> int:
    import torch

    card = phase_device(torch)

    from icp4dradar_tpu_torch.io import SyntheticSequence
    from icp4dradar_tpu_torch.io.scan import stack_scans

    phase_build()

    t0 = time.perf_counter()
    seq = SyntheticSequence(
        num_frames=BENCH_FRAMES, max_points=BENCH_POINTS, num_landmarks=5000,
        world_extent=120.0, max_range=80.0, dynamic_fraction=0.1,
        speed=1.0, turn_rate=0.02, seed=0,
    )
    scans = stack_scans([seq.scan(k) for k in range(BENCH_FRAMES)]).to("cuda")
    torch.cuda.synchronize()
    log(f"[data] bench sequence {BENCH_FRAMES} x {BENCH_POINTS} in "
        f"{time.perf_counter() - t0:.2f} s")

    max_err, ms, plain_ms = phase_kernel(torch, scans)
    launches, scans_per_s, ate = phase_slice(torch, seq, scans)

    log(json.dumps({"kernels": [{
        "name": "icp_moments", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
    }]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
