"""Offline fleet replay in a closed loop: B recorded streams of F frames go
through the port's blocked batch tracker, `run_scan_to_map_batch(block,
use_const_velocity_rot)`, one replay after another.

End to end: `scans_per_s`, the scans of the whole replays completed in the
window over the time to the last completion. Correctness: every completed
replay's per-frame poses of every stream against the plain reference run
over the same streams, and every stream's track against the ground truth
the generator drove it along (`compare.track_rpe`), a check that owes
nothing to the port's code."""

from __future__ import annotations

import torch

from radarbench import compare, loops
from radarbench.harness import Window
from radarbench.stats import rate

PROFILED = range(1, 2)     # the replay traced in a --trace 1 run


class Driver:
    def __init__(self, cfg, traffic, seed, device, seconds):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.B, self.F = int(traffic["streams"]), int(traffic["frames"])
        self.opts = dict(cfg["trackers"]["blocked_batch"])

    def setup(self):
        from icp4dradar_tpu_torch.config import PipelineConfig
        from icp4dradar_tpu_torch.io.scan import RadarScan
        from icp4dradar_tpu_torch.preprocess.reve import reve_hypotheses

        self.pcfg = PipelineConfig.from_dict(self.cfg["pipeline"])
        st, self.uniforms = loops.stream_inputs(self.cfg, self.traffic, self.B, self.F,
                                                3 * reve_hypotheses(self.pcfg.reve), self.seed, 1,
                                                self.device)
        # the reference's copy of the inputs, made before the program sees them
        self.ref_inputs = (st.streams(slice(None)), self.uniforms.clone())
        self.scans = loops.port_scans(st, RadarScan)
        self._replay()                                   # warm-up: every shape

    def _replay(self, phase_times=None):
        from icp4dradar_tpu_torch.models.scan_to_map import run_scan_to_map_batch

        _, out = run_scan_to_map_batch(self.scans, self.pcfg, uniforms=self.uniforms,
                                       phase_times=phase_times, **self.opts)
        return out

    def window(self, seconds, tracer) -> Window:
        launch_sets = []

        def unit(k):
            out = self._replay()
            poses = out.world_T.cpu()
            if k in PROFILED and tracer is not None:
                launch_sets.append((out.iterations.cpu().tolist(),
                                    out.submap_points.cpu().tolist()))
            return poses

        loop = loops.closed_loop(seconds, unit, tracer, PROFILED)
        self.poses = [p for p, t in zip(loop.results, loop.completions) if t <= loop.close]
        scans = self.B * self.F
        counters = {}
        if tracer is not None:
            phase_times = {}
            self._replay(phase_times)
            block = int(self.opts["block"])
            groups = [slice(f, f + 1) for f in range(block)] + [
                slice(f, f + block) for f in range(block, self.F, block)]
            counters = {"profiled_scans": scans * len(launch_sets),
                        "k4_launch_sets": [(it, sp, int(self.scans.xyz.shape[2]), groups)
                                           for it, sp in launch_sets],
                        "phase_times": phase_times}
        lost = sum(int((~torch.isfinite(p)).any(dim=-1).any(dim=-1).sum()) for p in loop.results)
        return Window(metrics={"scans_per_s": rate(scans, loop.t0, loop.completions,
                                                   loop.close)},
                      attempted=scans * loop.attempted, failed=lost, counters=counters)

    def release(self):
        del self.scans, self.uniforms

    def reference(self, control=False):
        from radarbench.reference import s2m

        st, u = self.ref_inputs
        return s2m.blocked_batch(st, u, self.cfg, self.opts, tf32=control)

    def check(self, lim, control=False):
        ref = self.reference(control).cpu()
        gaps = dict.fromkeys(("pose_gap_m", "rot_gap_rad", "track_rpe_m"), float("inf"))
        if self.poses:                      # every whole replay of the window, every stream
            prog = torch.stack(self.poses)
            gt = self.ref_inputs[0].gt.cpu()
            gaps = {"pose_gap_m": compare.translation_gap(prog, ref.expand(prog.shape)),
                    "rot_gap_rad": compare.rotation_gap(prog, ref.expand(prog.shape)),
                    # the track of what is judged: the control's own where it stands in
                    "track_rpe_m": compare.track_rpe(ref if control else prog,
                                                     gt.expand(prog.shape[1:]))}
        return [compare.check(k, v, lim[k]) for k, v in gaps.items()]
