"""Offline scan-to-scan replays in a closed loop: one recorded sequence of
F frames goes through the port's `run_scan_to_scan` (the reference's
`icp4radar` path: Doppler preprocessing, one batched ICP over every frame
pair, the tracking gate and the pose chain), back to back.

End to end: `scans_per_s`, the frames of the whole replays completed in
the window over the time to the last completion. Correctness: every
completed replay's ego velocities, frame-to-frame transforms and poses
against the plain reference over the whole sequence, and the track against
the ground truth the generator drove it along (`compare.track_rpe`), a
check that owes nothing to the port's code."""

from __future__ import annotations

import torch

from radarbench import compare, loops, synth
from radarbench.harness import Window
from radarbench.stats import rate

PROFILED = range(1, 4)      # the replays traced in a --trace 1 run


class Driver:
    def __init__(self, cfg, traffic, seed, device, seconds):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.F = int(traffic["frames"])
        self.opts = dict(cfg["trackers"]["scan_to_scan"])

    def setup(self):
        from icp4dradar_tpu_torch.config import PipelineConfig
        from icp4dradar_tpu_torch.io.scan import RadarScan

        self.pcfg = PipelineConfig.from_dict(self.cfg["pipeline"])
        st = synth.make_streams(loops.sequence_params(self.cfg), 1, self.F, self.seed,
                                self.device)
        H = self.pcfg.doppler.num_hypotheses
        self.uniforms = loops.draws(self.seed, 3, (self.F, 2, H), self.device)
        self.ref_inputs = (st.streams(slice(None)), self.uniforms.clone())
        self.scans = loops.port_scans(st, RadarScan)[0]
        self._replay()                                   # warm-up: every shape

    def _replay(self):
        from icp4dradar_tpu_torch.models.scan_to_scan import run_scan_to_scan

        return run_scan_to_scan(self.scans, self.pcfg, uniforms=self.uniforms, **self.opts)

    def window(self, seconds, tracer) -> Window:
        launch_sets = []

        def unit(k):
            out = self._replay()
            host = torch.cat([out.world_T.flatten(1), out.icp_transform.flatten(1),
                              out.velocity, out.iterations[:, None].float()], 1).cpu()
            if k in PROFILED and tracer is not None:
                launch_sets.append(host[:, -1].long().tolist())
            return host

        loop = loops.closed_loop(seconds, unit, tracer, PROFILED)
        self.outs = [h for h, t in zip(loop.results, loop.completions) if t <= loop.close]
        counters = {}
        if tracer is not None:
            live = self.scans.mask.sum(-1).long().tolist()
            N = int(self.scans.xyz.shape[1])
            counters = {"profiled_scans": self.F * len(launch_sets),
                        "k1_launch_sets": [(its, live, [live[0]] + live[:-1], N, N)
                                           for its in launch_sets]}
        lost = sum(int((~torch.isfinite(h[:, :16])).any(dim=-1).sum()) for h in loop.results)
        return Window(metrics={"scans_per_s": rate(self.F, loop.t0, loop.completions,
                                                   loop.close)},
                      attempted=self.F * loop.attempted, failed=lost, counters=counters)

    def release(self):
        del self.scans, self.uniforms

    def reference(self, control=False):
        from radarbench.reference import s2s

        st, u = self.ref_inputs
        return s2s.run(st, u, self.cfg, self.opts, tf32=control)

    def check(self, lim, control=False):
        ref = {k: v.cpu() for k, v in self.reference(control).items()}
        gaps = dict.fromkeys(("velocity_gap", "rel_gap_m", "pose_gap_m", "track_rpe_m"),
                             float("inf"))
        if self.outs:                       # every whole replay of the window
            prog = torch.stack(self.outs)
            world = prog[..., :16].unflatten(-1, (4, 4))
            rel = prog[..., 16:32].unflatten(-1, (4, 4))
            vel = prog[..., 32:35]
            gaps = {"velocity_gap": compare.vector_gap(vel, ref["velocity"].expand(vel.shape)),
                    "rel_gap_m": compare.translation_gap(rel, ref["icp_transform"].expand(
                        rel.shape)),
                    "pose_gap_m": compare.translation_gap(world, ref["world_T"].expand(
                        world.shape)),
                    # the track of what is judged: the control's own where it stands in
                    "track_rpe_m": compare.track_rpe(ref["world_T"] if control else world,
                                                     self.ref_inputs[0].gt[0].cpu())}
        return [compare.check(k, v, lim[k]) for k, v in gaps.items()]
