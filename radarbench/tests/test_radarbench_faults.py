"""A run whose timed path is broken underneath comes out not correct: the
harness's look for a card skipped, everything else of a run driven on the
CPU at a tiny size, one fault of the port at a time, where the answers are
produced. The cells run on one chip and exchange nothing between chips, so
that fault does not apply."""

import dataclasses

import pytest
import torch

from radarbench.harness import run_cell


def quiet(*a, **k):
    pass


def _replace_poses(out, poses):
    return dataclasses.replace(out, world_T=poses)


def fleet_faults(real):
    def unchanged(scans, *a, **kw):        # the tracker leaves every pose where it started
        state, out = real(scans, *a, **kw)
        eye = torch.eye(4).expand(out.world_T.shape).clone()
        return state, _replace_poses(out, eye)

    def half_batch(scans, *a, **kw):       # half of the streams left out, the rest copied
        state, out = real(scans, *a, **kw)
        B = out.world_T.shape[0]
        w = out.world_T.clone()
        w[B // 2:] = w[:B - B // 2]
        return state, _replace_poses(out, w)

    def altered(scans, *a, **kw):          # one answer of every stream altered
        state, out = real(scans, *a, **kw)
        w = out.world_T.clone()
        w[:, -1, 0, 3] += 0.05
        return state, _replace_poses(out, w)

    return {"unchanged": unchanged, "half_batch": half_batch, "altered": altered}


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_scan_to_map_fault_is_caught(tiny, monkeypatch, fault):
    import icp4dradar_tpu_torch.models.scan_to_map as s2m

    broken = fleet_faults(s2m.run_scan_to_map_batch)[fault]
    monkeypatch.setattr(s2m, "run_scan_to_map_batch", broken)
    r = run_cell(tiny, "fleet-dense4096", 4242, 6.0, False, torch.device("cpu"), 0.0, log=quiet)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_scan_to_scan_fault_is_caught(tiny, monkeypatch, fault):
    import icp4dradar_tpu_torch.models.scan_to_scan as s2s

    real = s2s.run_scan_to_scan

    def broken(scans, *a, **kw):
        out = real(scans, *a, **kw)
        F = out.world_T.shape[0]
        rel, world = out.icp_transform.clone(), out.world_T.clone()
        if fault == "unchanged":           # every frame left at the start pose
            world = torch.eye(4).expand(world.shape).clone()
            rel = torch.eye(4).expand(rel.shape).clone()
        elif fault == "half_batch":        # half of the frame pairs left out
            rel[F // 2:] = torch.eye(4)
        else:                              # one answer altered
            rel[F // 3, 0, 3] += 0.05
        return dataclasses.replace(out, icp_transform=rel, world_T=world)

    monkeypatch.setattr(s2s, "run_scan_to_scan", broken)
    r = run_cell(tiny, "s2s-dense4096", 4242, 2.0, False, torch.device("cpu"), 0.0, log=quiet)
    assert not r["correct"], r["checks"]


def test_a_fault_the_reference_shares_is_caught_by_the_track(tiny, monkeypatch):
    """The reference is a copy of the port's algorithm: a fault in both
    leaves every gap to it at 0, and only the track against the ground
    truth sees it. Here both chain their poses with every step tripled."""
    import icp4dradar_tpu_torch.models.scan_to_scan as s2s

    from radarbench.reference import s2s as ref_s2s

    def tripled(world):
        world = world.clone()
        world[..., :3, 3] *= 3.0
        return world

    real, real_ref = s2s.run_scan_to_scan, ref_s2s.run

    def broken(scans, *a, **kw):
        out = real(scans, *a, **kw)
        return dataclasses.replace(out, world_T=tripled(out.world_T))

    def broken_ref(*a, **kw):
        out = real_ref(*a, **kw)
        return dict(out, world_T=tripled(out["world_T"]))

    monkeypatch.setattr(s2s, "run_scan_to_scan", broken)
    monkeypatch.setattr(ref_s2s, "run", broken_ref)
    r = run_cell(tiny, "s2s-dense4096", 4242, 2.0, False, torch.device("cpu"), 0.0, log=quiet)
    assert not r["correct"], r["checks"]
    assert r["checks"]["pose_gap_m"]["value"] == 0.0
    assert r["checks"]["track_rpe_m"]["value"] > r["checks"]["track_rpe_m"]["limit"]
