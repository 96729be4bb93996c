"""The plain reference against the port at a tiny size on the CPU: each
cell's whole run (set-up, window, check) comes out correct, every gap 0
(on the CPU both run the same plain operations)."""

import pytest
import torch

from radarbench.harness import run_cell

# window seconds: long enough for a tiny fleet replay to complete on the CPU
CELLS = {"fleet-dense4096": 6.0, "s2s-dense4096": 2.0}


def quiet(*a, **k):
    pass


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_reference_agrees_with_the_port(tiny, cell, trace):
    r = run_cell(tiny, cell, 2**31 + 17, CELLS[cell], bool(trace), torch.device("cpu"), 0.0,
                 log=quiet)
    assert r["correct"], r["checks"]
    # every gap to the reference 0; the track's error against the ground truth within its limit
    assert all(c["value"] == 0.0 for n, c in r["checks"].items() if n != "track_rpe_m"), r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    want = ({m["name"] for m in tiny.metrics_for("end_to_end", cell)} if not trace else set())
    assert want <= set(r["metrics"])


def test_reference_streams_stand_alone(tiny):
    """A stream of the blocked batch tracks alike alone and in a batch: the
    order the seed gives the fleet's streams changes no stream's answer."""
    from radarbench import loops, synth
    from radarbench.reference import s2m

    cfg = tiny.config("dense4096")
    st = synth.make_streams(loops.sequence_params(cfg), 3, 24, 9, "cpu")
    u = loops.draws(9, 1, (3, 24, 3 * 152), "cpu")
    opts = cfg["trackers"]["blocked_batch"]
    whole = s2m.blocked_batch(st, u, cfg, opts)
    one = s2m.blocked_batch(synth.Streams(*(x[1:2] for x in st.__dict__.values())), u[1:2],
                            cfg, opts)
    assert torch.equal(whole[1:2], one)
