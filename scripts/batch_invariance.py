"""Does a row's result depend on the batch computed beside it?

Prints, for row 0 of a batch of n (n = 2, 4, 37, 1024) against a batch of
one, whether the bits agree (and the largest difference where they do
not): torch's `@` on 4x4 and 3x3 factors, a (2048, 3) @ (3, 3) point
transform, torch.sum over 2048 values and over a sweep's 32 float64 block
rows (the reduction K4's finish used), and the port's batch-stable forms
of the same (`geom.linalg.small_matmul`, `small_matvec`, `pairwise_sum`).
The streams of `run_scan_to_map_batch` equal their single-stream runs bit
for bit only where every such product and sum on the path is stable.

    python scripts/batch_invariance.py [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from icp4dradar_tpu_torch.geom.linalg import (  # noqa: E402
    pairwise_sum,
    small_matmul,
    small_matvec,
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    dev = torch.device(ap.parse_args(argv).device)
    g = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, device=dev, generator=g) * scale

    A4, B4, A3, B3 = rnd(1024, 4, 4), rnd(1024, 4, 4), rnd(1024, 3, 3), rnd(1024, 3, 3)
    v3, pts, rows = rnd(1024, 3), rnd(1024, 2048, 3, scale=30.0), rnd(1024, 32, 30).double()
    cases = {
        "torch @ 4x4": lambda n: A4[:n] @ B4[:n],
        "torch @ 3x3": lambda n: A3[:n] @ B3[:n],
        "torch @ points": lambda n: pts[:n] @ A3[:n],
        "torch.sum 2048": lambda n: pts[:n, :, 0].sum(-1),
        "torch.sum 32 float64 rows": lambda n: rows[:n].sum(1),
        "small_matmul 4x4": lambda n: small_matmul(A4[:n], B4[:n]),
        "small_matmul 3x3": lambda n: small_matmul(A3[:n], B3[:n]),
        "small_matvec 3x3": lambda n: small_matvec(A3[:n], v3[:n]),
        "small_matmul points": lambda n: small_matmul(pts[:n], A3[:n]),
        "pairwise_sum 2048": lambda n: pairwise_sum(pts[:n, :, 0]),
        "pairwise_sum 32 float64 rows": lambda n: pairwise_sum(rows[:n], dim=1),
    }
    for name, fn in cases.items():
        one = fn(1)
        res = []
        for n in (2, 4, 37, 1024):
            got = fn(n)[:1]
            res.append(f"n={n} " + ("equal" if torch.equal(got, one) else
                                     f"differs by {(got - one).abs().max().item():.3e}"))
        print(f"[invariance] {dev.type} {name}: " + ", ".join(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
