"""The reshuffle-or-rebuild's branch on the pps3d box:

    python3 scripts/reshuffle_share.py PARTICLES STEPS DISTANCE... [--cuda]

Runs bench_torch's pps3d mode (``box_tet_mesh(16, 16, 16)``, Kuhn locate,
periodic wall) with the Sell-C-σ and CabM structures and
``rebuild="auto"`` (extra padding 0.15) on the CPU, for each push
DISTANCE, and prints each step's mover share (movers over particles), the
mover budget's share and whether the reshuffle fits (kernel U1's plain
version, ``ops.rebuild.reshuffle_count``, observed at each call); with
``--cuda``, on the card (kernel U1)."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench_torch  # noqa: E402
from pumipic_torch.ops import rebuild as rebuild_ops  # noqa: E402

args = [a for a in sys.argv[1:] if a != "--cuda"]
device = "cuda" if "--cuda" in sys.argv else "cpu"
n, steps = int(args[0]), int(args[1])
distances = [float(a) for a in args[2:]]
seen = []
real = rebuild_ops.reshuffle_count


def observed(elem, old_elem, seg_cap, mover_budget):
    out = real(elem, old_elem, seg_cap, mover_budget)
    seen.append((*out.info.tolist(), mover_budget))
    return out


rebuild_ops.reshuffle_count = observed
for structure in ("scs", "cabm"):
    for d in distances:
        seen.clear()
        _, ps, step, _ = bench_torch.setup_pps3d(device, num_ptcls=n, structure=structure,
                                                 kuhn="auto", distance=d, rebuild="auto")
        for _ in range(steps):
            ps, _ = step(ps)
        shares = [f"{m / n:.4f}{'' if f else ' (sort)'}" for f, m, _ in seen]
        print(f"{structure} d={d}: {n} particles, capacity {ps.capacity}, budget "
              f"{seen[0][2] / n:.4f} of the particles; mover share a step: "
              + ", ".join(shares)
              + f"; fits {sum(f for f, _, _ in seen)} of {len(seen)} steps", flush=True)
