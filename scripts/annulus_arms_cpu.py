"""The port's picparts arms on the structured annulus, on the CPU:

    python3 scripts/annulus_arms_cpu.py [N]

Runs pseudoXGCm over BFS picparts (bench_torch's picparts knobs: the
23,976-triangle annulus, the balancer, cap factor 1.5, N particles, default
1M) as 4 gloo CPU ranks, with the analytic locate and the neighbour
exchange, with the world exchange, and with the walk (``analytic_locate=
"off"``), and prints each run's (alive, sent) after the warm-up and 3
timed steps.  scripts/annulus_arms_jax.py prints the JAX package's."""
import sys
import time

from pumipic_torch.parallel import group

N = int(sys.argv[1]) if len(sys.argv) > 1 else 1_000_000
base = dict(mesh_path="annulus", mesh_elems=24000, num_ptcls=N, iters=3, cap_factor=1.5)
runs = [dict(base), dict(base, neighbor_migration=False), dict(base, analytic_locate="off")]
t0 = time.time()
out = group.launch("bench_torch:picparts_runs", 4, {"runs": runs}, backend="gloo",
                   device="cpu", timeout=3000)
for i, name in enumerate(("analytic, neighbour", "analytic, world", "walk, neighbour")):
    print(name, [(int(st["alive"]), int(st["sent"])) for st, _, _ in out[0][i]["history"]])
print(f"{time.time() - t0:.1f} s")
