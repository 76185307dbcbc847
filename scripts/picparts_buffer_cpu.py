"""Particles lost off the picparts against the BFS buffer's depth, on the CPU:

    python3 scripts/picparts_buffer_cpu.py MESH LAYERS...

Runs bench_torch's picparts mode (15°/push, the balancer, cap factor 1.5,
200k particles, 1 + 3 steps) as 4 gloo CPU ranks on MESH (``annulus``: the
23,976-triangle annulus; ``120k``: data/xgc_like_120k.msh.gz) once for
each buffer depth in LAYERS, and prints each step's (alive, boundary
exits, lost off the picparts, sent)."""
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from pumipic_torch.parallel import group  # noqa: E402

mesh = sys.argv[1]
layers = [int(a) for a in sys.argv[2:]]
base = dict(num_ptcls=200_000, iters=3, cap_factor=1.5)
if mesh == "annulus":
    base.update(mesh_path="annulus", mesh_elems=24000)
else:
    base.update(mesh_path=os.path.join(ROOT, "data", "xgc_like_120k.msh.gz"))
t0 = time.time()
out = group.launch("bench_torch:picparts_runs", 4,
                   {"runs": [dict(base, buffer_layers=b) for b in layers]},
                   backend="gloo", device="cpu", timeout=3000)
for i, b in enumerate(layers):
    print(mesh, "buffer", b, [(int(st["alive"]), int(st["exits"]), int(st["lost"]),
                              int(st["sent"])) for st, _, _ in out[0][i]["history"]])
print(f"{time.time() - t0:.1f} s")
