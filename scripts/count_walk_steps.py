"""Walk steps a particle takes in kernel M's cases: the rows its walk reads.

    python3 scripts/count_walk_steps.py [num_ptcls] [device]

Counts, with M's plain version (``trace_3d_plain``, the same walk as the
kernel's), the tet rows the walk reads per particle: on the GITR-style
app's seeded state (the 32^3 box, seeded as ``scripts/ab_boris_trace3d.py``
seeds it, default 200,000 particles) toward R's targets in the
intersection and BCC cores with the reflecting wall and ``record_exit``,
and toward far targets (random points of the box, 200 steps).  A count,
not a time: the default device is the CPU.  Prints one JSON line per case.
"""
from __future__ import annotations

import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench_torch  # noqa: E402
from pumipic_torch.mesh.core import Mesh3D  # noqa: E402
from pumipic_torch.mesh.generate import box_tet_mesh  # noqa: E402
from pumipic_torch.models.gitr_like import GitrConfig, GitrLike  # noqa: E402
from pumipic_torch.ops import push as push_ops  # noqa: E402
from pumipic_torch.ops import search as se  # noqa: E402


def counted(cores: dict) -> dict:
    """Wrap each core of the plain walk so that it counts the rows it is
    given; returns the counts."""
    rows = {}
    for core, (fn, nb) in list(cores.items()):
        def wrap(g, *args, _fn=fn, _core=core, **kw):
            rows[_core] = rows.get(_core, 0) + g.shape[0]
            return _fn(g, *args, **kw)
        cores[core] = (wrap, nb)
    return rows


def main() -> None:
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 200_000
    dev = sys.argv[2] if len(sys.argv) > 2 else "cpu"
    mesh = Mesh3D.from_arrays(*box_tet_mesh(32, 32, 32), device=dev)
    grid, o, h = bench_torch.gitr_field(32)
    cfg = GitrConfig(num_ptcls=n, dt=bench_torch.GITR_DT, b_field=bench_torch.GITR_B,
                     wall="reflect", max_search_iters=100)
    app = GitrLike(mesh, cfg, grid, o, h, seed=0, device=dev)
    s = app.state
    x_new, _ = push_ops.boris_push_grid(s["x"], s["v"], app.e_grid, app.e_origin,
                                        app.e_spacing, app.b_field, cfg.dt, cfg.charge,
                                        cfg.amu)
    far = torch.rand(n, 3, device=dev, generator=torch.Generator(dev).manual_seed(5))
    rows = counted(se._CORE_FNS)
    for name, method, dest, budget in (("gitr step", "intersection", x_new, 100),
                                       ("gitr step", "bcc", x_new, 100),
                                       ("far targets", "intersection", far, 200)):
        rows.clear()
        r = se.trace_3d_plain(mesh, s["x"], dest, s["elem"], s["active"], budget, method,
                              se.reflect_on_exit_3d, True)
        print(json.dumps({"case": name, "method": method, "particles": n,
                          "rows_per_particle": sum(rows.values()) / n,
                          "iters": int(r.iters),
                          "hit_share": int((r.num_hits > 0).sum()) / n}), flush=True)


if __name__ == "__main__":
    main()
