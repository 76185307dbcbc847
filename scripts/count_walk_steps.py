"""Walk steps a particle takes in kernel M's and kernel M2's cases: the rows
its walk reads, and for M2 the warp steps of its schedules.

    python3 scripts/count_walk_steps.py [num_ptcls] [device]
    python3 scripts/count_walk_steps.py 2d [num_ptcls] [device]
    python3 scripts/count_walk_steps.py L [num_ptcls] [device]

3D (M): counts, with M's plain version (``trace_3d_plain``, the same walk as
the kernel's), the tet rows the walk reads per particle: on the GITR-style
app's seeded state (the 32^3 box, seeded as ``scripts/ab_boris_trace3d.py``
seeds it, default 200,000 particles) toward R's targets in the
intersection and BCC cores with the reflecting wall and ``record_exit``,
and toward far targets (random points of the box, 200 steps).

2D (M2, ``2d``): the cases of ``chip_smoke.py``'s phase c on the 120k mesh
(default 1,000,000 particles: bench_torch's setup, one push and the peel +
walk, then :func:`chip_smoke.walker_targets`): reflect + record from the
plain start and through the peel, remove + record, far targets.  With
``trace_2d_plain`` it counts each particle's walk steps (one 48-byte
``walk_geom`` row each; the peel's cell row is not counted) and from them:

- ``lane_steps``: the steps of all particles, the rows the walk reads;
- ``warp_steps_first``: the first M2's schedule, one thread a particle over
  a grid-stride loop whose stride is a multiple of 32, so that each warp
  takes aligned tiles of 32 particles and waits for its longest walk: the
  sum over tiles of the tile's most steps (exact for that schedule);
- ``warp_steps_pool``: an estimate of the warp pool's schedule (M2_R0
  steps in the tile's round, then rounds of 32 pool walkers of at most
  M2_R steps each, one pool shared by the whole grid and taken in index
  order; the kernel keeps a pool per warp), for each (R0, R) of ``POOLS``.

``lane_steps / (32 · warp_steps)`` is the share of lanes that walk.

L (``L``): kernel L's plain walk at its step uses (``chip_smoke.py``'s
cases; default 10,000,000 particles): (a) the parent repair's walk over
the bad parents of phase c's located particles, 0% and 1% bad
(``chip_smoke.parent_claims``), budget 32; (b) the picparts lost check
(rank 0 of the 4-rank 120k arm after one push and the local walk,
``chip_smoke.x2_step_case``, at 3/8 of the particles' slots), budget the
global mesh's element count; (c) the gyro map's ring points, budget 100;
(d) the locator-less step's walk (``bench_torch.setup(use_locator=False)``:
the seeded particles pushed once by kernel P, each walked from its
element, budget 64).  Each case's walkers, the rows they read
(``chip_smoke.plain_walk_rows``, a 48-byte row a step; the lane steps) and
the distinct rows among them (the table's part of ``chip_smoke.py``'s
bound) give L's L2-row estimate, the rows' bytes over ``L2_BYTES_PER_S``:
an estimate, not a floor, since a warp's lanes that read one row share
its L1 line; ``warp_steps_first`` is the first plain walk's schedule (one
thread a slot, a warp waiting for its longest walk); for the dense cases
(c) and (d), ``warp_steps_dense`` is the dense walk's (the same lockstep
tiles of 32 slots, so the same count) and ``warp_steps_two_a_lane`` that
of two walkers a lane on tiles of 64 (a design that was tried and
withdrawn: each tile's longest walk, its rounds).

A count, not a time: the default device is the CPU.  Prints one JSON line
per case.
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench_torch  # noqa: E402
from pumipic_torch.mesh.core import Mesh3D  # noqa: E402
from pumipic_torch.mesh.generate import box_tet_mesh  # noqa: E402
from pumipic_torch.models.gitr_like import GitrConfig, GitrLike  # noqa: E402
from pumipic_torch.ops import push as push_ops  # noqa: E402
from pumipic_torch.ops import search as se  # noqa: E402

# (M2_R0, M2_R) of the pool estimate
POOLS = ((4, 16), (8, 16), (16, 16), (8, 32), (16, 32), (32, 32), (8, 64))
# an L2 read rate the card has reached: kernel M's far-target walk, its
# rows' bytes over its time (PERF.md, "L2-row")
L2_BYTES_PER_S = 4.8e12


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


def main_3d(n: int, dev: str) -> None:
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


def located_2d(dev, n: int):
    """Phase c's ``n`` located particles on the 120k mesh (bench_torch's
    configuration, one push, the peel + walk, all through the wrappers):
    returns (mesh, cartesian grid, x (N, 2), elem, active)."""
    import chip_smoke as cs
    from pumipic_torch.mesh.core import Mesh2D
    from pumipic_torch.mesh.gmsh import read_msh
    from pumipic_torch.models import pseudo_xgcm as px

    mesh = Mesh2D.from_arrays(*read_msh(cs.MESH), device=dev)
    cfg = px.XGCmConfig(num_ptcls=n, mdl_face=max(int(mesh.class_id.max()) // 2, 2),
                        deg_per_push=15.0, max_search_iters=64)
    s, step = px.make_dp_setup(mesh, cfg, dev)
    grid = step.model.locator
    tx, ty = cs._push(push_ops, s, step.model, cfg)[:2]
    elem, active = se.walk_locate(mesh.walk_geom, tx, ty, s["elem"], s["active"],
                                  cfg.max_search_iters, grid=grid)[:2]
    return mesh, grid, torch.stack([tx, ty], 1).contiguous(), elem, active


def walk_steps_2d(mesh, *args) -> torch.Tensor:
    """Each particle's walk steps in ``trace_2d_plain(mesh, *args)``: the
    plain walk's core is wrapped to count the walkers it is given (the
    loop's ``idx``, read from the caller's frame)."""
    n = args[1].shape[0]
    steps = torch.zeros(n, dtype=torch.int32, device=args[1].device)
    core = se._core_2d

    def count(*a, **kw):
        steps[sys._getframe(1).f_locals["idx"]] += 1
        return core(*a, **kw)

    se._core_2d = count
    try:
        se.trace_2d_plain(mesh, *args)
    finally:
        se._core_2d = core
    return steps


def warp_steps(steps: torch.Tensor) -> dict:
    """The counts of the module docstring from per-particle ``steps``."""
    s = steps.to(torch.int64).cpu().numpy()
    n = s.size
    tiles = np.pad(s, (0, -n % 32)).reshape(-1, 32)
    out = {"particles": n, "lane_steps": int(s.sum()),
           "rows_per_particle": float(s.mean()), "max_steps": int(s.max(initial=0)),
           "warp_steps_first": int(tiles.max(1).sum())}
    out["lanes_walking_first"] = out["lane_steps"] / (32 * out["warp_steps_first"])
    for r0, r in POOLS:
        first = int(np.minimum(tiles, r0).max(1).sum())
        rest = s[s > r0] - r0
        rounds = 0
        while rest.size:                  # rounds of 32 in index order
            g = np.pad(rest, (0, -rest.size % 32)).reshape(-1, 32)
            rounds += int(np.minimum(g, r).max(1).sum())
            rest = rest[rest > r] - r
        out[f"warp_steps_pool_r0_{r0}_r_{r}"] = first + rounds
    return out


def main_2d(n: int, dev: str) -> None:
    import chip_smoke as cs

    dev = torch.device(dev)
    mesh, grid, x, elem, active = located_2d(dev, n)
    gen = torch.Generator(dev).manual_seed(7)       # phase c's draws
    dest = cs.walker_targets(mesh, x, gen)
    lo, hi = mesh.coords.amin(0), mesh.coords.amax(0)
    far = (lo + (hi - lo) * torch.rand(x.shape, generator=gen, device=dev)).contiguous()
    it, far_it = cs.TRACE2D_ITERS, cs.TRACE2D_FAR_ITERS
    reflect, remove = se.reflect_on_exit_2d, se.remove_on_exit
    for name, args in (
            ("reflect+record, plain start", (x, dest, elem, active, it, reflect, True)),
            ("reflect+record, peel", (x, dest, elem, active, it, reflect, True, "off", grid)),
            ("remove+record, plain start", (x, dest, elem, active, it, remove, True)),
            ("far targets, reflect+record", (x, far, elem, active, far_it, reflect, True))):
        steps = walk_steps_2d(mesh, *args)
        print(json.dumps({"case": name, **warp_steps(steps)}), flush=True)


def main_l(n: int, dev: str) -> None:
    import chip_smoke as cs
    from pumipic_torch.mesh.core import Mesh2D
    from pumipic_torch.models import pseudo_xgcm as px
    from pumipic_torch.parallel import picparts as ppm

    dev = torch.device(dev)
    mesh, grid, x, elem, active = located_2d(dev, n)
    claim, xb = cs.parent_claims(mesh, x, elem, torch.Generator(dev).manual_seed(19))
    cases = []
    for share, c, xx in (("0%", elem, x), ("1%", claim, xb)):
        bad = active & (se.check_parents_plain(mesh, xx, c, active, "delete")[0] < 0)
        cases.append((f"(a) repair walk, {share} bad", mesh.walk_geom, *xx.unbind(1), c,
                      bad, 32))
    del claim, xb
    cfg = px.XGCmConfig(num_ptcls=n, mdl_face=max(int(mesh.class_id.max()) // 2, 2),
                        deg_per_push=15.0, max_search_iters=64)
    gpx, gpy, gstart = (t.to(dev) for t in px.gyro_ring_points(mesh, cfg.gyro))
    cases.append(("(c) ring points", mesh.walk_geom, gpx, gpy, gstart.to(torch.int32),
                  torch.ones(gpx.shape[0], dtype=torch.bool, device=dev), 100))
    _, st, step, _ = bench_torch.setup(dev, num_ptcls=n, mesh_path=cs.MESH, use_locator=False)
    tx, ty = push_ops.push_banded(st["x0"], st["x1"], st["cphi"], st["sphi"], st["b"],
                                  st["elem"], st["active"], step.model.rot, 0.0, 0.0, 0.9)[:2]
    cases.append(("(d) the locator-less step", mesh.walk_geom, tx, ty, st["elem"],
                  st["active"], 64))
    del st, step
    cs.NUM_PTCLS, cs.X_SLOTS = n, n * 3 // 8
    gm = cs.exchange_mesh()
    lpp = cs.exchange_picpart(dev, gm)
    state, _, new_elem, prev_elem, prev_active = cs.x2_step_case(dev, lpp, gm, prev=True)
    gmesh = Mesh2D.from_numpy(ppm.mesh_arrays(2, *gm[:3]), "cpu").to(dev)
    cases.append(("(b) picparts lost check", gmesh.walk_geom, state["x0"], state["x1"],
                  lpp.elem_gid[torch.clamp(prev_elem, min=0).long()].to(torch.int32),
                  prev_active & (new_elem < 0), gmesh.nelems))
    for name, *args in cases:
        steps, distinct = cs.plain_walk_rows(*args)
        w, rows = int(args[4].sum()), int(steps.sum())
        s = steps.to(torch.int64).cpu().numpy()
        tiles = np.pad(s, (0, -s.size % 32)).reshape(-1, 32)
        first = int(tiles.max(1).sum())
        dense = {}
        if name[:3] in ("(c)", "(d)"):
            two = np.pad(s, (0, -s.size % 64)).reshape(-1, 64)
            dense = {"warp_steps_dense": first,
                     "warp_steps_two_a_lane": int(two.max(1).sum())}
        print(json.dumps({"case": name, "slots": s.size, "walkers": w, "rows": rows,
                          "lane_steps": rows, **dense,
                          "distinct_rows": distinct,
                          "rows_per_walker": rows / max(w, 1), "max_steps": int(s.max(initial=0)),
                          "walks_of_at_most": {k: int(((s > 0) & (s <= k)).sum())
                                           for k in (1, 8, 30, 63)},
                          "warp_steps_first": first,
                          "lanes_walking_first": rows / max(32 * first, 1),
                          "l2_row_estimate_ms": rows * 48 / L2_BYTES_PER_S * 1e3}),
              flush=True)


def main() -> None:
    argv = sys.argv[1:]
    if argv[:1] == ["L"]:
        n = int(argv[1]) if len(argv) > 1 else 10_000_000
        main_l(n, argv[2] if len(argv) > 2 else "cpu")
    elif argv[:1] == ["2d"]:
        n = int(argv[1]) if len(argv) > 1 else 1_000_000
        main_2d(n, argv[2] if len(argv) > 2 else "cpu")
    else:
        n = int(argv[0]) if argv else 200_000
        main_3d(n, argv[1] if len(argv) > 1 else "cpu")


if __name__ == "__main__":
    main()
