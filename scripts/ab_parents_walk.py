"""A/B of kernel J (the parent check) and kernel L's plain walk against a
parent's kernel L, at the step's own uses, on one CUDA GPU.

    python3 scripts/ab_parents_walk.py PARENT_SRC_DIR [num_ptcls] [OUT_JSON]

PARENT_SRC_DIR holds the parent's ``locate.cu`` (``git show
HEAD:pumipic_torch/kernels/csrc/locate.cu > chip_tree/parent_csrc/locate.cu``);
it is built with the package's flags into a library of its own, whose
``pp_walk_locate`` with no cell rows is the parent's plain walk.  The
cases, on ``chip_smoke.py``'s phase-c state (the 120k mesh, bench_torch's
``num_ptcls`` seeded particles, pushed once and located by the peel):

- ``J``: ``check_initial_parents`` at the 2D path's parents, "delete" and
  "repair", 0% and 1% bad (phase c's case 6: 1% of the claims random,
  plus 100 ids out of range and 100 NaN origins), beside its plain version
  and the parent's code (kernel G's row gather, the test on its strided
  columns, the elementwise ops, the column copies and the parent's walk);
- ``(a)`` the repair walk alone over J's bad parents, 0% and 1%: kernel L's
  plain walk in place against the parent's walk (full outputs), alone and
  with the parent's copies and its ``where``/sum around it;
- ``(b)`` the picparts lost check: rank 0's 3.75M slots of the 4-rank 120k
  arm after one push and the local walk (``chip_smoke.x2_step_case``),
  the removed particles walked on the global mesh from their previous
  element, budget ``gmesh.nelems`` (at step 1 behind phase e's 12-layer
  buffer few leave: mostly the sweep; the step's own walkers are timed by
  ``scripts/profile_picparts.py``), every slot written and, as the step
  runs it, the counts alone (``walk_locate_count``) against the parent's
  walk and sum;
- ``(c)`` the gyro map's ring points (1,481,280 on the 120k mesh), dense,
  budget 100 (every slot written: the first version's kernel, which the
  sparse kernel did not beat there);
- ``peel``: the main path's peel + walk (kernel L's other form), this
  checkout's build against the parent's.

Every version must equal the plain version (``walk_locate_plain``,
``walk_locate_into_plain``, ``check_parents_plain``) bit for bit.  Times
are device-only (``chip_smoke.device_ms``, warm), in turns: parent, new,
new, parent.  Each case prints one JSON line (times, walkers, the rows
the walk reads and the bound: the bytes over 3.35 TB/s, the table's part
the distinct rows read); the last line is the card.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402

ROW_BYTES = 48
REPS = 20


def build_locate(src: str, name: str):
    """``src`` (a locate.cu) in a library of its own; returns (lib, ptxas
    report)."""
    from pumipic_torch.kernels import _build

    out = _build.BUILD_DIR / f"ab_{name}"
    out.mkdir(parents=True, exist_ok=True)
    obj, lib_path = out / "locate.o", out / "lib.so"
    res = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
                          "-c", "-o", str(obj), src], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc ({name}):\n{res.stderr}")
    subprocess.run([_build.nvcc_path(), "-shared", "-o", str(lib_path), str(obj)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.pp_walk_locate.argtypes = _build.SIGNATURES["pp_walk_locate"]
    lib.pp_walk_locate.restype = ctypes.c_int
    return lib, res.stderr


def parent_walk(lib, geom, dx, dy, start, act, max_iters, grid=None):
    """The parent's kernel L as its ``walk_locate`` launched it (contiguous
    destination columns, every slot written)."""
    from pumipic_torch.kernels import stream_handle

    P = ctypes.c_void_p
    n = dx.shape[0]
    elem = torch.empty(n, dtype=torch.int32, device=dx.device)
    out = torch.empty(n, dtype=torch.bool, device=dx.device)
    stats = torch.zeros(2, dtype=torch.int32, device=dx.device)
    rows, it0 = None, 0
    ox, oy, ihx, ihy, nx, ny = 0.0, 0.0, 0.0, 0.0, 1, 1
    if grid is not None:
        rows, it0 = grid.cell_rows.data_ptr(), 1
        (ox, oy), (ihx, ihy), nx, ny = grid.origin, grid.inv_h, grid.nx, grid.ny
    err = lib.pp_walk_locate(P(dx.data_ptr()), P(dy.data_ptr()), P(start.data_ptr()),
                             P(act.data_ptr()), P(geom.data_ptr()), geom.shape[0], P(rows),
                             P(None), ox, oy, ihx, ihy, nx, ny, max_iters, it0,
                             P(elem.data_ptr()), P(out.data_ptr()), P(stats.data_ptr()), n,
                             P(stream_handle()))
    if err:
        raise RuntimeError(f"parent kernel L: cudaError {err}")
    return elem, out, stats[0] + it0, stats[1] == 0


def parent_check(lib, mesh, x, elem_init, active, mode, max_iters=32):
    """The parent's ``check_initial_parents`` (2D, no locator) with its own
    kernel L: G's row gather, the test on the gathered rows' columns, the
    column copies, the walk, the where and the sums."""
    from pumipic_torch.ops import search as se
    from pumipic_torch.ops.rows import row_gather

    orig = se._components(x)
    e_raw = elem_init.to(torch.int32)
    in_table = (e_raw >= 0) & (e_raw < mesh.nelems)
    e_safe = torch.clamp(e_raw, 0, mesh.nelems - 1)
    g = row_gather(mesh.walk_geom, e_safe)
    inside = se.bary_inside(*g[:, 0:6].unbind(1), *orig)[3]
    bad = active & (~inside | ~in_table)
    num_bad = bad.sum().to(torch.int32)
    zero = torch.zeros((), dtype=torch.int32, device=e_raw.device)
    if mode == "delete":
        return torch.where(active & ~bad, e_safe, se.INVALID), num_bad, zero
    dx, dy = se._components(se._rows_of(x))
    res = parent_walk(lib, mesh.walk_geom, dx, dy, e_safe, bad, max_iters)[0]
    repaired = bad & (res >= 0)
    elem = torch.where(bad, res, torch.where(active, e_safe, se.INVALID))
    return elem, num_bad, repaired.sum().to(torch.int32)


def equal(what: str, got, want) -> None:
    bad = cs.mismatches(got, want)
    if bad or cs.max_err(got, want) != 0.0:
        raise AssertionError(f"{what}: {bad} mismatches against the plain version")


def in_turns(fns: dict, reps: int = REPS) -> dict:
    """Device ms of each version: parent, new, new, parent (or the given
    order and its reverse)."""
    names = list(fns)
    out = {k: [] for k in names}
    for k in names + names[::-1]:
        out[k].append(cs.device_ms(fns[k], reps))
    return out


def report(case: dict) -> None:
    print(json.dumps(case), flush=True)


def walk_case(name, lib, mesh_geom, dx, dy, start, walkers, max_iters, full, results,
              plain_reps=2, counts=False):
    """(a), (b), (c): the new plain walk (in place unless ``full``) and the
    parent's, each against its plain version, then timed in turns."""
    from pumipic_torch.ops import search as se

    n, dev = walkers.shape[0], walkers.device
    w = int(walkers.sum())
    if full:
        new = lambda: se.walk_locate(mesh_geom, dx, dy, start, walkers, max_iters)  # noqa: E731
        want = se.walk_locate_plain(mesh_geom, dx, dy, start, walkers, max_iters)
        equal(f"{name} new", new(), want)
        plain = lambda: se.walk_locate_plain(mesh_geom, dx, dy, start, walkers, max_iters)  # noqa: E731
    else:
        base = torch.where(walkers, -1, start).to(torch.int32)
        e_new, s_new = base.clone(), torch.zeros(4, dtype=torch.int32, device=dev)
        se.walk_locate_into(mesh_geom, dx, dy, start, walkers, max_iters, e_new, s_new)
        e_pl, s_pl = base.clone(), torch.zeros(4, dtype=torch.int32, device=dev)
        se.walk_locate_into_plain(mesh_geom, dx, dy, start, walkers, max_iters, e_pl, s_pl)
        equal(f"{name} new (in place)", (e_new, s_new), (e_pl, s_pl))
        stats = torch.zeros(4, dtype=torch.int32, device=dev)
        new = lambda: se.walk_locate_into(mesh_geom, dx, dy, start, walkers,  # noqa: E731
                                          max_iters, e_new, stats)
        plain = lambda: se.walk_locate_into_plain(mesh_geom, dx, dy, start,  # noqa: E731
                                                  walkers, max_iters, e_pl, s_pl)
    cx, cy = dx.contiguous(), dy.contiguous()
    got_p = parent_walk(lib, mesh_geom, cx, cy, start, walkers, max_iters)
    equal(f"{name} parent", got_p, se.walk_locate_plain(mesh_geom, cx, cy, start, walkers,
                                                        max_iters))
    old = lambda: parent_walk(lib, mesh_geom, cx, cy, start, walkers, max_iters)  # noqa: E731
    fns = {"parent": old, "new": new}
    if counts:        # the lost check's counts: the parent's sum against none
        got = se.walk_locate_count(mesh_geom, dx, dy, start, walkers, max_iters)
        equal(f"{name} counts only", got, ((want[0] >= 0).sum(dtype=torch.int32), want[3]))
        fns["parent + sum"] = lambda: (old()[0] >= 0).sum(dtype=torch.int32)
        fns["new counts only"] = lambda: se.walk_locate_count(mesh_geom, dx, dy, start,
                                                              walkers, max_iters)
    if not full:      # the parent's repair: copies, its walk, the where and the sum
        def old_path():
            ax, ay = dx.contiguous(), dy.contiguous()
            res = parent_walk(lib, mesh_geom, ax, ay, start, walkers, max_iters)[0]
            return torch.where(walkers, res, start), (walkers & (res >= 0)).sum()
        fns["parent path"] = old_path
    t = in_turns(fns)
    steps, distinct = cs.plain_walk_rows(mesh_geom, dx, dy, start, walkers, max_iters)
    rows = int(steps.sum())
    moved = n + w * (8 + 4 + 4) + distinct * ROW_BYTES + (n * 5 if full else 0)
    case = {"case": name, "slots": n, "walkers": w, "rows": rows,
            "rows_per_walker": rows / max(w, 1), "distinct_rows": distinct,
            "full_outputs": full, "ms": t, "plain_ms": cs.device_ms(plain, plain_reps),
            "bound_ms": moved / cs.PEAK_BYTES_PER_S * 1e3}
    report(case)
    results.append(case)


def run(lib, dev, num_ptcls: int) -> list:
    """Every case on ``dev`` against the parent's kernel L in ``lib``."""
    from pumipic_torch.mesh.core import Mesh2D
    from pumipic_torch.models import pseudo_xgcm as px
    from pumipic_torch.ops import search as se
    from pumipic_torch.parallel import picparts as ppm
    import count_walk_steps as cw

    mesh, grid, x, elem, active = cw.located_2d(dev, num_ptcls)
    n = x.shape[0]
    results = []
    geom = mesh.walk_geom
    # J at the 2D path's parents: 0% and 1% bad
    gen = torch.Generator(dev).manual_seed(7)
    claim = elem.clone()
    bad = torch.rand(n, generator=gen, device=dev) < 0.01
    claim[bad] = torch.randint(0, mesh.nelems, (int(bad.sum()),), generator=gen, device=dev,
                               dtype=torch.int32)
    claim[:100] = mesh.nelems + 3
    xb = x.clone()
    xb[100:200] = float("nan")
    for share, c, xx in (("0%", elem, x), ("1%", claim, xb)):
        for mode in ("delete", "repair"):
            got = se.check_initial_parents(mesh, xx, c, active, mode)
            equal(f"J {mode} {share}", got, se.check_parents_plain(mesh, xx, c, active, mode))
            equal(f"parent check {mode} {share}", parent_check(lib, mesh, xx, c, active, mode),
                  got)
            t = in_turns({"parent": lambda: parent_check(lib, mesh, xx, c, active, mode),
                          "new": lambda: se.check_initial_parents(mesh, xx, c, active, mode)},
                         reps=10)
            act = int(active.sum())
            case = {"case": f"check_initial_parents {mode}, {share} bad", "slots": n,
                    "num_bad": int(got[1]), "num_repaired": int(got[2]), "ms": t,
                    "j_alone_ms": cs.device_ms(
                        lambda: se.check_parents(mesh, xx, c, active, mode == "repair"), REPS),
                    "plain_ms": cs.device_ms(
                        lambda: se.check_parents_plain(mesh, xx, c, active, mode), 2),
                    "j_bound_ms": (n * (4 + 1 + 4 + (1 if mode == "repair" else 0)) + act * 8
                                   + mesh.nelems * 24) / cs.PEAK_BYTES_PER_S * 1e3}
            report(case)
            results.append(case)
    # (a) the repair walk over J's bad parents
    for share, c, xx in (("0%", elem, x), ("1%", claim, xb)):
        _, badm, _ = se.check_parents(mesh, xx, c, active, True)
        walk_case(f"(a) repair walk, {share} bad", lib, geom, *xx.unbind(1), c, badm, 32,
                  False, results)
    del claim, xb, bad
    # (c) the gyro map's ring points, dense
    cfg = px.XGCmConfig(num_ptcls=n, mdl_face=max(int(mesh.class_id.max()) // 2, 2),
                        deg_per_push=15.0, max_search_iters=64)
    gpx, gpy, gstart = (t.to(dev) for t in px.gyro_ring_points(mesh, cfg.gyro))
    gact = torch.ones(gpx.shape[0], dtype=torch.bool, device=dev)
    walk_case("(c) ring points", lib, geom, gpx, gpy, gstart.to(torch.int32), gact, 100,
              True, results)
    # the peel + walk, this build against the parent's
    tx, ty = x[:, 0].contiguous(), x[:, 1].contiguous()
    pe = lambda: se.walk_locate(geom, tx, ty, elem, active, 64, grid=grid)  # noqa: E731
    po = lambda: parent_walk(lib, geom, tx, ty, elem, active, 64, grid)  # noqa: E731
    equal("peel", pe(), po())
    case = {"case": "peel + walk", "slots": n, "ms": in_turns({"parent": po, "new": pe})}
    report(case)
    results.append(case)
    del tx, ty, x, elem, active, gpx, gpy, gstart, gact
    torch.cuda.empty_cache()
    # (b) the picparts lost check on rank 0's slots (step 1 of phase e's arm:
    # the walkers are the particles the push took off the picpart)
    gm = cs.exchange_mesh()
    coords, tris, cls, _ = gm
    gmesh = Mesh2D.from_numpy(ppm.mesh_arrays(2, coords, tris, cls), "cpu").to(dev)
    lpp = cs.exchange_picpart(dev, gm)
    state, _, new_elem, prev_elem, prev_active = cs.x2_step_case(dev, lpp, gm, prev=True)
    removed = prev_active & (new_elem < 0)
    g_start = lpp.elem_gid[torch.clamp(prev_elem, min=0).long()].to(torch.int32)
    walk_case("(b) picparts lost check", lib, gmesh.walk_geom, state["x0"], state["x1"],
              g_start, removed, gmesh.nelems, True, results, plain_reps=1, counts=True)
    return results


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("parent_dir")
    ap.add_argument("num_ptcls", nargs="?", type=int, default=cs.NUM_PTCLS)
    ap.add_argument("out_json", nargs="?")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    smi = cs.smi_query("name,power.limit", units=True)
    from pumipic_torch.kernels import _build

    _build.build(verbose=True)
    for src in ("locate.cu", "parents.cu"):
        print(f"ptxas {src}: {json.dumps(cs.ptxas_functions(_build.REPORTS.get(src, '')))}")
    lib, rep = build_locate(os.path.join(args.parent_dir, "locate.cu"), "parent_locate")
    print(f"ptxas parent locate.cu: {json.dumps(cs.ptxas_functions(rep))}", flush=True)
    results = run(lib, torch.device("cuda"), args.num_ptcls)
    print(smi, flush=True)
    if args.out_json:
        os.makedirs(os.path.dirname(os.path.abspath(args.out_json)), exist_ok=True)
        with open(args.out_json, "w") as f:
            json.dump({"card": smi, "cases": results}, f, indent=1)


if __name__ == "__main__":
    main()
