"""A/B of kernel J (the parent check), the parent repair's walks in place
(kernel L's in 2D, L3's in 3D) and kernel L's plain walk against a
parent's sources, at the step's own uses, on one CUDA GPU.

    python3 scripts/ab_parents_walk.py PARENT_SRC_DIR [num_ptcls] [OUT_JSON]
        [--cases J,3d,dense3d,walk]

PARENT_SRC_DIR holds the parent's ``locate.cu``, ``parents.cu`` and
``locate3d.cu`` (``git show HEAD:pumipic_torch/kernels/csrc/locate.cu >
chip_tree/parent_csrc/locate.cu``, the same for the other two); they are
built with the package's flags into one library of its own, whose
``pp_check_parents`` reads ``walk_geom``'s rows (the parent's J), whose
``pp_walk_plain`` and ``pp_walk_locate_3d`` with no cell rows are the
parent's walks.  The cases (``--cases``, all by default), on ``chip_smoke.py``'s
phase-c state (the 120k mesh, bench_torch's ``num_ptcls`` seeded
particles, pushed once and located by the peel):

- ``J``: ``check_initial_parents`` at phase c's order (the seeding's,
  parents grouped), "delete" and "repair", 0% and 1% bad (phase c's case
  6: 1% of the claims random, plus 100 ids out of range and 100 NaN
  origins), and at the 2D path's own order (the parents and origins that
  one ``chip_smoke.trace2d_path_call`` leaves, and that ``PATH_CALLS``
  leave: scattered against slots), each
  beside its plain version and the parent's (its J on ``walk_geom``, then
  its L in place), J alone timed too, warm and after an L2 flush (a
  256 MB write before each call, only J timed), with its bound and the L2
  sectors a particle in each row layout (``chip_smoke.parent_sectors``)
  and their time at L2_ESTIMATE_BYTES_PER_S (an estimate, no bound);
- ``3d``: ``check_initial_parents("repair")`` on the 16^3 box at
  ``num_ptcls`` seeded particles (pseudoPushAndSearch's seeding), 0% and
  1% bad, origins as (N, 3) rows and as columns: a memset, J and L3's
  walk in place against the parent's J, L3's plain walk over J's mask
  (every slot written), a ``where``, a sum and, for columns, a stack;
  each version's device time split by launch (``torch.profiler``);
- ``dense3d``: L3's plain walk on a dense input, as ``search_mesh_3d``
  without a locator runs it (the 16^3 box's seeded particles pushed once
  by the app's push, every active particle from its tet, budget 64): the
  full-output kernel (``walk_locate_3d``) against the sparse schedule
  (``walk_locate_3d_into`` with every active particle a walker), alone
  and after the fill of the inactive slots' -1 it would need to stand in
  for the full output; both against ``walk_locate_3d_plain``;
- ``walk``: ``(a)`` the repair walk alone over J's bad parents, 0% and
  1%: kernel L's plain walk in place against the parent's sparse walk in
  place and its first-version walk (full outputs), alone and with its
  copies, ``where`` and sum;
  ``(b)`` the picparts lost check: rank 0's 3.75M slots of the 4-rank
  120k arm after one push and the local walk (``chip_smoke.x2_step_case``),
  the removed particles walked on the global mesh from their previous
  element, budget ``gmesh.nelems``, every slot written and, as the step
  runs it, the counts alone (``walk_locate_count``); ``(c)`` the gyro
  map's ring points (1,481,280 on the 120k mesh), dense, budget 100 (the
  first version's kernel); ``peel``: the main path's peel + walk.

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
CASES = ("J", "3d", "dense3d", "walk")
# the L2 rate kernel M reached on far targets (PERF.md): an achieved rate,
# so the L2-sector times are estimates, no bounds
L2_ESTIMATE_BYTES_PER_S = 4.8e12
FLUSH_BYTES = 256 << 20
PARENT_SOURCES = ("locate.cu", "parents.cu", "locate3d.cu")


def build_lib(srcs, name: str):
    """The sources ``srcs`` in one library of their own, with the
    package's flags; returns (lib, ptxas report)."""
    from pumipic_torch.kernels import _build

    out = _build.BUILD_DIR / f"ab_{name}"
    out.mkdir(parents=True, exist_ok=True)
    objs, report = [], ""
    for src in srcs:
        obj = out / (os.path.basename(src)[:-3] + ".o")
        res = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas",
                              "-v", "-c", "-o", str(obj), src], capture_output=True,
                             text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc ({name}, {src}):\n{res.stderr}")
        objs.append(str(obj))
        report += res.stderr
    lib_path = out / "lib.so"
    subprocess.run([_build.nvcc_path(), "-shared", "-o", str(lib_path), *objs], check=True)
    lib = ctypes.CDLL(str(lib_path))
    for fn in ("pp_walk_locate", "pp_walk_plain", "pp_check_parents", "pp_walk_locate_3d"):
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = _build.SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
    return lib, report


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


def parent_walk_into(lib, geom, dx, dy, start, walkers, max_iters, elem, stats):
    """The parent's kernel L sparse plain walk in place (its
    ``pp_walk_plain``), the counts added into ``stats``."""
    from pumipic_torch.kernels import stream_handle

    P = ctypes.c_void_p
    err = lib.pp_walk_plain(P(dx.data_ptr()), dx.stride(0), P(dy.data_ptr()), dy.stride(0),
                            P(start.data_ptr()), P(walkers.data_ptr()), P(geom.data_ptr()),
                            geom.shape[0], max_iters, P(elem.data_ptr()),
                            P(stats.data_ptr()), 0, walkers.shape[0], P(stream_handle()))
    if err:
        raise RuntimeError(f"parent kernel L (sparse): cudaError {err}")


def j_launch(lib, mesh, x, claim, active, mask: bool, geom):
    """``lib``'s kernel J on the rows ``geom`` (the parent's: ``walk_geom``;
    this checkout's: ``search.parent_rows`` in 2D),
    launched as ``search.check_parents`` does: (elem, bad, stats)."""
    from pumipic_torch.kernels import stream_handle
    from pumipic_torch.ops import search as se

    P = ctypes.c_void_p
    e = claim.to(torch.int32)
    n, dim, dev = e.shape[0], mesh.dim, e.device
    cols = se._columns(x)
    elem = torch.empty(n, dtype=torch.int32, device=dev)
    bad = torch.empty(n, dtype=torch.bool, device=dev) if mask else None
    stats = torch.empty(4, dtype=torch.int32, device=dev)
    origin = (P * 3)(*(c.data_ptr() for c in cols), *([None] * (3 - dim)))
    strides = (ctypes.c_longlong * 3)(*(c.stride(0) for c in cols), *([0] * (3 - dim)))
    err = lib.pp_check_parents(dim, P(e.data_ptr()), P(active.data_ptr()), origin, strides,
                               P(geom.data_ptr()), geom.shape[1], geom.shape[0],
                               P(elem.data_ptr()), P(None if bad is None else bad.data_ptr()),
                               P(stats.data_ptr()), n, P(stream_handle()))
    if err:
        raise RuntimeError(f"kernel J: cudaError {err}")
    return elem, bad, stats


def parent_check(lib, mesh, x, claim, active, mode, max_iters=32):
    """The parent's ``check_initial_parents`` (no locator) with its own
    kernels: J on ``walk_geom``; then in 2D L's sparse walk in place, in 3D
    L3's plain walk over J's mask (every slot written), a ``where``, a sum
    and, for column origins, a stack."""
    from pumipic_torch.kernels import stream_handle
    from pumipic_torch.ops import search as se

    P = ctypes.c_void_p
    geom = mesh.walk_geom
    elem, bad, stats = j_launch(lib, mesh, x, claim, active, mode == "repair", geom)
    if mode == "delete":
        return elem, stats[3], stats[2]
    start = claim.to(torch.int32)
    n = start.shape[0]
    if mesh.dim == 2:
        (dx, dy) = se._columns(x)
        err = lib.pp_walk_plain(P(dx.data_ptr()), dx.stride(0), P(dy.data_ptr()),
                                dy.stride(0), P(start.data_ptr()), P(bad.data_ptr()),
                                P(geom.data_ptr()), geom.shape[0], max_iters,
                                P(elem.data_ptr()), P(stats.data_ptr()), 0, n,
                                P(stream_handle()))
        if err:
            raise RuntimeError(f"parent kernel L: cudaError {err}")
        return elem, stats[3], stats[2]
    rows = se._rows_of(x)
    found = torch.empty(n, dtype=torch.int32, device=start.device)
    act = torch.empty(n, dtype=torch.bool, device=start.device)
    s3 = torch.zeros(2, dtype=torch.int32, device=start.device)
    oh = (ctypes.c_float * 6)(*((0.0,) * 6))
    err = lib.pp_walk_locate_3d(P(rows.data_ptr()), P(start.data_ptr()), P(bad.data_ptr()),
                                P(geom.data_ptr()), geom.shape[0], P(None), oh, 1, 1, 1,
                                max_iters, 0, P(found.data_ptr()), P(act.data_ptr()),
                                P(s3.data_ptr()), n, P(stream_handle()))
    if err:
        raise RuntimeError(f"parent kernel L3: cudaError {err}")
    return torch.where(bad, found, elem), stats[3], act.sum(dtype=torch.int32)


def split_by_launch(fn, reps: int = 5) -> dict:
    """Device ms a call of ``fn`` by device activity (kernels, memsets,
    copies), from ``torch.profiler`` over ``reps`` warm calls."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            name = ev.key.replace("(anonymous namespace)", "{anonymous}").split("(")[0][:60]
            out[name] = out.get(name, 0.0) + ev.self_device_time_total / 1e3 / reps
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def equal(what: str, got, want) -> None:
    bad = cs.mismatches(got, want)
    if bad or cs.max_err(got, want) != 0.0:
        raise AssertionError(f"{what}: {bad} mismatches against the plain version")


def cold_ms(fn, reps: int, flush: torch.Tensor) -> float:
    """Mean device ms of ``fn()`` right after a write of ``flush`` (larger
    than the L2) each time; only ``fn`` is timed."""
    fn()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(reps)]
    torch.cuda.synchronize()
    for start, end in pairs:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / reps


def in_turns(fns: dict, reps: int = REPS, flush=None) -> dict:
    """Device ms of each version: parent, new, new, parent (or the given
    order and its reverse); with ``flush``, each call after an L2 flush."""
    names = list(fns)
    out = {k: [] for k in names}
    for k in names + names[::-1]:
        out[k].append(cs.device_ms(fns[k], reps) if flush is None
                      else cold_ms(fns[k], reps, flush))
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
        # the parent's own sparse walk in place, where it has one
        e_ps, s_ps = base.clone(), torch.zeros(4, dtype=torch.int32, device=dev)
        parent_walk_into(lib, mesh_geom, dx, dy, start, walkers, max_iters, e_ps, s_ps)
        equal(f"{name} parent's sparse walk", (e_ps, s_ps), (e_pl, s_pl))
        fns["parent sparse"] = lambda: parent_walk_into(lib, mesh_geom, dx, dy, start,
                                                        walkers, max_iters, e_ps, stats)
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


def j_case(name, lib, mesh, x, c, active, results) -> None:
    """J at one order: ``check_initial_parents`` in both modes against its
    plain version and the parent's, J alone (this checkout's and the
    parent's, warm and after an L2 flush) and the whole check, in turns."""
    from pumipic_torch.ops import search as se

    n = c.shape[0]
    got = {}
    for mode in ("delete", "repair"):
        got[mode] = se.check_initial_parents(mesh, x, c, active, mode)
        equal(f"J {mode} {name}", got[mode], se.check_parents_plain(mesh, x, c, active, mode))
        equal(f"parent check {mode} {name}", parent_check(lib, mesh, x, c, active, mode),
              got[mode])
    alone = {"parent": lambda: j_launch(lib, mesh, x, c, active, False, mesh.walk_geom),
             "new": lambda: se.check_parents(mesh, x, c, active, False)}
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=c.device)
    cold = in_turns(alone, flush=flush)
    del flush
    nbytes, ops = cs.parent_check_bytes(mesh, c, active)
    sectors = {}
    layouts = ((("walk_geom", 48), ("parent_rows", 32)) if mesh.dim == 2
               else (("walk_geom", 64),))
    for layout, rb in layouts:
        per, warp = cs.parent_sectors(c, active, mesh.nelems, rb,
                                      4 * mesh.dim * (mesh.dim + 1))
        l2_ms = warp * int(active.sum()) * 32 / L2_ESTIMATE_BYTES_PER_S * 1e3
        sectors[layout] = {"per_particle": per, "warp_distinct_per_particle": warp,
                           "l2_estimate_ms": l2_ms}
    case = {"case": f"J {name}", "slots": n, "num_bad": int(got["repair"][1]),
            "num_repaired": int(got["repair"][2]), "j_alone_ms": in_turns(alone),
            "j_alone_after_l2_flush_ms": cold,
            "j_bound_ms": max(nbytes / cs.PEAK_BYTES_PER_S, ops / cs.PEAK_F32_OPS_PER_S) * 1e3,
            "l2_sectors": sectors,
            "plain_ms": cs.device_ms(lambda: se.check_parents_plain(mesh, x, c, active,
                                                                    "delete"), 2)}
    for mode in ("delete", "repair"):
        case[f"{mode}_ms"] = in_turns(
            {"parent": lambda: parent_check(lib, mesh, x, c, active, mode),
             "new": lambda: se.check_initial_parents(mesh, x, c, active, mode)}, reps=10)
    report(case)
    results.append(case)


def j_cases(lib, dev, located, results) -> None:
    """J at phase c's order, 0% and 1% bad, and at the 2D path's order
    after one path call and after PATH_CALLS."""
    mesh, grid, x, elem, active = located
    n = x.shape[0]
    gen = torch.Generator(dev).manual_seed(7)
    claim, xb = cs.parent_claims(mesh, x, elem, gen)
    for share, c, xx in (("0%", elem, x), ("1%", claim, xb)):
        j_case(f"phase c's order, {share} bad", lib, mesh, xx, c, active, results)
    del claim, xb
    q = (0.5 + torch.rand(n, generator=gen, device=dev)).contiguous()
    for k in range(1, cs.PATH_CALLS + 1):
        r2 = cs.trace2d_path_call(mesh, grid, x, elem, active, q, gen)[1]
        x, elem, active = r2.dest.contiguous(), r2.elem_ids, r2.active
        if k in (1, cs.PATH_CALLS):
            j_case(f"the 2d path's order (the state {k} path calls leave)", lib, mesh, x,
                   elem, active, results)


def cases_3d(lib, dev, num_ptcls: int, results) -> None:
    """The 3D repair on the 16^3 box's seeded particles, 0% and 1% bad,
    rows and columns: this checkout's against the parent's, in turns, and
    each split by launch."""
    from pumipic_torch.models import pseudo_push_and_search as pps
    from pumipic_torch.ops import search as se

    mesh = cs.pps3d_mesh(dev)
    cfg = pps.PushSearchConfig(num_ptcls=num_ptcls, structure="dps", wall="periodic",
                               max_search_iters=64, kuhn="off")
    app = pps.PseudoPushAndSearch(mesh, cfg, device=dev)
    x, elem = app.ptcls.get("x").clone(), app.ptcls.elem.clone()
    del app
    torch.cuda.empty_cache()
    active = elem >= 0
    n = x.shape[0]
    gen = torch.Generator(dev).manual_seed(23)
    claim, xb = cs.parent_claims(mesh, x, elem, gen)
    for share, c, xx in (("0%", elem, x), ("1%", claim, xb)):
        _, bad, _ = se.check_parents(mesh, xx, c, active, True)
        read = torch.zeros(mesh.nelems, dtype=torch.bool, device=dev)
        se._walk_batch_3d(mesh.walk_geom, *xx.unbind(1), c, bad, 32, rows_read=read)
        w = int(bad.sum())
        nbytes = cs.parent_check_bytes(mesh, c, active)[0] + n + w * 20 + int(read.sum()) * 64
        for form in ("rows", "columns"):
            xo = xx if form == "rows" else tuple(xx.unbind(1))
            got = se.check_initial_parents(mesh, xo, c, active)
            equal(f"3D {share} {form}", got, se.check_parents_plain(mesh, xo, c, active))
            equal(f"3D parent {share} {form}", parent_check(lib, mesh, xo, c, active,
                                                            "repair"), got)
            fns = {"parent": lambda: parent_check(lib, mesh, xo, c, active, "repair"),
                   "new": lambda: se.check_initial_parents(mesh, xo, c, active)}
            case = {"case": f"3D check_initial_parents repair, {share} bad, origins as {form}",
                    "slots": n, "num_bad": int(got[1]), "num_repaired": int(got[2]),
                    "walkers": w, "distinct_rows": int(read.sum()), "ms": in_turns(fns, 10),
                    "by_launch": {k: split_by_launch(f) for k, f in fns.items()},
                    "bound_ms": nbytes / cs.PEAK_BYTES_PER_S * 1e3}
            report(case)
            results.append(case)


def dense_3d(dev, num_ptcls: int, results) -> None:
    """L3's plain walk on a dense input (``search_mesh_3d`` without a
    locator): the full-output kernel against the sparse schedule with every
    active particle a walker, alone and with the fill a full output needs,
    in turns."""
    from pumipic_torch.models import pseudo_push_and_search as pps
    from pumipic_torch.ops import push as push_ops
    from pumipic_torch.ops import search as se

    mesh = cs.pps3d_mesh(dev)
    cfg = pps.PushSearchConfig(num_ptcls=num_ptcls, structure="dps", wall="periodic",
                               max_search_iters=64, kuhn="off")
    app = pps.PseudoPushAndSearch(mesh, cfg, device=dev)
    x, elem, active = app.ptcls.get("x"), app.ptcls.elem.clone(), app.ptcls.active.clone()
    dest = push_ops.push_and_wrap(x, app.step_vector, app.wrap)
    del app, x
    torch.cuda.empty_cache()
    geom, n, budget = mesh.walk_geom, elem.shape[0], cfg.max_search_iters
    cols = dest.unbind(1)
    start = elem.to(torch.int32)
    want = se.walk_locate_3d_plain(geom, dest, start, active, budget)
    full = lambda: se.walk_locate_3d(geom, dest, start, active, budget)  # noqa: E731
    out = torch.full((n,), -1, dtype=torch.int32, device=dev)
    stats = torch.zeros(4, dtype=torch.int32, device=dev)
    sparse = lambda: se.walk_locate_3d_into(geom, *cols, start, active,  # noqa: E731
                                            budget, out, stats)

    def filled():
        out.fill_(-1)
        stats.zero_()
        sparse()

    equal("dense 3D full output", full(), want)
    filled()
    equal("dense 3D sparse schedule", (out, out >= 0, stats[0], stats[1] == 0, stats[1]),
          want)
    read = torch.zeros(mesh.nelems, dtype=torch.bool, device=dev)
    se._walk_batch_3d(geom, *cols, start, active, budget, rows_read=read)
    w = int(active.sum())
    # the mask, a walker's destination, start and result, the distinct rows;
    # the full output adds its active byte and every slot's result
    moved = n + w * 20 + int(read.sum()) * 64
    case = {"case": f"3D plain walk, dense ({n} slots, {w} walkers, search_mesh_3d "
                    "without a locator)",
            "slots": n, "walkers": w, "iters": int(want[2]), "distinct_rows": int(read.sum()),
            "ms": in_turns({"full output": full, "sparse + fill": filled,
                            "sparse alone": sparse}),
            "bound_ms": moved / cs.PEAK_BYTES_PER_S * 1e3,
            "full_output_bound_ms": (moved + (n - w) * 4 + n) / cs.PEAK_BYTES_PER_S * 1e3}
    report(case)
    results.append(case)


def walk_cases(lib, dev, located, results) -> None:
    """Kernel L's plain walks: (a) the repair in place, (c) the ring
    points, the peel, (b) the picparts lost check."""
    from pumipic_torch.mesh.core import Mesh2D
    from pumipic_torch.models import pseudo_xgcm as px
    from pumipic_torch.ops import search as se
    from pumipic_torch.parallel import picparts as ppm

    mesh, grid, x, elem, active = located
    n = x.shape[0]
    geom = mesh.walk_geom
    gen = torch.Generator(dev).manual_seed(7)
    claim, xb = cs.parent_claims(mesh, x, elem, gen)
    # (a) the repair walk over J's bad parents
    for share, c, xx in (("0%", elem, x), ("1%", claim, xb)):
        _, badm, _ = se.check_parents(mesh, xx, c, active, True)
        walk_case(f"(a) repair walk, {share} bad", lib, geom, *xx.unbind(1), c, badm, 32,
                  False, results)
    del claim, xb
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
    del tx, ty, gpx, gpy, gstart, gact
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


def main() -> None:
    import argparse

    import count_walk_steps as cw

    ap = argparse.ArgumentParser()
    ap.add_argument("parent_dir")
    ap.add_argument("num_ptcls", nargs="?", type=int, default=cs.NUM_PTCLS)
    ap.add_argument("out_json", nargs="?")
    ap.add_argument("--cases", default=",".join(CASES),
                    help=f"comma-separated, of {CASES}")
    args = ap.parse_args()
    cases = args.cases.split(",")
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    smi = cs.smi_query("name,power.limit", units=True)
    from pumipic_torch.kernels import _build

    _build.build(verbose=True)
    for src in PARENT_SOURCES:
        print(f"ptxas {src}: {json.dumps(cs.ptxas_functions(_build.REPORTS.get(src, '')))}")
    srcs = [os.path.join(args.parent_dir, f) for f in PARENT_SOURCES
            if os.path.exists(os.path.join(args.parent_dir, f))]
    lib, rep = build_lib(srcs, "parent")
    print(f"ptxas parent: {json.dumps(cs.ptxas_functions(rep))}", flush=True)
    dev = torch.device("cuda")
    results = []
    if "J" in cases or "walk" in cases:
        located = cw.located_2d(dev, args.num_ptcls)
        if "J" in cases:
            j_cases(lib, dev, located, results)
        if "walk" in cases:
            walk_cases(lib, dev, located, results)
        del located
        torch.cuda.empty_cache()
    if "3d" in cases:
        cases_3d(lib, dev, args.num_ptcls, results)
    if "dense3d" in cases:
        dense_3d(dev, args.num_ptcls, results)
    print(smi, flush=True)
    if args.out_json:
        os.makedirs(os.path.dirname(os.path.abspath(args.out_json)), exist_ok=True)
        with open(args.out_json, "w") as f:
            json.dump({"card": smi, "cases": results}, f, indent=1)


if __name__ == "__main__":
    main()
