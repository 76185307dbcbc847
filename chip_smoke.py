"""On-card smoke test of the PyTorch/CUDA port (``pumipic_torch``).

    python3 chip_smoke.py

Needs one CUDA GPU and the CUDA toolkit (nvcc); builds the kernels from the
sources in this checkout.  Phases, each raising on failure:

(a) require a CUDA device; print its name and power limit (nvidia-smi) and
    the torch / CUDA versions;
(b) build the six kernels (P push, B band cell, A annulus locate, L
    locate, H histogram, D deposit), one nvcc per source, all at once;
(c) run each kernel and its plain PyTorch version on the card on the same
    inputs at the shapes the four arms give it, require equal outputs, and
    time both: on the 120k-element gmsh mesh at 10M particles P, L (peel +
    walk), H and D, L's plain walk over the 1.48M gyro ring points, B and
    L's given-cells mode on the flux-band grid, H's (element, ring) key
    mode and D's pass 1 from (E, R) counts; A on the 23,976-element
    annulus at 10M.  Then run a small slice of each arm on the card and on
    the CPU for 3 steps and require equal states and fields;
(d) run the four arms through their entry point, ``bench_torch.main()``,
    at 10M particles, 1 warm-up + 20 timed steps each, with the launch
    counters reset just before each: the cartesian main path, the
    flux-band arm (``band_locator="force"``, reusing phase c's band
    grid), the annulus arm and the per-particle gyro radius arm.  Require
    each arm's kernels launched (and the annulus arm's steps launching no
    L: its only L launch is the setup's gyro-map walk), finite positive
    fields and > 90% of the particles alive;
(e) print the kernels' JSON line, the card's line, and the contract line
    ``{"ok": true, "device": {...}}`` last.

Tolerance: every comparison is exact (max |kernel - plain| must be 0, no
mismatch).  The kernels are built with -fmad=false and follow the plain
versions' operation order; where a plain version calls libm (A's
atan2/cos/sin) it runs torch's CUDA ops, which call the same CUDA libm
functions as the kernel.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
MESH = os.path.join(HERE, "data", "xgc_like_120k.msh.gz")
NUM_PTCLS = 10_000_000
TIMED_STEPS = 20
ANNULUS_ELEMS = 24_000

KERNELS = {  # name -> (route, source, replaces)
    "push": ("cuda", "pumipic_torch/kernels/csrc/push.cu",
             "pumipic_tpu/ops/push.py:82"),
    "band_cell": ("cuda", "pumipic_torch/kernels/csrc/band.cu",
                  "perf/pallas_smoke.py:98"),
    "annulus_locate": ("cuda", "pumipic_torch/kernels/csrc/annulus.cu",
                       "pumipic_tpu/mesh/locator.py:379"),
    "locate": ("cuda", "pumipic_torch/kernels/csrc/locate.cu",
               "pumipic_tpu/ops/search.py:1049"),
    "histogram": ("cuda", "pumipic_torch/kernels/csrc/histogram.cu",
                  "pumipic_tpu/ops/scatter.py:65"),
    "deposit": ("cuda", "pumipic_torch/kernels/csrc/deposit.cu",
                "pumipic_tpu/ops/scatter.py:224"),
}

# the four arms of phase d: bench_torch.main keywords, and the kernels each
# arm's run must launch (every other kernel must stay at 0)
ARMS = {
    "cartesian": ({}, ("push", "locate", "histogram", "deposit")),
    "band": ({"band_locator": "force"},
             ("push", "band_cell", "locate", "histogram", "deposit")),
    "annulus": ({"mesh_path": "annulus", "mesh_elems": ANNULUS_ELEMS},
                ("push", "annulus_locate", "locate", "histogram", "deposit")),
    "pprad": ({"gyro_ppr": True}, ("push", "locate", "histogram", "deposit")),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` runs after one
    warm-up, timed with CUDA events."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_err(a, b) -> float:
    """max |a - b| over tensors (or tuples of tensors) of any dtype."""
    if isinstance(a, (tuple, list)):
        return max(max_err(x, y) for x, y in zip(a, b))
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape, a.dtype, b.dtype)
    if a.numel() == 0:
        return 0.0
    if a.dtype == torch.bool:
        return float((a != b).sum() > 0)
    return float((a.double() - b.double()).abs().max())


def mismatches(a, b) -> int:
    if isinstance(a, (tuple, list)):
        return sum(mismatches(x, y) for x, y in zip(a, b))
    return int((a != b).sum())


def compare(kernel: str, what: str, got, want, results: dict) -> None:
    err, nmis = max_err(got, want), mismatches(got, want)
    log(f"[c] {kernel} {what}: max |kernel - plain| = {err}, mismatches = {nmis}")
    if err != 0.0 or nmis != 0:
        raise AssertionError(f"{kernel} {what}: kernel disagrees with its "
                             f"plain version")
    results[kernel]["max_abs_err"] = max(results[kernel].get("max_abs_err", 0.0), err)


def time_pair(kernel: str, what: str, fn, plain, results: dict, reps: int = 20,
              plain_reps: int = 5, record: bool = True) -> None:
    """Time a kernel and its plain version; the first timing of a kernel
    is the one its JSON entry carries."""
    ms, pms = cuda_ms(fn, reps), cuda_ms(plain, plain_reps)
    log(f"[c] {kernel} {what}: kernel {ms:.4f} ms, plain {pms:.4f} ms")
    if record and "ms" not in results[kernel]:
        results[kernel].update(ms=ms, plain_ms=pms)


def phase_a() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device; none is available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"[a] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    log(f"[a] card: {smi}")
    return smi


def phase_b() -> None:
    from pumipic_torch.kernels import _build

    t0 = time.perf_counter()
    path = _build.build(verbose=True)
    _build.lib()
    log(f"[b] kernels built in {time.perf_counter() - t0:.2f} s -> "
        f"{os.path.relpath(path, HERE)}")


def _cfg(px, mesh, **kw):
    """bench_torch's configuration for ``mesh``."""
    return px.XGCmConfig(num_ptcls=NUM_PTCLS,
                         mdl_face=max(int(mesh.class_id.max()) // 2, 2),
                         deg_per_push=15.0, max_search_iters=64, **kw)


def _push(push_ops, s, model, cfg):
    return push_ops.push_banded(s["x0"], s["x1"], s["cphi"], s["sphi"], s["b"],
                                s["elem"], s["active"], model.rot, cfg.h,
                                cfg.k, cfg.d)


def check_cartesian(results: dict, dev, mesh):
    """P, L, H, D at the main path's shapes; returns (elem, active) of the
    located 10M particles."""
    from pumipic_torch.models import pseudo_xgcm as px
    from pumipic_torch.ops import push as push_ops
    from pumipic_torch.ops import scatter as sc
    from pumipic_torch.ops import search as se

    cfg = _cfg(px, mesh)
    s, step = px.make_dp_setup(mesh, cfg, dev)
    model = step.model
    n = s["x0"].shape[0]
    R, P = cfg.gyro.num_rings, cfg.gyro.points_per_ring
    log(f"[c] 120k mesh: E={mesh.nelems} V={mesh.nverts}, N={n}, "
        f"cells={model.locator.nx * model.locator.ny}, bands={model.rot.cd.shape[0]}")

    # P: push at 10M
    pargs = (s["x0"], s["x1"], s["cphi"], s["sphi"], s["b"], s["elem"],
             s["active"], model.rot, cfg.h, cfg.k, cfg.d)
    got = push_ops.push_banded(*pargs)
    compare("push", f"({n} particles)", got, push_ops.push_banded_plain(*pargs), results)
    time_pair("push", "", lambda: push_ops.push_banded(*pargs),
              lambda: push_ops.push_banded_plain(*pargs), results)
    tx, ty = got[0], got[1]

    # L: peel + guess walk at 10M
    largs = (mesh.walk_geom, tx, ty, s["elem"], s["active"], cfg.max_search_iters)
    grid = model.locator
    got = se.walk_locate(*largs, grid=grid)
    compare("locate", f"peel+walk ({n} particles)", got,
            se.walk_locate_plain(*largs, grid=grid), results)
    log(f"[c] locate: iters={int(got[2])} all_found={bool(got[3])} "
        f"alive={int(got[1].sum())}")
    time_pair("locate", "peel+walk", lambda: se.walk_locate(*largs, grid=grid),
              lambda: se.walk_locate_plain(*largs, grid=grid), results,
              plain_reps=3)
    elem, active = got[0], got[1]

    # L: plain walk over the gyro ring points (the setup's gyro map search)
    gpx, gpy, gstart = (t.to(dev) for t in px.gyro_ring_points(mesh, cfg.gyro))
    gact = torch.ones(gpx.shape[0], dtype=torch.bool, device=dev)
    gargs = (mesh.walk_geom, gpx, gpy, gstart, gact, 100)
    got = se.walk_locate(*gargs)
    compare("locate", f"plain walk ({gpx.shape[0]} ring points)", got,
            se.walk_locate_plain(*gargs), results)
    log(f"[c] ring-point walk: iters={int(got[2])} all_found={bool(got[3])}")
    time_pair("locate", "plain walk", lambda: se.walk_locate(*gargs),
              lambda: se.walk_locate_plain(*gargs), results, reps=5,
              plain_reps=2)

    # H: histogram of 10M keys into E bins
    E = mesh.nelems
    got = sc.histogram(elem, active, E)
    compare("histogram", f"({n} keys, {E} bins)", got,
            sc.histogram_plain(elem, active, E), results)
    time_pair("histogram", "", lambda: sc.histogram(elem, active, E),
              lambda: sc.histogram_plain(elem, active, E), results)
    counts = got

    # D: ring expansion + mapped scatter at V, R, P
    got_r = sc.deposit_rings(counts, mesh, R)
    want_r = sc.ring_accum_plain(counts, mesh, R)
    got_f = sc.scatter_to_mapped_verts(got_r, model.gyro_fwd, mesh.nverts, R, P)
    want_f = sc.mapped_plain(want_r, model.gyro_fwd, mesh.nverts, R, P)
    compare("deposit", f"(V={mesh.nverts}, R={R}, P={P})", (got_r, got_f),
            (want_r, want_f), results)

    def dep():
        r = sc.deposit_rings(counts, mesh, R)
        return sc.scatter_to_mapped_verts(r, model.gyro_fwd, mesh.nverts, R, P)

    def dep_plain():
        r = sc.ring_accum_plain(counts, mesh, R)
        return sc.mapped_plain(r, model.gyro_fwd, mesh.nverts, R, P)

    time_pair("deposit", "both passes", dep, dep_plain, results, plain_reps=20)
    return elem, active


def check_band(results: dict, dev, mesh):
    """B and L's given-cells mode at 10M on the 120k mesh's flux-band
    grid; returns the grid and its build seconds."""
    from pumipic_torch.models import pseudo_xgcm as px
    from pumipic_torch.ops import locate as lo
    from pumipic_torch.ops import push as push_ops
    from pumipic_torch.ops import search as se

    cfg = _cfg(px, mesh, band_locator="force")
    setup = {}
    s, step = px.make_dp_setup(mesh, cfg, dev, timings=setup)
    grid = step.model.locator
    log(f"[c] band grid: K={grid.n_bands} T={grid.n_theta} J={grid.n_harm} "
        f"P={grid.n_cheb} rank={grid.rank} seed terms={grid.inv_coef.shape[0]}, "
        f"rows {tuple(grid.cell_rows.shape)}, built in {setup['locator']:.2f} s")
    tx, ty, _, _ = _push(push_ops, s, step.model, cfg)
    n = tx.shape[0]
    got = lo.band_cell_of(grid, tx, ty)
    compare("band_cell", f"({n} pushed targets)", got,
            lo.band_cell_of_plain(grid, tx, ty), results)
    time_pair("band_cell", "", lambda: lo.band_cell_of(grid, tx, ty),
              lambda: lo.band_cell_of_plain(grid, tx, ty), results, plain_reps=3)

    largs = (mesh.walk_geom, tx, ty, s["elem"], s["active"], cfg.max_search_iters)
    got = se.walk_locate(*largs, grid=grid)
    compare("locate", f"given cells, band grid ({n} particles)", got,
            se.walk_locate_plain(*largs, grid=grid), results)
    log(f"[c] band locate: iters={int(got[2])} all_found={bool(got[3])} "
        f"alive={int(got[1].sum())}")
    time_pair("locate", "B + given cells", lambda: se.walk_locate(*largs, grid=grid),
              lambda: se.walk_locate_plain(*largs, grid=grid), results,
              plain_reps=3, record=False)
    return grid, setup["locator"]


def check_pprad(results: dict, dev, mesh, elem, active) -> None:
    """H's (element, ring) key mode at 10M and D's pass 1 from (E, R)."""
    from pumipic_torch.models import pseudo_xgcm as px
    from pumipic_torch.ops import scatter as sc

    cfg = _cfg(px, mesh, gyro=px.GyroConfig(per_particle_radius=True))
    rg = px.initial_state(mesh, cfg, device=dev)["rg"]
    E, R, rmax = mesh.nelems, cfg.gyro.num_rings, cfg.gyro.rmax
    args = (elem, active, E, rg, R, rmax)
    got = sc.histogram(*args)
    compare("histogram", f"key mode ({elem.shape[0]} particles -> {E * R} keys)",
            got, sc.histogram_plain(*args), results)
    time_pair("histogram", "key mode", lambda: sc.histogram(*args),
              lambda: sc.histogram_plain(*args), results, record=False)
    counts = got.view(E, R)
    compare("deposit", f"pass 1 from (E, R) = ({E}, {R}) counts",
            sc.deposit_rings(counts, mesh, R), sc.ring_accum_plain(counts, mesh, R),
            results)
    time_pair("deposit", "pass 1 from (E, R)", lambda: sc.deposit_rings(counts, mesh, R),
              lambda: sc.ring_accum_plain(counts, mesh, R), results, record=False)


def check_annulus(results: dict, dev) -> None:
    """A at 10M on the annulus setup's pushed targets."""
    from pumipic_torch.models import pseudo_xgcm as px
    from pumipic_torch.ops import locate as lo
    from pumipic_torch.ops import push as push_ops

    mesh = px.make_default_mesh(ANNULUS_ELEMS).to(dev)
    cfg = _cfg(px, mesh)
    s, step = px.make_dp_setup(mesh, cfg, dev)
    loc = step.model.analytic
    if loc is None or not loc.ring_class:
        raise AssertionError("the bench annulus was not proven ring_class")
    tx, ty, _, _ = _push(push_ops, s, step.model, cfg)
    n = tx.shape[0]
    args = (loc, tx, ty, s["active"])
    got = lo.annulus_locate(*args)
    compare("annulus_locate", f"({n} particles, E={mesh.nelems})", got,
            lo.annulus_locate_plain(*args), results)
    log(f"[c] annulus locate: alive={int(got[1].sum())} of {n}")
    time_pair("annulus_locate", "", lambda: lo.annulus_locate(*args),
              lambda: lo.annulus_locate_plain(*args), results)


def check_slices(dev) -> None:
    """Each arm at a small size, 3 steps on the card and on the CPU (plain
    versions): states and fields must be equal bit for bit."""
    from pumipic_torch.mesh.core import Mesh2D
    from pumipic_torch.mesh.generate import annulus_mesh, tokamak_mesh
    from pumipic_torch.models import pseudo_xgcm as px

    slices = {
        "cartesian": (tokamak_mesh(16, 96), {}),
        "band": (tokamak_mesh(24, 120), {"band_locator": "force"}),
        "annulus": (annulus_mesh(8, 48, 0.3, 1.0), {}),
        "pprad": (tokamak_mesh(16, 96),
                  {"gyro": px.GyroConfig(per_particle_radius=True)}),
    }
    for name, (arrays, kw) in slices.items():
        mdl_face = max(int(arrays[2].max()) // 2, 2)
        cfg = px.XGCmConfig(num_ptcls=20_000, mdl_face=mdl_face,
                            deg_per_push=15.0, max_search_iters=64, **kw)
        sg, stg = px.make_dp_setup(Mesh2D.from_arrays(*arrays, device=dev), cfg, dev)
        sc_, stc = px.make_dp_setup(Mesh2D.from_arrays(*arrays), cfg, "cpu")
        for i in range(3):
            sg, fg = stg(sg)
            sc_, fc = stc(sc_)
            for key in sg:
                if max_err(sg[key].cpu(), sc_[key]) != 0.0:
                    raise AssertionError(f"{name} slice step {i}: state {key} "
                                         f"differs GPU vs CPU")
            for key in ("fwd", "bwd", "iters", "all_found"):
                if max_err(fg[key].cpu(), fc[key]) != 0.0:
                    raise AssertionError(f"{name} slice step {i}: field {key} "
                                         f"differs GPU vs CPU")
        log(f"[c] {name} slice (E={stc.model.mesh.nelems}, 20k particles, 3 "
            f"steps, alive {int(sc_['active'].sum())}): card == CPU, bit for bit")


def phase_c(results: dict, dev):
    """Returns the band grid built here (phase d reuses it) and its build
    seconds."""
    from pumipic_torch.mesh.core import Mesh2D
    from pumipic_torch.mesh.gmsh import read_msh

    mesh = Mesh2D.from_arrays(*read_msh(MESH), device=dev)
    elem, active = check_cartesian(results, dev, mesh)
    check_pprad(results, dev, mesh, elem, active)
    del elem, active
    band_grid, band_s = check_band(results, dev, mesh)
    check_annulus(results, dev)
    check_slices(dev)
    torch.cuda.empty_cache()
    return band_grid, band_s


def phase_d(results: dict, dev, band_grid, band_s: float) -> None:
    import bench_torch
    from pumipic_torch import kernels

    for name, (kw, expected) in ARMS.items():
        kw = dict({"mesh_path": MESH}, **kw)
        if name == "band":
            kw["locator"] = band_grid
        torch.cuda.empty_cache()
        kernels.reset_launches()
        record, state, fields = bench_torch.main(
            device=dev, num_ptcls=NUM_PTCLS, iters=TIMED_STEPS, **kw)
        counts = dict(kernels.LAUNCHES)
        det = record["detail"]
        setup = dict(det["setup_s"])
        if name == "band":
            setup["band grid build (phase c)"] = band_s
        log(f"[d] {name} arm, tag {det['tag']}, E={det['mesh_elems']}")
        log(f"[d] {name} setup seconds: "
            + ", ".join(f"{k} {v:.2f}" for k, v in setup.items()))
        log(f"[d] {name}: {det['ms_per_step']:.4f} ms/step, {record['value']:.6g} "
            f"particle-steps/s, alive {det['alive']} of {det['num_ptcls']}, "
            f"iters {det['iters']}, all_found {det['all_found']}")
        log(f"[d] {name} kernel launches: {counts}")
        launched = {k for k, v in counts.items() if v > 0}
        if launched != set(expected):
            raise AssertionError(f"{name} arm launched {sorted(launched)}, "
                                 f"expected {sorted(expected)}")
        if name == "annulus" and counts["locate"] != 1:
            raise AssertionError(f"annulus arm: {counts['locate']} L launches; "
                                 f"only the setup's gyro-map walk may launch L")
        for k, v in counts.items():
            results[k]["launches"] = results[k].get("launches", 0) + v
        for key in ("fwd", "bwd"):
            f = fields[key]
            if f.shape != (det["mesh_verts"],) or not bool(torch.isfinite(f).all()) \
                    or not float(f.sum()) > 0:
                raise AssertionError(f"{name} field {key}: shape {tuple(f.shape)}, "
                                     f"want ({det['mesh_verts']},), finite and "
                                     f"positive")
        if not det["alive"] > 0.9 * NUM_PTCLS:
            raise AssertionError(f"{name}: only {det['alive']} of {NUM_PTCLS} "
                                 f"particles alive")
        del state, fields


def main() -> int:
    import pumipic_torch

    pkg = os.path.dirname(os.path.abspath(pumipic_torch.__file__))
    if os.path.dirname(pkg) != HERE:
        raise RuntimeError(f"pumipic_torch was imported from {pkg}, not from "
                           f"this checkout")
    smi = phase_a()
    phase_b()
    results = {name: {} for name in KERNELS}
    dev = torch.device("cuda")
    band_grid, band_s = phase_c(results, dev)
    phase_d(results, dev, band_grid, band_s)
    line = {"kernels": [
        {"name": name, "route": route, "source": src, "replaces": rep,
         "launches": results[name]["launches"],
         "max_abs_err": results[name]["max_abs_err"],
         "ms": results[name]["ms"], "plain_ms": results[name]["plain_ms"]}
        for name, (route, src, rep) in KERNELS.items()]}
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, HERE)
    sys.exit(main())
