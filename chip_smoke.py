"""On-card smoke test of the PyTorch/CUDA port (``pumipic_torch``).

    python3 chip_smoke.py

Needs one CUDA GPU and the CUDA toolkit (nvcc); builds the kernels from the
sources in this checkout.  Phases, each raising on failure:

(a) require a CUDA device; print its name and power limit (nvidia-smi) and
    the torch / CUDA versions;
(b) build the four kernels (P push, L locate, H histogram, D deposit);
(c) on the 120k-element gmsh mesh at the main path's shapes (10M particles,
    1.48M gyro ring points), run each kernel and its plain PyTorch version
    on the card on the same inputs, require equal outputs, and time both;
    then run a small slice on the card and on the CPU and require equal
    states and fields;
(d) reset the launch counters and run the main path through its entry
    point, ``bench_torch.main()`` (10M particles, 1 warm-up + 20 timed
    steps); require every kernel launched, finite fields and > 90% of the
    particles alive;
(e) print the kernels' JSON line, the card's line, and the contract line
    ``{"ok": true, "device": {...}}`` last.

Tolerance: every comparison is exact (max |kernel - plain| must be 0).  The
kernels are built with -fmad=false and follow the plain versions' operation
order, and the push reads the same per-class rotation table as its plain
version, so nothing is left to round differently.
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

KERNELS = {  # name -> (route, source, replaces)
    "push": ("cuda", "pumipic_torch/kernels/csrc/push.cu",
             "pumipic_tpu/ops/push.py:82"),
    "locate": ("cuda", "pumipic_torch/kernels/csrc/locate.cu",
               "pumipic_tpu/ops/search.py:1049"),
    "histogram": ("cuda", "pumipic_torch/kernels/csrc/histogram.cu",
                  "pumipic_tpu/ops/scatter.py:65"),
    "deposit": ("cuda", "pumipic_torch/kernels/csrc/deposit.cu",
                "pumipic_tpu/ops/scatter.py:224"),
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


def compare(name: str, got, want, results: dict) -> None:
    err, nmis = max_err(got, want), mismatches(got, want)
    log(f"[c] {name}: max |kernel - plain| = {err}, mismatches = {nmis}")
    if err != 0.0 or nmis != 0:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    results[name.split()[0]]["max_abs_err"] = max(
        results[name.split()[0]].get("max_abs_err", 0.0), err)


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


def phase_c(results: dict) -> int:
    """Returns the 120k mesh's vertex count."""
    from pumipic_torch.mesh.core import Mesh2D
    from pumipic_torch.mesh.gmsh import read_msh
    from pumipic_torch.models import pseudo_xgcm as px
    from pumipic_torch.ops import push as push_ops
    from pumipic_torch.ops import scatter as sc
    from pumipic_torch.ops import search as se

    dev = torch.device("cuda")
    coords, tris, cls = read_msh(MESH)
    mesh = Mesh2D.from_arrays(coords, tris, cls, device=dev)
    cfg = px.XGCmConfig(num_ptcls=NUM_PTCLS, mdl_face=max(int(cls.max()) // 2, 2),
                        deg_per_push=15.0, max_search_iters=64)
    state, step = px.make_dp_setup(mesh, cfg, dev)
    model = step.model
    R, P = cfg.gyro.num_rings, cfg.gyro.points_per_ring
    log(f"[c] 120k mesh: E={mesh.nelems} V={mesh.nverts}, N={state['x0'].shape[0]}, "
        f"cells={model.locator.nx * model.locator.ny}, bands={model.rot.cd.shape[0]}")

    # P: push at 10M
    s = state
    pargs = (s["x0"], s["x1"], s["cphi"], s["sphi"], s["b"], s["elem"],
             s["active"], model.rot, cfg.h, cfg.k, cfg.d)
    got = push_ops.push_banded(*pargs)
    want = push_ops.push_banded_plain(*pargs)
    n = s["x0"].shape[0]
    compare(f"push ({n} particles)", got, want, results)
    results["push"]["ms"] = cuda_ms(lambda: push_ops.push_banded(*pargs), 20)
    results["push"]["plain_ms"] = cuda_ms(lambda: push_ops.push_banded_plain(*pargs), 5)
    tx, ty = got[0], got[1]

    # L: peel + guess walk at 10M
    largs = (mesh.walk_geom, tx, ty, s["elem"], s["active"], cfg.max_search_iters)
    got = se.walk_locate(*largs, grid=model.locator)
    want = se.walk_locate_plain(*largs, grid=model.locator)
    compare(f"locate peel+walk ({n} particles)", got, want, results)
    log(f"[c] locate: iters={int(got[2])} all_found={bool(got[3])} "
        f"alive={int(got[1].sum())}")
    results["locate"]["ms"] = cuda_ms(lambda: se.walk_locate(*largs, grid=model.locator), 20)
    results["locate"]["plain_ms"] = cuda_ms(
        lambda: se.walk_locate_plain(*largs, grid=model.locator), 3)
    elem, active = got[0], got[1]

    # L: plain walk over the gyro ring points (the setup's gyro map search)
    gpx, gpy, gstart = (t.to(dev) for t in px.gyro_ring_points(mesh, cfg.gyro))
    gact = torch.ones(gpx.shape[0], dtype=torch.bool, device=dev)
    gargs = (mesh.walk_geom, gpx, gpy, gstart, gact, 100)
    got = se.walk_locate(*gargs)
    want = se.walk_locate_plain(*gargs)
    compare(f"locate plain walk ({gpx.shape[0]} ring points)", got, want, results)
    log(f"[c] ring-point walk: iters={int(got[2])} all_found={bool(got[3])}; "
        f"kernel {cuda_ms(lambda: se.walk_locate(*gargs), 5):.4f} ms, plain "
        f"{cuda_ms(lambda: se.walk_locate_plain(*gargs), 2):.4f} ms")

    # H: histogram of 10M keys into E bins
    got = sc.histogram(elem, active, mesh.nelems)
    want = sc.histogram_plain(elem, active, mesh.nelems)
    compare(f"histogram ({n} keys, {mesh.nelems} bins)", got, want, results)
    results["histogram"]["ms"] = cuda_ms(lambda: sc.histogram(elem, active, mesh.nelems), 20)
    results["histogram"]["plain_ms"] = cuda_ms(
        lambda: sc.histogram_plain(elem, active, mesh.nelems), 20)
    counts = got

    # D: ring expansion + mapped scatter at V, R, P
    got_r = sc.deposit_rings(counts, mesh, R)
    want_r = sc.ring_accum_plain(counts, mesh, R)
    got_f = sc.scatter_to_mapped_verts(got_r, model.gyro_fwd, mesh.nverts, R, P)
    want_f = sc.mapped_plain(want_r, model.gyro_fwd, mesh.nverts, R, P)
    compare(f"deposit (V={mesh.nverts}, R={R}, P={P})", (got_r, got_f),
            (want_r, want_f), results)

    def dep():
        r = sc.deposit_rings(counts, mesh, R)
        return sc.scatter_to_mapped_verts(r, model.gyro_fwd, mesh.nverts, R, P)

    def dep_plain():
        r = sc.ring_accum_plain(counts, mesh, R)
        return sc.mapped_plain(r, model.gyro_fwd, mesh.nverts, R, P)

    results["deposit"]["ms"] = cuda_ms(dep, 20)
    results["deposit"]["plain_ms"] = cuda_ms(dep_plain, 20)
    n_verts = mesh.nverts
    del state, step, model, s, got, want

    # the slice on the card against the slice on the CPU (plain versions)
    from pumipic_torch.mesh.generate import tokamak_mesh

    c2, t2, k2 = tokamak_mesh(16, 96)
    small = px.XGCmConfig(num_ptcls=20_000, mdl_face=8, deg_per_push=15.0,
                          max_search_iters=64)
    sg, stg = px.make_dp_setup(Mesh2D.from_arrays(c2, t2, k2, device=dev), small, dev)
    sc_, stc = px.make_dp_setup(Mesh2D.from_arrays(c2, t2, k2), small, "cpu")
    for i in range(3):
        sg, fg = stg(sg)
        sc_, fc = stc(sc_)
        for key in sg:
            if max_err(sg[key].cpu(), sc_[key]) != 0.0:
                raise AssertionError(f"slice step {i}: state {key} differs GPU vs CPU")
        for key in ("fwd", "bwd", "iters", "all_found"):
            if max_err(fg[key].cpu(), fc[key]) != 0.0:
                raise AssertionError(f"slice step {i}: field {key} differs GPU vs CPU")
    log("[c] small slice (tokamak 16x96, 20k particles, 3 steps): card == CPU, bit for bit")
    return n_verts


def phase_d(results: dict, n_verts: int) -> dict:
    import bench_torch
    from pumipic_torch import kernels

    torch.cuda.empty_cache()
    kernels.reset_launches()
    record, state, fields = bench_torch.main(
        device="cuda", num_ptcls=NUM_PTCLS, iters=TIMED_STEPS, mesh_path=MESH)
    counts = dict(kernels.LAUNCHES)
    det = record["detail"]
    log(f"[d] setup seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in det["setup_s"].items()))
    log(f"[d] {det['ms_per_step']:.4f} ms/step, {record['value']:.6g} particle-steps/s, "
        f"alive {det['alive']} of {det['num_ptcls']}, iters {det['iters']}, "
        f"all_found {det['all_found']}")
    log(f"[d] kernel launches on the main path: {counts}")
    for name, n in counts.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
        results[name]["launches"] = n
    for key in ("fwd", "bwd"):
        f = fields[key]
        if f.shape != (n_verts,) or not bool(torch.isfinite(f).all()) \
                or not float(f.sum()) > 0:
            raise AssertionError(f"field {key}: shape {tuple(f.shape)}, want "
                                 f"({n_verts},), finite and positive")
    if not det["alive"] > 0.9 * NUM_PTCLS:
        raise AssertionError(f"only {det['alive']} of {NUM_PTCLS} particles alive")
    return record


def main() -> int:
    import pumipic_torch

    pkg = os.path.dirname(os.path.abspath(pumipic_torch.__file__))
    if os.path.dirname(pkg) != HERE:
        raise RuntimeError(f"pumipic_torch was imported from {pkg}, not from "
                           f"this checkout")
    smi = phase_a()
    phase_b()
    results = {name: {} for name in KERNELS}
    n_verts = phase_c(results)
    phase_d(results, n_verts)
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
