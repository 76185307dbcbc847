"""Where the time of the port's FULL-mode step goes, on one CUDA GPU.

    python3 scripts/profile_torch_step.py [num_ptcls] [steps] [arm ...]

For each arm (default: ``cartesian``; also ``band``, ``annulus``,
``pprad``, ``rotgather``, ``nolocator`` (no locator grid: kernel L's dense
plain walk from each particle's element), the arms of ``chip_smoke.py``),
sets up
bench_torch's configuration of that arm (default 10M particles); ``pps3d``
and ``pps3d-walk`` are bench_torch's pseudoPushAndSearch arms (the Kuhn
box, DPS, kernel K or kernel L3), ``pps3d-reflect`` its reflecting-wall
arm (K's push-only form and kernel M's peel form), ``pps3d-scs`` its Kuhn
arm on a Sell-C-σ structure (the sorted rebuild on tets: kernels C, Z, Q,
S and G), ``pps3d-cabm`` on CabM; ``pps3d-scs-auto`` and ``pps3d-cabm-auto``
the reshuffle-or-rebuild (``rebuild="auto"``) at ``chip_smoke.py``'s short
push (kernels U1, U3, G and U2; the JSON line adds the auto rebuilds and
the reshuffles among them), ``pps3d-scs-near`` and ``pps3d-cabm-near`` the
sort rebuild at that push, ``pps3d-scs-auto-fallback`` the auto rebuild at
the default push (U1, then the sort); ``gitr-reflect`` and
``gitr-absorb`` are bench_torch's GITR-style arms (kernels R, M and W on
the 196,608-tet box); ``2d-path`` is ``chip_smoke.py``'s 2D path (one call
of ``trace2d_path_call`` a step: kernels L, M2, V and H from the seeded
particles of bench_torch's mesh; its JSON line adds ``ranges``: the device
ms a step of each of ``chip_smoke.PATH_RANGES`` and of
``port:check_initial_parents`` inside the first entry point, with the
kernels each range launched by name); an arm's name with ``-1M``
(``cartesian-1M``, ``nolocator-1M``, ``band-1M``, ``app-1M``, ...) runs it
on the ~1M-element production mesh (``bench_torch.production_mesh``,
written at first use), whose arms share one read of the mesh and one
cartesian grid (their seconds in each arm's ``setup_s``); the ``app`` arm builds
the single-device ``PseudoXGCm`` app on a Sell-C-σ structure with the same
mesh and settings (its step adds the sorted rebuild: the stable sort,
kernels H, Z, S and G), ``app-<structure>`` on another structure (``csr``,
``cabm``, ``dps``).  Then it runs one warm-up step,
then ``steps`` steps (default 10) untraced for the host wall and enqueue
time per step, then ``steps`` more under torch.profiler for the device time
per step by kernel name.  Prints one JSON line per arm with both, the
device idle share (1 - device busy time / wall time), and the card's name
and power limit.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import bench_torch  # noqa: E402
from pumipic_torch import kernels  # noqa: E402

# chip_smoke.AUTO_DIST: the auto arms' push
AUTO_DIST = 0.001

ARMS = {  # arm -> bench_torch.setup keywords
    "cartesian": {},
    "band": {"band_locator": "force"},
    "annulus": {"mesh_path": "annulus"},
    "pprad": {"gyro_ppr": True},
    "rotgather": {"rot_analytic": False},
    "nolocator": {"use_locator": False},
}
PPS3D_ARMS = {  # arm -> bench_torch.setup_pps3d keywords
    "pps3d": {"kuhn": "auto"},
    "pps3d-walk": {"kuhn": "off"},
    "pps3d-reflect": {"kuhn": "off", "wall": "reflect"},
    "pps3d-scs": {"kuhn": "auto", "structure": "scs"},
    "pps3d-cabm": {"kuhn": "auto", "structure": "cabm"},
    # the reshuffle-or-rebuild at chip_smoke's short push (every step a
    # reshuffle: kernels U1, C, G, U2), the sort rebuild at the same push,
    # and the auto rebuild at the default push (every step U1 + the sort)
    "pps3d-scs-auto": {"kuhn": "auto", "structure": "scs", "rebuild": "auto",
                       "distance": AUTO_DIST},
    "pps3d-cabm-auto": {"kuhn": "auto", "structure": "cabm", "rebuild": "auto",
                        "distance": AUTO_DIST},
    "pps3d-scs-near": {"kuhn": "auto", "structure": "scs", "distance": AUTO_DIST},
    "pps3d-cabm-near": {"kuhn": "auto", "structure": "cabm", "distance": AUTO_DIST},
    "pps3d-scs-auto-fallback": {"kuhn": "auto", "structure": "scs", "rebuild": "auto"},
}
# the production mesh's arms: an arm's name + "-1M" runs it on
# bench_torch.PRODUCTION_MESH (written at first use); the arms on that mesh
# share one read of it and one cartesian grid
PRODUCTION = "-1M"
_PRODUCTION_CACHE = {}
GITR_ARMS = {  # arm -> bench_torch.setup_gitr keywords
    "gitr-reflect": {"wall": "reflect"},
    "gitr-absorb": {"wall": "absorb"},
}


def production_parts(dev, n: int, grid: bool = True):
    """(mesh, grid, seconds) of the production mesh, read once and its
    cartesian grid built once for every arm on it (``grid=False``: no grid
    needed yet); ``seconds``: the file, the read and the grid build."""
    from pumipic_torch.mesh.core import Mesh2D
    from pumipic_torch.mesh.gmsh import read_msh
    from pumipic_torch.models import pseudo_xgcm as px

    c = _PRODUCTION_CACHE
    if "mesh" not in c:
        t0 = time.perf_counter()
        path = bench_torch.production_mesh()
        c["seconds"] = {"mesh file": time.perf_counter() - t0}
        t0 = time.perf_counter()
        c["mesh"] = Mesh2D.from_arrays(*read_msh(path), device=dev)
        c["seconds"]["mesh"] = time.perf_counter() - t0
    if grid and "grid" not in c:
        mesh = c["mesh"]
        cfg = px.XGCmConfig(num_ptcls=n, mdl_face=max(int(mesh.class_id.max()) // 2, 2))
        t0 = time.perf_counter()
        c["grid"] = px.build_search(mesh, cfg, n)[1]
        torch.cuda.synchronize()
        c["seconds"]["grid build"] = time.perf_counter() - t0
    return c["mesh"], c.get("grid"), dict(c["seconds"])


def app_setup(dev, n: int, structure: str = "scs", production: bool = False):
    """(state, step, info) of the PseudoXGCm arm: bench_torch's mesh (or the
    production mesh and its shared grid) and settings on ``structure``; the
    state is the particle structure."""
    from pumipic_torch.mesh.core import Mesh2D
    from pumipic_torch.mesh.gmsh import read_msh
    from pumipic_torch.models import pseudo_xgcm as px

    t0 = time.perf_counter()
    grid, seconds = None, {}
    if production:
        mesh, grid, seconds = production_parts(dev, n)
        t0 = time.perf_counter()
    else:
        mesh = Mesh2D.from_arrays(*read_msh(bench_torch.DEFAULT_MESH), device=dev)
    cfg = px.XGCmConfig(num_ptcls=n, mdl_face=max(int(mesh.class_id.max()) // 2, 2),
                        deg_per_push=15.0, max_search_iters=64, structure=structure)
    app = px.PseudoXGCm(mesh, cfg, device=dev, locator=grid)

    def step(ptcls):
        ptcls, fwd, bwd, iters = app.step_fn(ptcls)
        return ptcls, {"fwd": fwd, "bwd": bwd, "iters": iters}

    name = "xgc_like_1M" if production else "xgc_like_120k"
    info = {"tag": f"app-{structure}-{name}",
            "setup_s": dict(seconds, app=time.perf_counter() - t0),
            "capacity": app.ptcls.capacity}
    return app.ptcls, step, info


def path_2d_setup(dev, n: int):
    """(state, step, info) of the 2D path arm: bench_torch's mesh, its
    seeded particles and cartesian grid; a step is one call of
    ``chip_smoke.trace2d_path_call``."""
    import chip_smoke
    from pumipic_torch.mesh.core import Mesh2D
    from pumipic_torch.mesh.gmsh import read_msh
    from pumipic_torch.models import pseudo_xgcm as px

    t0 = time.perf_counter()
    mesh = Mesh2D.from_arrays(*read_msh(bench_torch.DEFAULT_MESH), device=dev)
    cfg = px.XGCmConfig(num_ptcls=n, mdl_face=max(int(mesh.class_id.max()) // 2, 2),
                        deg_per_push=15.0, max_search_iters=64)
    s, dp = px.make_dp_setup(mesh, cfg, dev)
    grid = dp.model.locator
    gen = torch.Generator(dev).manual_seed(17)
    q = (0.5 + torch.rand(n, generator=gen, device=dev)).contiguous()

    def step(st):
        r1, r2, rho, w, cnt = chip_smoke.trace2d_path_call(
            mesh, grid, st["x"], st["elem"], st["active"], q, gen)
        return ({"x": r2.dest.contiguous(), "elem": r2.elem_ids, "active": r2.active},
                {"rho": rho, "w": w, "cnt": cnt})

    state = {"x": torch.stack([s["x0"], s["x1"]], 1).contiguous(), "elem": s["elem"],
             "active": s["active"]}
    return state, step, {"tag": "2d-path-xgc_like_120k",
                         "setup_s": {"setup": time.perf_counter() - t0}}


CHECK_RANGE = "port:check_initial_parents"


def ranged(fn, name: str):
    """``fn`` inside a ``record_function`` range of ``name``."""
    def call(*args, **kw):
        with torch.profiler.record_function(name):
            return fn(*args, **kw)
    return call


def range_device_ms(prof, names, steps: int) -> dict:
    """Device ms a step of each named ``record_function`` range, with its
    device activities (kernels, memsets, copies) by name.  The profiler
    spans each range on the device too (its GPU annotation: the activities
    the range's host code launched, ctypes launches included); an activity
    counts toward every range whose device span holds its start (nested
    ranges both count it)."""
    cuda = torch.autograd.DeviceType.CUDA
    evs = [e for e in prof.events() if e.device_type == cuda]
    spans = [(e.name, e.time_range.start, e.time_range.end) for e in evs if e.name in names]
    acts = [e for e in evs if e.name not in names]
    out = {name: {"ms": 0.0, "launches": 0, "spans": 0, "kernels": {}} for name in names}
    for name, t0, t1 in spans:
        rec = out[name]
        rec["spans"] += 1
        for a in acts:
            if t0 <= a.time_range.start < t1:
                key = a.name.replace("(anonymous namespace)", "{anonymous}").split("(")[0][:80]
                ms = a.time_range.elapsed_us() / 1e3 / steps
                rec["kernels"][key] = rec["kernels"].get(key, 0.0) + ms
                rec["ms"] += ms
                rec["launches"] += 1
    # the host side's tree sees only the activities of torch's own ops
    for e in prof.events():
        if e.name in names and e.device_type == torch.autograd.DeviceType.CPU:
            out[e.name]["torch_ops_ms"] = (out[e.name].get("torch_ops_ms", 0.0)
                                           + e.device_time_total / 1e3 / steps)
    for rec in out.values():
        rec["launches"] /= steps
        rec["kernels"] = dict(sorted(rec["kernels"].items(), key=lambda kv: -kv[1]))
    return out


def profile(arm: str, n: int, steps: int, smi: str) -> dict:
    dev = torch.device("cuda")
    ranges = ()
    production = arm.endswith(PRODUCTION)
    base = arm[:-len(PRODUCTION)] if production else arm
    if production and base.startswith("app"):
        state, step, info = app_setup(dev, n, base[4:] or "scs", production=True)
    elif production:
        kw = dict(ARMS[base], mesh_path=bench_torch.PRODUCTION_MESH)
        mesh, grid, seconds = production_parts(dev, n, grid=base not in ("band", "nolocator"))
        _, state, step, info = bench_torch.setup(dev, n, mesh=mesh, locator=grid, **kw)
        info["setup_s"] = dict(seconds, **info["setup_s"])
    elif arm == "2d-path":
        import chip_smoke
        from pumipic_torch.ops import search as se

        state, step, info = path_2d_setup(dev, n)
        ranges = chip_smoke.PATH_RANGES + (CHECK_RANGE,)
        se.check_initial_parents = ranged(se.check_initial_parents, CHECK_RANGE)
    elif arm.startswith("app"):
        state, step, info = app_setup(dev, n, arm[4:] or "scs")
    elif arm in PPS3D_ARMS:
        _, state, step, info = bench_torch.setup_pps3d(dev, n, **PPS3D_ARMS[arm])
    elif arm in GITR_ARMS:
        _, state, step, info = bench_torch.setup_gitr(dev, n, **GITR_ARMS[arm])
    else:
        _, state, step, info = bench_torch.setup(dev, n, **ARMS[arm])
    state, _ = step(state)
    torch.cuda.synchronize()
    kernels.reset_launches()

    # wall time without the profiler (and the host's enqueue time: the
    # launches return before the device is done), then device time with it
    t0 = time.perf_counter()
    for _ in range(steps):
        state, fields = step(state)
    enqueue = (time.perf_counter() - t0) / steps
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / steps
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(steps):
            state, fields = step(state)
        torch.cuda.synchronize()
    by_kernel = {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA or ev.key in ranges:
            continue                      # host ops and ranges; their kernels are listed
        # the name up to its argument list; kernels whose names differ only
        # there are summed
        name = ev.key.replace("(anonymous namespace)", "{anonymous}").split("(")[0]
        by_kernel[name] = by_kernel.get(name, 0.0) + ev.self_device_time_total / 1e3 / steps
    busy = sum(by_kernel.values())
    alive = state["active"] if isinstance(state, dict) else state.active
    return {
        "arm": arm, "tag": info["tag"], "card": smi, "num_ptcls": n,
        "steps": steps, "setup_s": info["setup_s"],
        "wall_ms_per_step": wall * 1e3,
        "host_enqueue_ms_per_step": enqueue * 1e3,
        "device_busy_ms_per_step": busy,
        "device_idle_share": 1.0 - busy / (wall * 1e3),
        "device_ms_per_step_by_kernel": dict(
            sorted(by_kernel.items(), key=lambda kv: -kv[1])),
        "alive": int(alive.sum()),
        **({"ranges": range_device_ms(prof, ranges, steps)} if ranges else {}),
        **({"capacity": info["capacity"]} if "capacity" in info else {}),
        # the auto rebuilds of the 2·steps steps, and how many reshuffled
        **({"auto_rebuilds": kernels.LAUNCHES["reshuffle_count"],
            "reshuffles": kernels.LAUNCHES["reshuffle_place"]}
           if kernels.LAUNCHES["reshuffle_count"] else {}),
    }


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 10_000_000
    steps = int(sys.argv[2]) if len(sys.argv) > 2 else 10
    arms = sys.argv[3:] or ["cartesian"]
    apps = ["app"] + [f"app-{s}" for s in ("csr", "cabm", "dps")]
    known = sorted(ARMS) + sorted(PPS3D_ARMS) + sorted(GITR_ARMS) + apps + ["2d-path"]
    known += [a + PRODUCTION for a in sorted(ARMS) + apps if a != "annulus"]
    unknown = set(arms) - set(known)
    if unknown:
        raise ValueError(f"unknown arms {sorted(unknown)}; known: {known}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    for arm in arms:
        print(json.dumps(profile(arm, n, steps, smi)), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
