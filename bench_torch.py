"""Benchmark of the PyTorch/CUDA port on one GPU: pseudoXGCm FULL-mode step
throughput (``BENCH_MODE=dp``, the default) and pseudoPushAndSearch's 3D
step (``BENCH_MODE=pps3d``).

``dp`` is the port's counterpart of ``bench.py``'s default mode, at the same
settings: the imported 120k-element gmsh tokamak mesh
(``data/xgc_like_120k.msh.gz``), 10M particles, ``mdl_face`` = max class // 2,
15 degrees per push, 64 search iterations, the default gyro configuration.
Each step is push (kernel P) -> peel + walk + DPS rewrite (kernel L) ->
histogram (kernel H) -> gyro deposit (kernel D).

``pps3d`` is ``bench.py``'s pps3d mode: ``box_tet_mesh(n, n, n)`` with n =
round((BENCH_ELEMS / 6)^(1/3)) (16 for the default 24,000: 24,576 tets),
10M particles, a periodic wall, 64 search iterations.  Each step is push +
wrap + analytic Kuhn locate (kernel K) or, with ``BENCH_KUHN=off``, push +
wrap + peel + BCC walk (kernel L3), then the structure's rebuild.

Environment knobs, as in ``bench.py`` (each also a keyword of :func:`main`,
which wins over the environment):

- ``BENCH_MODE`` (``mode``): ``dp`` or ``pps3d``;
- ``BENCH_PTCLS`` (particles, default 10M), ``BENCH_ITERS`` (timed steps,
  default 20);
- ``BENCH_MESH``: a .msh or .msh.gz path, or ``annulus`` for the generated
  structured annulus of ``BENCH_ELEMS`` elements (default 24,000; 23,976
  triangles), whose proven analytic locate is kernel A;
- ``BENCH_ANALYTIC`` (``analytic_locate``, default ``auto``; ``off`` walks
  even on the annulus);
- ``BENCH_BANDLOC`` (``band_locator``, default ``auto``; ``force`` takes
  the flux-band locator, kernels B + L) and ``BENCH_BANDT`` (its θ-bins
  per band, default: the JAX package's sizing rule);
- ``BENCH_GYRO_PPR=1``: per-particle gyro radius (kernel H's key mode);
- ``BENCH_ROT_ANALYTIC=0`` (``rot_analytic``): the per-element rotation
  table push (kernel P's table mode) instead of the band classes;
- pps3d: ``BENCH_ELEMS``, ``BENCH_STRUCT`` (``structure``, default
  ``dps``), ``BENCH_KUHN`` (``kuhn``, default ``auto``; ``off`` walks),
  ``BENCH_DIST`` (``distance``, default 0.05) and ``BENCH_REBUILD``
  (``rebuild``, default ``sort``).

Prints ONE JSON line with bench.py's keys plus ``"impl": "torch"``, the GPU's
name and bench.py's row ``tag`` (e.g. ``dp-xgc_like_120k-bandloc``, ``dp``,
``dp-xgc_like_120k-rotgather``, ``pps3d-dps``, ``pps3d-dps-walk``) in
``detail``.  It writes no file.

    python3 bench_torch.py

Measures on a CUDA device and fails without one.  ``main(device="cpu")`` runs
the same path on the CPU, with the kernels' plain versions, for rehearsals;
its JSON then names the CPU and no GPU.
"""
from __future__ import annotations

import json
import os
import time

import torch

PROXY_BASELINE_PTCLS_PER_SEC = 2.0e7
DEFAULT_MESH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "data", "xgc_like_120k.msh.gz")
GENERATED_MESHES = ("annulus", "gen", "none")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bench_tag(num_ptcls: int, mesh_path: str, analytic_locate: str,
              band_locator: str, gyro_ppr: bool, rot_analytic: bool = True) -> str:
    """``bench.py``'s row tag for its ``dp`` mode."""
    tag = "dp"
    if mesh_path not in GENERATED_MESHES:
        tag += "-" + os.path.basename(mesh_path).split(".")[0]
    if gyro_ppr:
        tag += "-pprad"
    if analytic_locate == "off":
        tag += "-walk"
    if not rot_analytic:
        tag += "-rotgather"
    if band_locator == "force":
        tag += "-bandloc"
    if num_ptcls != 10_000_000:
        tag += f"-{num_ptcls // 1_000_000}M"
    return tag


def pps3d_tag(num_ptcls: int, structure: str, rebuild: str, kuhn: str) -> str:
    """``bench.py``'s row tag for its ``pps3d`` mode."""
    tag = f"pps3d-{structure}"
    if rebuild != "sort":
        tag += "-" + rebuild
    if kuhn == "off":
        tag += "-walk"
    if num_ptcls != 10_000_000:
        tag += f"-{num_ptcls // 1_000_000}M"
    return tag


def setup_pps3d(device, num_ptcls=None, mesh_elems=None, structure=None,
                kuhn=None, distance=None, rebuild=None, locator=None):
    """Resolve the pps3d knobs (a keyword, else its environment variable,
    else ``bench.py``'s default) and build the app on ``device``.  Returns
    (mesh, state, step, info) as :func:`setup`; the state is the particle
    structure and ``step`` returns (structure, {"iters": ...}).  ``locator``:
    a 3D grid already built for this mesh (the walk arm skips the build)."""
    from pumipic_torch.mesh.core import Mesh3D
    from pumipic_torch.mesh.generate import box_tet_mesh
    from pumipic_torch.models.pseudo_push_and_search import (
        PseudoPushAndSearch, PushSearchConfig)

    env = os.environ.get
    num_ptcls = int(num_ptcls or env("BENCH_PTCLS", 10_000_000))
    mesh_elems = int(mesh_elems or env("BENCH_ELEMS", 24_000))
    structure = structure or env("BENCH_STRUCT", "dps")
    kuhn = kuhn or env("BENCH_KUHN", "auto")
    distance = float(distance or env("BENCH_DIST", 0.05))
    rebuild = rebuild or env("BENCH_REBUILD", "sort")

    seconds = {}
    t0 = time.perf_counter()
    n_side = max(int(round((mesh_elems / 6) ** (1.0 / 3.0))), 2)
    mesh = Mesh3D.from_arrays(*box_tet_mesh(n_side, n_side, n_side), device=device)
    seconds["mesh"] = time.perf_counter() - t0
    cfg = PushSearchConfig(num_ptcls=num_ptcls, structure=structure,
                           wall="periodic", distance=distance,
                           max_search_iters=64, rebuild_mode=rebuild, kuhn=kuhn)
    app = PseudoPushAndSearch(mesh, cfg, device=device, locator=locator)
    seconds.update(app.setup_s)

    def step(ptcls):
        ptcls, iters = app.step_fn(ptcls)
        return ptcls, {"iters": iters}

    info = {"num_ptcls": num_ptcls, "setup_s": seconds,
            "tag": pps3d_tag(num_ptcls, structure, rebuild, kuhn)}
    return mesh, app.ptcls, step, info


def setup(device, num_ptcls=None, mesh_path=None, mesh_elems=None,
          analytic_locate=None, band_locator=None, band_theta=None,
          gyro_ppr=None, locator=None, rot_analytic=None):
    """Resolve the knobs (a keyword, else its environment variable, else
    ``bench.py``'s default) and build the run on ``device``.  Returns
    (mesh, state, step, info): ``info`` holds ``num_ptcls``, the row
    ``tag`` and the setup seconds by phase (``setup_s``).  ``locator``: a
    grid already built for this mesh and configuration, passed on to
    ``make_dp_setup`` (it skips the build)."""
    from pumipic_torch.mesh.core import Mesh2D
    from pumipic_torch.mesh.gmsh import read_msh
    from pumipic_torch.models.pseudo_xgcm import (
        GyroConfig, XGCmConfig, make_default_mesh, make_dp_setup)

    env = os.environ.get
    num_ptcls = int(num_ptcls or env("BENCH_PTCLS", 10_000_000))
    mesh_path = mesh_path or env("BENCH_MESH") or DEFAULT_MESH
    mesh_elems = int(mesh_elems or env("BENCH_ELEMS", 24_000))
    analytic_locate = analytic_locate or env("BENCH_ANALYTIC", "auto")
    band_locator = band_locator or env("BENCH_BANDLOC", "auto")
    if band_theta is None and env("BENCH_BANDT"):
        band_theta = int(env("BENCH_BANDT"))
    if gyro_ppr is None:
        gyro_ppr = bool(int(env("BENCH_GYRO_PPR", "0")))
    if rot_analytic is None:
        rot_analytic = bool(int(env("BENCH_ROT_ANALYTIC", "1")))

    seconds = {}
    t0 = time.perf_counter()
    if mesh_path in GENERATED_MESHES:
        mesh = make_default_mesh(mesh_elems, device=device)
    else:
        coords, tris, cls = read_msh(mesh_path)
        mesh = Mesh2D.from_arrays(coords, tris, cls, device=device)
    seconds["mesh"] = time.perf_counter() - t0
    cfg = XGCmConfig(
        num_ptcls=num_ptcls,
        mdl_face=max(int(mesh.class_id.max()) // 2, 2),
        deg_per_push=15.0,
        max_search_iters=64,
        gyro=GyroConfig(per_particle_radius=gyro_ppr),
        analytic_locate=analytic_locate,
        band_locator=band_locator,
        band_theta=band_theta,
        rot_analytic=rot_analytic,
    )
    state, step = make_dp_setup(mesh, cfg, device, timings=seconds,
                                locator=locator)
    info = {"num_ptcls": num_ptcls, "setup_s": seconds,
            "tag": bench_tag(num_ptcls, mesh_path, analytic_locate,
                             band_locator, gyro_ppr, rot_analytic)}
    return mesh, state, step, info


def main(device=None, num_ptcls=None, iters=None, verbose: bool = True,
         mode=None, **knobs):
    """Run the benchmark; returns (record, state, fields): the JSON record
    (printed when ``verbose``), the final particle state (a structure in
    pps3d mode) and the last step's fields.  ``knobs`` are :func:`setup`'s
    (dp) or :func:`setup_pps3d`'s (pps3d) keywords.  ``detail`` also holds
    the setup seconds by phase, the last step's ``iters`` (and, in dp mode,
    ``all_found``), and the row ``tag``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("bench_torch measures on a CUDA device and "
                               "none is available")
        device = "cuda"
    device = torch.device(device)
    iters = int(iters or os.environ.get("BENCH_ITERS", 20))
    mode = mode or os.environ.get("BENCH_MODE", "dp")
    if mode not in ("dp", "pps3d"):
        raise ValueError(f"unknown BENCH_MODE {mode!r}: dp or pps3d")
    pps3d = mode == "pps3d"
    mesh, state, step, info = (setup_pps3d if pps3d else setup)(
        device, num_ptcls, **knobs)
    num_ptcls = info["num_ptcls"]
    _sync(device)

    # warm-up step
    state, fields = step(state)
    _sync(device)

    t0 = time.perf_counter()
    for _ in range(iters):
        state, fields = step(state)
    _sync(device)
    dt = (time.perf_counter() - t0) / iters

    rate = num_ptcls / dt
    detail = {
        "num_ptcls": num_ptcls,
        "mesh_elems": mesh.nelems,
        "mesh_verts": mesh.nverts,
        "ms_per_step": dt * 1e3,
        "chips": 1,
        "alive": int((state.active if pps3d else state["active"]).sum()),
        "impl": "torch",
        "device": device.type,
        "gpu": (torch.cuda.get_device_name(device) if device.type == "cuda"
                else None),
        "iters": int(fields["iters"]),
        "setup_s": info["setup_s"],
        "tag": info["tag"],
    }
    if not pps3d:
        detail["all_found"] = bool(fields["all_found"])
    out = {
        "metric": ("pseudoPushAndSearch 3D push+search+rebuild throughput" if pps3d
                   else "pseudoXGCm push+search+rebuild+gyroScatter throughput"),
        "value": rate,
        "unit": "particle-steps/s/chip",
        "vs_baseline": rate / PROXY_BASELINE_PTCLS_PER_SEC,
        "detail": detail,
    }
    if verbose:
        print(json.dumps(out), flush=True)
    return out, state, fields


if __name__ == "__main__":
    main()
