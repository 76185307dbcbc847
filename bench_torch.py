"""Benchmark of the PyTorch/CUDA port: pseudoXGCm FULL-mode step throughput
on one GPU.

The port's counterpart of ``bench.py``'s default ``dp`` mode, at the same
settings: the imported 120k-element gmsh tokamak mesh
(``data/xgc_like_120k.msh.gz``), 10M particles, ``mdl_face`` = max class // 2,
15 degrees per push, 64 search iterations, the default gyro configuration.
Each step is push (kernel P) -> peel + walk + DPS rewrite (kernel L) ->
histogram (kernel H) -> gyro deposit (kernel D).

Environment knobs, as in ``bench.py`` (each also a keyword of :func:`main`,
which wins over the environment):

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
- ``BENCH_GYRO_PPR=1``: per-particle gyro radius (kernel H's key mode).

Prints ONE JSON line with bench.py's keys plus ``"impl": "torch"``, the GPU's
name and bench.py's row ``tag`` (e.g. ``dp-xgc_like_120k-bandloc``, ``dp``,
``dp-xgc_like_120k-pprad``) in ``detail``.  It writes no file.

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
              band_locator: str, gyro_ppr: bool) -> str:
    """``bench.py``'s row tag for its ``dp`` mode."""
    tag = "dp"
    if mesh_path not in GENERATED_MESHES:
        tag += "-" + os.path.basename(mesh_path).split(".")[0]
    if gyro_ppr:
        tag += "-pprad"
    if analytic_locate == "off":
        tag += "-walk"
    if band_locator == "force":
        tag += "-bandloc"
    if num_ptcls != 10_000_000:
        tag += f"-{num_ptcls // 1_000_000}M"
    return tag


def setup(device, num_ptcls=None, mesh_path=None, mesh_elems=None,
          analytic_locate=None, band_locator=None, band_theta=None,
          gyro_ppr=None, locator=None):
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
    )
    state, step = make_dp_setup(mesh, cfg, device, timings=seconds,
                                locator=locator)
    info = {"num_ptcls": num_ptcls, "setup_s": seconds,
            "tag": bench_tag(num_ptcls, mesh_path, analytic_locate,
                             band_locator, gyro_ppr)}
    return mesh, state, step, info


def main(device=None, num_ptcls=None, iters=None, verbose: bool = True,
         **knobs):
    """Run the benchmark; returns (record, state, fields): the JSON record
    (printed when ``verbose``), the final particle state and the last step's
    fields.  ``knobs`` are :func:`setup`'s keywords.  ``detail`` also holds
    the setup seconds by phase, the last step's ``iters`` and
    ``all_found``, and the row ``tag``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("bench_torch measures on a CUDA device and "
                               "none is available")
        device = "cuda"
    device = torch.device(device)
    iters = int(iters or os.environ.get("BENCH_ITERS", 20))
    mesh, state, step, info = setup(device, num_ptcls, **knobs)
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
        "alive": int(state["active"].sum()),
        "impl": "torch",
        "device": device.type,
        "gpu": (torch.cuda.get_device_name(device) if device.type == "cuda"
                else None),
        "iters": int(fields["iters"]),
        "all_found": bool(fields["all_found"]),
        "setup_s": info["setup_s"],
        "tag": info["tag"],
    }
    out = {
        "metric": "pseudoXGCm push+search+rebuild+gyroScatter throughput",
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
