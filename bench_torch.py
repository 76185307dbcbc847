"""Benchmark of the PyTorch/CUDA port: pseudoXGCm FULL-mode step throughput
on one GPU.

The port's counterpart of ``bench.py``'s default ``dp`` mode, at the same
settings: the imported 120k-element gmsh tokamak mesh
(``data/xgc_like_120k.msh.gz``), 10M particles, ``mdl_face`` = max class // 2,
15 degrees per push, 64 search iterations, the default gyro configuration.
Each step is push (kernel P) -> peel + walk + DPS rewrite (kernel L) ->
histogram (kernel H) -> gyro deposit (kernel D).

Environment knobs, as in ``bench.py``: ``BENCH_PTCLS`` (particles, default
10M), ``BENCH_ITERS`` (timed steps, default 20), ``BENCH_MESH`` (a .msh or
.msh.gz path).  Prints ONE JSON line with bench.py's keys plus
``"impl": "torch"`` and the GPU's name in ``detail``.  It writes no file.

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


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(device=None, num_ptcls=None, iters=None, mesh_path=None,
         verbose: bool = True):
    """Run the benchmark; returns (record, state, fields): the JSON record
    (printed when ``verbose``), the final particle state and the last step's
    fields.  ``detail`` also holds the setup seconds by phase and the last
    step's ``iters`` and ``all_found``."""
    from pumipic_torch.mesh.core import Mesh2D
    from pumipic_torch.mesh.gmsh import read_msh
    from pumipic_torch.models.pseudo_xgcm import (
        GyroConfig, XGCmConfig, make_dp_setup)

    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("bench_torch measures on a CUDA device and "
                               "none is available")
        device = "cuda"
    device = torch.device(device)
    num_ptcls = int(num_ptcls or os.environ.get("BENCH_PTCLS", 10_000_000))
    iters = int(iters or os.environ.get("BENCH_ITERS", 20))
    mesh_path = mesh_path or os.environ.get("BENCH_MESH") or DEFAULT_MESH

    setup = {}
    t0 = time.perf_counter()
    coords, tris, cls = read_msh(mesh_path)
    mesh = Mesh2D.from_arrays(coords, tris, cls, device=device)
    setup["mesh"] = time.perf_counter() - t0
    cfg = XGCmConfig(
        num_ptcls=num_ptcls,
        mdl_face=max(int(cls.max()) // 2, 2),
        deg_per_push=15.0,
        max_search_iters=64,
        gyro=GyroConfig(),
    )
    state, step = make_dp_setup(mesh, cfg, device, timings=setup)
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
        "ms_per_step": dt * 1e3,
        "chips": 1,
        "alive": int(state["active"].sum()),
        "impl": "torch",
        "device": device.type,
        "gpu": (torch.cuda.get_device_name(device) if device.type == "cuda"
                else None),
        "iters": int(fields["iters"]),
        "all_found": bool(fields["all_found"]),
        "setup_s": setup,
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
