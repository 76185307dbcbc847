"""Setup seconds of the 2D locators on one mesh, by phase, on one CUDA GPU.

    python3 scripts/locator_build.py [mesh] [--host] [--band]

``mesh``: a .msh/.msh.gz path (default: ``bench_torch``'s production mesh,
the ~1M-element tokamak, written at first use).  Times the gmsh read, the
``Mesh2D`` build on the card, then the cartesian grid at the FULL-mode
policy (``resolve_locator_policy``: cpe 4 here) in its two parts: the
cells (centroid buckets and the flood fill, host numpy) and the cell rows'
calibration (``attach_cell_rows``: the seeded draws, the walk of 8
samples a cell, the two candidates a cell) with the walk as torch ops on
the card; ``--host`` also calibrates with the numpy host walk and requires
equal rows; ``--band`` also times the flux-band locator's build
(``detect_banded_locator``: the fit, the sizing, the calibration by
sampled elements).  Prints one JSON line with the seconds, the grid's
shape and table bytes, and the card's name and power limit.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import bench_torch  # noqa: E402


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    path = args[0] if args else bench_torch.production_mesh()
    from pumipic_torch.mesh import locator as loc
    from pumipic_torch.mesh.core import Mesh2D
    from pumipic_torch.mesh.gmsh import read_msh
    from pumipic_torch.models import pseudo_xgcm as px

    dev = torch.device("cuda")
    sec = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        sec[name] = time.perf_counter() - t0
        return out

    coords, tris, cls = timed("read_msh", lambda: read_msh(path))
    mesh = timed("Mesh2D", lambda: Mesh2D.from_arrays(coords, tris, cls, device=dev))
    cpe, peel, _ = px.resolve_locator_policy(px.XGCmConfig(), mesh.nelems, 10_000_000)
    cells = timed("grid cells", lambda: loc.build_locator_grid(
        coords, tris, cells_per_elem=cpe, peel=peel, device=dev))
    geom = mesh.walk_geom.cpu()
    grid = timed("cell rows, device walk", lambda: loc.attach_cell_rows(cells, geom))
    out = {"mesh": os.path.basename(path), "elements": mesh.nelems, "cpe": cpe,
           "cells": grid.nx * grid.ny,
           "cell_rows_mb": grid.cell_rows.numel() * 4 / 1e6,
           "walk_geom_mb": mesh.walk_geom.numel() * 4 / 1e6}
    if "--host" in sys.argv:
        on_host = dataclasses.replace(cells, cell_elem=cells.cell_elem.cpu())
        host = timed("cell rows, host walk", lambda: loc.attach_cell_rows(on_host, geom))
        out["host_equal"] = bool(torch.equal(host.cell_rows, grid.cell_rows.cpu()))
        if not out["host_equal"]:
            raise AssertionError("device-calibrated cell rows differ from the host build's")
    if "--band" in sys.argv:
        band = timed("band locator", lambda: loc.detect_banded_locator(
            coords, tris, cls, mesh.walk_geom, device=dev))
        out["band"] = None if band is None else {
            "bands": band.n_bands, "theta_bins": band.n_theta,
            "cell_rows_mb": band.cell_rows.numel() * 4 / 1e6}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    out.update(seconds=sec, card=smi)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
