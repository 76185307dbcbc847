"""Legacy-VTK mesh/field writer (render parity).

The reference dumps its picpart meshes + tags through Omega_h's VTK path for
visualization (``render`` in test/pseudoXGCm.cpp:64-69).  This writes the
same content as ASCII legacy ``.vtk`` unstructured grids readable by
ParaView/VisIt: coords, tri/tet connectivity, per-element and per-vertex
scalar fields.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

_CELL_TYPES = {3: 5, 4: 10}  # tri -> VTK_TRIANGLE, tet -> VTK_TETRA


def write_vtk(
    path: str,
    coords: np.ndarray,
    elem2verts: np.ndarray,
    elem_fields: Optional[Dict[str, np.ndarray]] = None,
    vert_fields: Optional[Dict[str, np.ndarray]] = None,
    title: str = "pumipic_torch",
) -> None:
    coords = np.asarray(coords, np.float64)
    ev = np.asarray(elem2verts, np.int64)
    V, dim = coords.shape
    E, k = ev.shape
    if not path.endswith(".vtk"):
        path = path + ".vtk"
    with open(path, "w") as f:
        f.write(f"# vtk DataFile Version 3.0\n{title}\nASCII\n")
        f.write("DATASET UNSTRUCTURED_GRID\n")
        f.write(f"POINTS {V} double\n")
        for p in coords:
            z = p[2] if dim == 3 else 0.0
            f.write(f"{p[0]:.9g} {p[1]:.9g} {z:.9g}\n")
        f.write(f"CELLS {E} {E * (k + 1)}\n")
        for row in ev:
            f.write(f"{k} " + " ".join(map(str, row)) + "\n")
        f.write(f"CELL_TYPES {E}\n")
        f.write("\n".join([str(_CELL_TYPES[k])] * E) + "\n")

        if elem_fields:
            f.write(f"CELL_DATA {E}\n")
            for name, arr in elem_fields.items():
                arr = np.asarray(arr)
                f.write(f"SCALARS {name} double 1\nLOOKUP_TABLE default\n")
                f.write("\n".join(f"{x:.9g}" for x in arr.astype(float)) + "\n")
        if vert_fields:
            f.write(f"POINT_DATA {V}\n")
            for name, arr in vert_fields.items():
                arr = np.asarray(arr)
                f.write(f"SCALARS {name} double 1\nLOOKUP_TABLE default\n")
                f.write("\n".join(f"{x:.9g}" for x in arr.astype(float)) + "\n")


def write_particles_vtk(path: str, pos: np.ndarray,
                        fields: Optional[Dict[str, np.ndarray]] = None) -> None:
    """Particle cloud as VTK polydata vertices."""
    pos = np.asarray(pos, np.float64)
    n, dim = pos.shape
    if not path.endswith(".vtk"):
        path = path + ".vtk"
    with open(path, "w") as f:
        f.write("# vtk DataFile Version 3.0\nptcls\nASCII\n")
        f.write("DATASET POLYDATA\n")
        f.write(f"POINTS {n} double\n")
        for p in pos:
            z = p[2] if dim == 3 else 0.0
            f.write(f"{p[0]:.9g} {p[1]:.9g} {z:.9g}\n")
        f.write(f"VERTICES {n} {2 * n}\n")
        for i in range(n):
            f.write(f"1 {i}\n")
        if fields:
            f.write(f"POINT_DATA {n}\n")
            for name, arr in fields.items():
                f.write(f"SCALARS {name} double 1\nLOOKUP_TABLE default\n")
                f.write("\n".join(f"{x:.9g}" for x in np.asarray(arr).astype(float)) + "\n")
