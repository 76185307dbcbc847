"""Golden particle-file replay.

Reference parity: ``particle_structs/test/write_particle_file.cpp`` +
``read_particles.hpp:8-17`` — a plain-text format replayed identically across
every structure implementation and rank count:

    <num_elems> <num_ptcls>
    <elem_gid> <ppe>          (per element)
    <elem_lid> <x y z> <vx vy vz>   (per particle; our data schema)

We keep the same shape of fixture (deterministic file → identical build for
every layout) with a simple schema: positions (3,) float and values (3,) float
plus the particle's element.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def write_particle_file(
    path: str,
    num_elems: int,
    elem_gids: np.ndarray,
    ptcl_elems: np.ndarray,
    pos: np.ndarray,
    vals: np.ndarray,
) -> None:
    n = ptcl_elems.shape[0]
    ppe = np.bincount(ptcl_elems, minlength=num_elems)
    with open(path, "w") as f:
        f.write(f"{num_elems} {n}\n")
        for e in range(num_elems):
            f.write(f"{int(elem_gids[e])} {int(ppe[e])}\n")
        for p in range(n):
            f.write(
                f"{int(ptcl_elems[p])} "
                + " ".join(f"{x:.17g}" for x in pos[p])
                + " "
                + " ".join(f"{x:.17g}" for x in vals[p])
                + "\n"
            )


def read_particle_file(path: str) -> Dict[str, np.ndarray]:
    with open(path) as f:
        ne, np_ = map(int, f.readline().split())
        gids = np.zeros(ne, np.int64)
        ppe = np.zeros(ne, np.int64)
        for e in range(ne):
            a, b = f.readline().split()
            gids[e], ppe[e] = int(a), int(b)
        elems = np.zeros(np_, np.int64)
        pos = np.zeros((np_, 3))
        vals = np.zeros((np_, 3))
        for p in range(np_):
            parts = f.readline().split()
            elems[p] = int(parts[0])
            pos[p] = [float(x) for x in parts[1:4]]
            vals[p] = [float(x) for x in parts[4:7]]
    return {
        "num_elems": ne,
        "elem_gids": gids,
        "ptcls_per_elem": ppe,
        "ptcl_elems": elems,
        "pos": pos,
        "vals": vals,
    }
