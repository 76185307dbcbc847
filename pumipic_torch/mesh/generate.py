"""Host-side mesh generators (numpy), copied from
``pumipic_tpu.mesh.generate`` so that the port builds the same meshes
without importing JAX.

- :func:`rectangle_mesh` — structured triangle grid of a rectangle
- :func:`disk_mesh` — disk of concentric rings with radial-band classification
- :func:`annulus_mesh` — structured annulus with radial-band classification
- :func:`tokamak_mesh` — XGC-style stitched flux-surface mesh
- :func:`box_tet_mesh` — structured Kuhn tet mesh of a box (pseudoPushAndSearch)

``class_id`` is the 1-based radial band (innermost = 1), the geometric-model
classification pseudoXGCm drives on.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def rectangle_mesh(nx: int, ny: int, lx: float = 1.0, ly: float = 1.0,
                   x0: float = 0.0, y0: float = 0.0) -> Tuple[np.ndarray, np.ndarray]:
    """Structured triangle mesh of a rectangle: 2*nx*ny triangles."""
    xs = np.linspace(x0, x0 + lx, nx + 1)
    ys = np.linspace(y0, y0 + ly, ny + 1)
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    coords = np.stack([X.ravel(), Y.ravel()], axis=1)

    def vid(i, j):
        return i * (ny + 1) + j

    tris = []
    for i in range(nx):
        for j in range(ny):
            a, b, c, d = vid(i, j), vid(i + 1, j), vid(i + 1, j + 1), vid(i, j + 1)
            tris.append([a, b, c])
            tris.append([a, c, d])
    return coords, np.asarray(tris, dtype=np.int64)


def disk_mesh(n_rings: int, n_sectors0: int = 8, radius: float = 1.0,
              cx: float = 0.0, cy: float = 0.0
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Triangle mesh of a disk built from concentric rings: ring ``r``
    (1-based) has ``n_sectors0 * r`` vertices, so triangles are of near
    uniform size.  Returns (coords, tris, class_id), class_id the 1-based
    radial band of each triangle (innermost = 1)."""
    coords = [(cx, cy)]
    ring_start = [None]  # ring_start[r] = index of first vertex of ring r
    for r in range(1, n_rings + 1):
        ring_start.append(len(coords))
        n = n_sectors0 * r
        rad = radius * r / n_rings
        for k in range(n):
            th = 2 * np.pi * k / n
            coords.append((cx + rad * np.cos(th), cy + rad * np.sin(th)))
    coords = np.asarray(coords, dtype=np.float64)

    tris, cls = [], []
    n1 = n_sectors0                     # innermost fan
    s1 = ring_start[1]
    for k in range(n1):
        tris.append([0, s1 + k, s1 + (k + 1) % n1])
        cls.append(1)
    # band between ring r-1 (inner) and r (outer): merge walk by angle
    for r in range(2, n_rings + 1):
        ni = n_sectors0 * (r - 1)
        no = n_sectors0 * r
        si, so = ring_start[r - 1], ring_start[r]
        i = j = 0  # inner / outer cursor
        while i < ni or j < no:
            ai = (i + 0.5) / ni if i < ni else np.inf
            aj = (j + 0.5) / no if j < no else np.inf
            if aj <= ai:                # advance outer
                tris.append([so + j % no, so + (j + 1) % no, si + i % ni])
                j += 1
            else:                       # advance inner
                tris.append([si + (i + 1) % ni, si + i % ni, so + j % no])
                i += 1
            cls.append(r)
    return coords, np.asarray(tris, dtype=np.int64), np.asarray(cls, dtype=np.int64)


def annulus_mesh(n_rings: int, n_sectors: int, r_in: float, r_out: float,
                 cx: float = 0.0, cy: float = 0.0
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Structured annulus (tokamak-cross-section-like) triangle mesh.

    Constant sector count per ring; class_id = radial band (1-based from the
    inner edge).
    """
    coords = []
    for r in range(n_rings + 1):
        rad = r_in + (r_out - r_in) * r / n_rings
        for k in range(n_sectors):
            th = 2 * np.pi * k / n_sectors
            coords.append((cx + rad * np.cos(th), cy + rad * np.sin(th)))
    coords = np.asarray(coords, dtype=np.float64)

    def vid(r, k):
        return r * n_sectors + (k % n_sectors)

    tris, cls = [], []
    for r in range(n_rings):
        for k in range(n_sectors):
            a, b = vid(r, k), vid(r, k + 1)
            c, d = vid(r + 1, k), vid(r + 1, k + 1)
            tris.append([a, b, d])
            tris.append([a, d, c])
            cls.extend([r + 1, r + 1])
    return coords, np.asarray(tris, dtype=np.int64), np.asarray(cls, dtype=np.int64)


def _stitch_rings(tris, cls, band, thi, si, tho, so):
    """Triangulate the band between two closed vertex rings with arbitrary
    (different) point counts and angular samplings, by a merge walk over the
    edge-midpoint angles.  ``thi``/``tho``: normalized angles in [0, 1),
    ascending; ``si``/``so``: first vertex index of each ring."""
    ni, no = len(thi), len(tho)

    def mid(th, k):
        n = len(th)
        a = th[k]
        b = th[k + 1] if k + 1 < n else th[0] + 1.0
        return 0.5 * (a + b)

    i = j = 0
    while i < ni or j < no:
        ai = mid(thi, i) if i < ni else np.inf
        aj = mid(tho, j) if j < no else np.inf
        if aj <= ai:
            tris.append([so + j % no, so + (j + 1) % no, si + i % ni])
            j += 1
        else:
            tris.append([si + (i + 1) % ni, si + i % ni, so + j % no])
            i += 1
        cls.append(band)


def tokamak_mesh(
    n_surfaces: int = 24,
    base_points: int = 64,
    r_in_frac: float = 0.25,
    kappa: float = 1.6,
    delta: float = 0.38,
    shafranov: float = 0.08,
    ragged: float = 0.25,
    edge_grading: float = 2.0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """XGC-style tokamak cross-section mesh on Miller flux surfaces.

    Unlike the smooth annulus proxy, this produces the features of real
    XGC meshes (the 24k/120k .osh workloads, test/testing.cmake:114-130):
    D-shaped flux surfaces (elongation ``kappa``, triangularity ``delta``,
    Shafranov shift), per-surface point counts that vary RAGGEDLY (so bands
    have unequal, non-divisible counts and the stitch produces irregular,
    sliver-prone triangles), and radial spacing graded toward the edge
    pedestal (``edge_grading`` > 1 = finer near the separatrix).

    class_id = 1-based flux band (innermost = 1), the geometric-model
    classification pseudoXGCm drives on.
    """
    rng = np.random.default_rng(n_surfaces * 7919 + base_points)
    a = 1.0
    r_in = r_in_frac * a

    # graded flux-surface radii: finer near the edge
    s = np.linspace(0.0, 1.0, n_surfaces + 1)
    r = r_in + (a - r_in) * (1.0 - (1.0 - s) ** edge_grading)
    r = r_in + (a - r_in) * (r - r[0]) / (r[-1] - r[0])

    coords = []
    ring_theta = []
    ring_start = []
    for k, rk in enumerate(r):
        frac = (rk - r_in) / (a - r_in)
        nk = max(int(base_points * (0.35 + 0.65 * frac)
                     * (1.0 + ragged * np.sin(5.0 * np.pi * frac))), 12)
        off = 0.2 * rng.uniform() / nk
        th = (np.arange(nk) / nk + off) % 1.0
        th.sort()
        ring_theta.append(th)
        ring_start.append(len(coords))
        ang = 2.0 * np.pi * th
        kap = 1.0 + (kappa - 1.0) * frac          # elongation grows outward
        del_ = delta * frac ** 2                  # triangularity at the edge
        shift = shafranov * (1.0 - frac ** 2)     # Shafranov shift inward
        x = shift + rk * np.cos(ang + del_ * np.sin(ang))
        y = kap * rk * np.sin(ang)
        coords.extend(zip(x, y))
    coords = np.asarray(coords, np.float64)

    tris, cls = [], []
    for k in range(n_surfaces):
        _stitch_rings(
            tris, cls, k + 1,
            ring_theta[k], ring_start[k],
            ring_theta[k + 1], ring_start[k + 1],
        )
    return (coords, np.asarray(tris, np.int64), np.asarray(cls, np.int64))


def box_tet_mesh(nx: int, ny: int, nz: int,
                 lx: float = 1.0, ly: float = 1.0, lz: float = 1.0
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Structured tet mesh of a box: 6 tets per hex cell (Kuhn subdivision
    along the vertex-permutation paths 000 -> 111), a conforming mesh (the
    cube.msh analog of pseudoPushAndSearch)."""
    xs = np.linspace(0, lx, nx + 1)
    ys = np.linspace(0, ly, ny + 1)
    zs = np.linspace(0, lz, nz + 1)
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    coords = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)

    # path order (x,y,z) (x,z,y) (y,x,z) (y,z,x) (z,x,y) (z,y,x), as bits
    paths = [(1, 2, 4), (1, 4, 2), (2, 1, 4), (2, 4, 1), (4, 1, 2), (4, 2, 1)]
    corner = {0: (0, 0, 0), 1: (1, 0, 0), 2: (0, 1, 0), 4: (0, 0, 1),
              3: (1, 1, 0), 5: (1, 0, 1), 6: (0, 1, 1), 7: (1, 1, 1)}
    # per path, the 4 corner offsets of its tet
    offs = np.array([[corner[a] for a in np.cumsum((0,) + p)] for p in paths])
    i, j, k = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                          indexing="ij")
    base = np.stack([i.ravel(), j.ravel(), k.ravel()], axis=1)   # cells, (i,j,k) order
    v = base[:, None, None, :] + offs[None]                      # (cells, 6, 4, 3)
    tets = (v[..., 0] * (ny + 1) + v[..., 1]) * (nz + 1) + v[..., 2]
    return coords, tets.reshape(-1, 4).astype(np.int64)
