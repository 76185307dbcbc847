"""Uniform-grid point-location accelerator (port of the cartesian "rows"
path of ``pumipic_tpu.mesh.locator``).

A background grid maps each cell to a nearby element; the search starts
its walk from the grid's guess of the DESTINATION.  Each cell also carries
two sample-calibrated candidate rows, ``cell_rows`` (n_cells, 14) f32:

    [A affine (6) | elemA | B affine (6) | elemB]

so the first containment test of most particles is one 56-byte row load
(the peel in :func:`pumipic_torch.ops.search.search_mesh_2d_accel`).  The
guess is only an accelerator: the walk still proves containment.

Only the cartesian grid with the 2-candidate rows is ported.  The JAX
package's other locators and layouts change which element a walk starts
from, never its result:

- ``polar="auto"`` resolves to cartesian cells here; ``polar=True`` raises.
- The peel variants "lines", "rows_split" and "rows_ab" map onto "rows".
- The flux-band grid (``BandGrid2D``) and the structured-annulus analytic
  locator (``AnnulusLocator2D``) are not ported.  Their host-only proof,
  :func:`detect_annulus_structured`, is, so that the model can refuse a
  mesh on which the JAX package would take the analytic path.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from pumipic_torch.mesh.core import F32_EXACT_ID_LIMIT
from pumipic_torch.utils.types import LID_DTYPE

# peel layouts the JAX package knows; the 2D ones all map onto "rows"
ROWS_PEELS = ("auto", "rows", "lines", "rows_split", "rows_ab")
KNOWN_PEELS = ROWS_PEELS + ("rows_abc", "ids", "ids4")


@dataclass(frozen=True)
class LocatorGrid2D:
    """Cartesian locator grid.  ``origin``/``inv_h`` are host floats that are
    exact f32 values (the JAX package stores them as f32 arrays)."""

    origin: Tuple[float, float]
    inv_h: Tuple[float, float]
    cell_elem: torch.Tensor               # (nx*ny,) i32 nearest element
    nx: int
    ny: int
    cell_rows: Optional[torch.Tensor] = None   # (nx*ny, 14) f32

    def cell_of(self, px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
        """Points -> (N,) clamped cell ids, in f32 index arithmetic exactly
        as the JAX package computes them (exact below 2^24 cells).  The
        final integer clamp only guards non-finite points."""
        rx = (px - self.origin[0]) * self.inv_h[0]
        ry = (py - self.origin[1]) * self.inv_h[1]
        ix = torch.clamp(torch.floor(rx), 0.0, float(self.nx - 1))
        iy = torch.clamp(torch.floor(ry), 0.0, float(self.ny - 1))
        c = (ix * float(self.ny) + iy).to(torch.int32)
        return torch.clamp(c, 0, self.nx * self.ny - 1)


def _check_ids_f32_exact(geom: np.ndarray) -> None:
    if geom.shape[0] >= F32_EXACT_ID_LIMIT:
        raise ValueError(
            f"{geom.shape[0]} elements: element ids stored as f32 cell-row "
            f"columns are only exact below 2^24")


def _topk_per_cell(cell, found, ce, k=2):
    """Top-k elements per cell by sample count.  Returns k arrays; rank j
    falls back to rank j-1's value where a cell has fewer than j+1 distinct
    sampled elements."""
    valid = found >= 0
    c_v, e_v = cell[valid], found[valid]
    order = np.lexsort((e_v, c_v))
    c_s, e_s = c_v[order], e_v[order]
    new_run = np.ones(len(c_s), bool)
    new_run[1:] = (c_s[1:] != c_s[:-1]) | (e_s[1:] != e_s[:-1])
    starts = np.nonzero(new_run)[0]
    counts = np.diff(np.append(starts, len(c_s)))
    rc, re = c_s[starts], e_s[starts]
    o2 = np.lexsort((-counts, rc))
    rc2, re2 = rc[o2], re[o2]
    # rank of each (cell, elem) run within its cell (0 = most sampled)
    first = np.ones(len(rc2), bool)
    first[1:] = rc2[1:] != rc2[:-1]
    run_start = np.maximum.accumulate(np.where(first, np.arange(len(rc2)), 0))
    rank = np.arange(len(rc2)) - run_start
    outs = []
    prev = ce.copy()
    for j in range(k):
        cur = prev.copy()
        sel = rank == j
        cur[rc2[sel]] = re2[sel]
        outs.append(cur)
        prev = cur
    return outs


def _top2_per_cell(cell, found, ce):
    a, b = _topk_per_cell(cell, found, ce, 2)
    return a, b


def _host_walk(geom: np.ndarray, e0: np.ndarray, px: np.ndarray,
               py: np.ndarray, iters: int = 24) -> np.ndarray:
    """Vectorized host-side BCC walk (build-time only): locate (px, py)
    starting from e0; -1 where the walk exits the domain / doesn't settle."""
    e = np.asarray(e0, np.int64).copy()
    done = e < 0
    for _ in range(iters):
        g = geom[np.maximum(e, 0)]
        l1 = g[:, 0] * px + g[:, 1] * py + g[:, 2]
        l2 = g[:, 3] * px + g[:, 4] * py + g[:, 5]
        w0 = 1.0 - l1 - l2
        inside = np.minimum(np.minimum(l1, l2), w0) >= -1e-6
        done_new = done | inside
        wmin = np.minimum(w0, l1)
        kmin = np.where(w0 <= l1, 0, 1)
        kmin = np.where(l2 < wmin, 2, kmin)
        nxt = np.take_along_axis(
            g[:, 6:9], kmin[:, None], axis=1)[:, 0].astype(np.int64)
        e = np.where(done_new, e, nxt)
        exited = ~done_new & (e < 0)
        done = done_new | exited
        if done.all():
            break
    g = geom[np.maximum(e, 0)]
    l1 = g[:, 0] * px + g[:, 1] * py + g[:, 2]
    l2 = g[:, 3] * px + g[:, 4] * py + g[:, 5]
    w0 = 1.0 - l1 - l2
    ok = (e >= 0) & (np.minimum(np.minimum(l1, l2), w0) >= -1e-6)
    return np.where(ok, e, -1)


def attach_cell_rows(grid: LocatorGrid2D, walk_geom,
                     samples_per_cell: int = 8,
                     seed: int = 1729) -> LocatorGrid2D:
    """Return a copy of ``grid`` whose cells carry TWO candidate walk rows.

    Candidates are calibrated by stratified random samples per cell located
    exactly on the host: A = the element covering the most samples, B = the
    second (B = A when one element covers the whole cell).  Same seed and
    draws as the JAX package, so the table is bit-equal.
    """
    geom = (walk_geom.cpu().numpy() if isinstance(walk_geom, torch.Tensor)
            else np.asarray(walk_geom))
    _check_ids_f32_exact(geom)
    ce = grid.cell_elem.cpu().numpy().astype(np.int64)
    nx, ny = grid.nx, grid.ny
    n_grid = nx * ny

    K = samples_per_cell
    rng = np.random.default_rng(seed)
    cell = np.repeat(np.arange(n_grid, dtype=np.int64), K)
    u = rng.uniform(size=n_grid * K)
    v = rng.uniform(size=n_grid * K)
    ox, oy = grid.origin
    hx = 1.0 / grid.inv_h[0]
    hy = 1.0 / grid.inv_h[1]
    px = ox + (cell // ny + u) * hx      # cell id = ix*ny + iy
    py = oy + (cell % ny + v) * hy
    found = _host_walk(geom, ce[cell], px, py)
    a, b = _top2_per_cell(cell, found, ce)

    rows = np.concatenate(
        [geom[a][:, 0:6], a[:, None].astype(np.float32),
         geom[b][:, 0:6], b[:, None].astype(np.float32)],
        axis=1).astype(np.float32)
    return LocatorGrid2D(grid.origin, grid.inv_h, grid.cell_elem, nx, ny,
                         torch.as_tensor(rows, device=grid.cell_elem.device))


def build_locator_grid(coords: np.ndarray, elem2verts: np.ndarray,
                       cells_per_elem: float = 16.0,
                       walk_geom=None, aux=None,
                       peel: str = "auto",
                       polar: object = "auto",
                       device="cpu") -> LocatorGrid2D:
    """Host build: bucket element centroids into ~cells_per_elem*E cells and
    flood-fill empty cells from their neighbours; with ``walk_geom``, attach
    the 2-candidate cell rows.

    ``polar``: "auto" and False give cartesian cells (the JAX package's
    polar cells only change walk start elements, never results); True
    raises.  ``peel``: every 2D layout maps onto "rows".  ``aux`` (the
    rotation capture channel) is not ported and raises.
    """
    if peel not in KNOWN_PEELS:
        raise ValueError(f"unknown peel {peel!r}; expected one of "
                         f"{KNOWN_PEELS}")
    if peel not in ROWS_PEELS:
        raise ValueError(f"{peel} is a 3D-only peel; use rows in 2D")
    if polar is True:
        raise NotImplementedError("polar locator cells are not ported; "
                                  "use polar='auto' or False (cartesian)")
    if polar not in ("auto", False):
        raise ValueError(f"polar must be True/False/'auto', got {polar!r}")
    if aux is not None:
        raise NotImplementedError("cell-row aux capture is not ported")
    coords = np.asarray(coords, np.float64)
    ev = np.asarray(elem2verts, np.int64)
    E = ev.shape[0]
    cent = coords[ev].mean(axis=1)

    lo = coords.min(axis=0)
    hi = coords.max(axis=0)
    extent = np.maximum(hi - lo, 1e-30)
    aspect = extent[0] / extent[1]
    n_cells = max(int(E * cells_per_elem), 16)
    nx = max(int(np.sqrt(n_cells * aspect)), 1)
    ny = max(n_cells // max(nx, 1), 1)
    h = extent / np.array([nx, ny])

    ix = np.clip(((cent[:, 0] - lo[0]) / h[0]).astype(np.int64), 0, nx - 1)
    iy = np.clip(((cent[:, 1] - lo[1]) / h[1]).astype(np.int64), 0, ny - 1)
    grid = np.full((nx, ny), -1, np.int64)
    grid[ix, iy] = np.arange(E)  # last write wins; any nearby elem is fine

    # flood-fill empties by repeated 4-neighbour dilation (no wrap-around)
    while (grid < 0).any():
        empty = grid < 0
        for sx, sy in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            shifted = np.roll(grid, (sx, sy), axis=(0, 1))
            if sx == 1:
                shifted[0, :] = -1
            if sx == -1:
                shifted[-1, :] = -1
            if sy == 1:
                shifted[:, 0] = -1
            if sy == -1:
                shifted[:, -1] = -1
            grid = np.where(empty & (grid < 0), shifted, grid)
        if (grid < 0).all():
            raise ValueError("locator grid flood fill failed")

    lo32 = lo.astype(np.float32)
    ih32 = (1.0 / h).astype(np.float32)
    out = LocatorGrid2D(
        origin=(float(lo32[0]), float(lo32[1])),
        inv_h=(float(ih32[0]), float(ih32[1])),
        cell_elem=torch.as_tensor(grid.reshape(-1).astype(np.int32),
                                  dtype=LID_DTYPE, device=device),
        nx=int(nx), ny=int(ny),
    )
    if walk_geom is not None:
        out = attach_cell_rows(out, walk_geom)
    return out


# ---------------------------------------------------------------------------
# structured-annulus proof (host only)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class AnnulusProof:
    """What :func:`detect_annulus_structured` proved: the mesh is a
    structured annulus (possibly rotated and reordered).  The port has no
    analytic locator; the proof only lets the model refuse such meshes
    where the JAX package would locate analytically."""

    n_rings: int
    n_sectors: int
    center: Tuple[float, float]
    r_in: float
    r_out: float
    ring_class: bool
    theta0: float = 0.0
    perm: Optional[np.ndarray] = None    # canonical -> actual element id


def _detect_annulus_permuted(coords, tris, c, rad, n_rings, n_sectors,
                             r_in, r_out, level_tol):
    """Permutation/rotation-tolerant structured-annulus proof: recover the
    (ring × sector) lattice with a global angular offset and the element
    permutation by exact connectivity matching.  Returns (theta0, sigma)
    or None."""
    V = coords.shape[0]
    E = tris.shape[0]
    S, Rg = n_sectors, n_rings
    dth = 2.0 * np.pi / S
    th = np.arctan2(coords[:, 1] - c[1], coords[:, 0] - c[0])
    order = np.argsort(rad)
    lev = np.zeros(V, np.int64)
    lev[order] = np.cumsum(
        np.concatenate([[0], (np.diff(rad[order]) > level_tol)]))
    if lev.max() != Rg:
        return None
    z = np.exp(1j * S * th)
    theta0 = np.angle(z.mean()) / S
    kf = np.mod(np.round((th - theta0) / dth).astype(np.int64), S)
    r_lat = r_in + (r_out - r_in) * lev / Rg
    ang = theta0 + kf * dth
    ideal = np.stack([c[0] + r_lat * np.cos(ang),
                      c[1] + r_lat * np.sin(ang)], axis=1)
    if not np.allclose(ideal, coords, rtol=1e-6, atol=2e-6 * r_out):
        return None
    lat = lev * S + kf
    if len(np.unique(lat)) != V or V != (Rg + 1) * S:
        return None
    pv = np.empty(V, np.int64)
    pv[lat] = np.arange(V)
    rr = np.repeat(np.arange(Rg), S)
    kk = np.tile(np.arange(S), Rg)
    a = pv[rr * S + kk]
    b = pv[rr * S + (kk + 1) % S]
    cc = pv[(rr + 1) * S + kk]
    d = pv[(rr + 1) * S + (kk + 1) % S]
    canon = np.empty((E, 3), np.int64)
    canon[0::2] = np.stack([a, b, d], axis=1)
    canon[1::2] = np.stack([a, d, cc], axis=1)
    cs = np.sort(canon, axis=1)
    ts = np.sort(np.asarray(tris, np.int64), axis=1)
    oc = np.lexsort(cs.T)
    ot = np.lexsort(ts.T)
    if not np.array_equal(cs[oc], ts[ot]):
        return None
    sigma = np.empty(E, np.int64)
    sigma[oc] = ot
    return float(theta0), sigma


def detect_annulus_structured(coords: np.ndarray, tris: np.ndarray,
                              cls: Optional[np.ndarray] = None
                              ) -> Optional[AnnulusProof]:
    """An :class:`AnnulusProof` iff (coords, tris) IS a structured annulus
    mesh (vertices on a full ring × sector lattice, connectivity equal to
    ``annulus_mesh``'s up to rotation and reordering), else None.  Same
    decision as the JAX package's ``detect_annulus_structured``."""
    from pumipic_torch.mesh.generate import annulus_mesh

    coords = np.asarray(coords)
    tris = np.asarray(tris)
    if coords.shape[1] != 2 or tris.shape[1] != 3 or coords.shape[0] < 8:
        return None
    c = coords.mean(axis=0)
    rad = np.hypot(coords[:, 0] - c[0], coords[:, 1] - c[1])
    r_in, r_out = rad.min(), rad.max()
    if r_in <= 0 or r_out <= r_in:
        return None
    order = np.sort(rad)
    gaps = np.diff(order)
    level_tol = max(1e-6 * r_out, 1e-12)
    n_levels = 1 + int((gaps > level_tol).sum())
    if n_levels < 2 or coords.shape[0] % n_levels:
        return None
    n_sectors = coords.shape[0] // n_levels
    n_rings = n_levels - 1
    if n_sectors < 3 or tris.shape[0] != 2 * n_rings * n_sectors:
        return None
    if tris.shape[0] >= F32_EXACT_ID_LIMIT:
        return None
    ref_coords, ref_tris, ref_cls = annulus_mesh(
        n_rings, n_sectors, r_in, r_out, c[0], c[1])
    center = (float(c[0]), float(c[1]))
    identity = (
        ref_coords.shape == coords.shape
        and np.allclose(ref_coords, coords, rtol=1e-6, atol=2e-6 * r_out)
        and np.array_equal(np.sort(ref_tris, axis=1), np.sort(tris, axis=1))
    )
    if identity:
        ring_class = cls is not None and np.array_equal(
            np.asarray(cls).ravel(), ref_cls.ravel())
        return AnnulusProof(n_rings, n_sectors, center, float(r_in),
                            float(r_out), ring_class)
    got = _detect_annulus_permuted(
        coords, tris, c, rad, n_rings, n_sectors, r_in, r_out, level_tol)
    if got is None:
        return None
    theta0, sigma = got
    return AnnulusProof(n_rings, n_sectors, center, float(r_in), float(r_out),
                        False, theta0, sigma)
