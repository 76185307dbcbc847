"""Point-location accelerators (port of ``pumipic_tpu.mesh.locator``).

A background grid maps each cell to a nearby element; the search starts
its walk from the grid's guess of the DESTINATION.  Each cell also carries
two sample-calibrated candidate rows, ``cell_rows`` (n_cells, 14) f32:

    [A affine (6) | elemA | B affine (6) | elemB]

so the first containment test of most particles is one 56-byte row load
(the peel in :func:`pumipic_torch.ops.search.search_mesh_2d_accel`).  The
guess is only an accelerator: the walk still proves containment.

- :class:`LocatorGrid2D`: cartesian cells (the "rows" layout).
- :class:`BandGrid2D`: cells keyed by (flux band, θ-bin) on a stitched
  flux-band mesh, built by :func:`detect_banded_locator`; the cell id is
  kernel B.
- :class:`AnnulusLocator2D`: exact analytic location on a proven
  structured annulus (:func:`detect_annulus_structured`), kernel A; no
  table and no walk.
- :class:`LocatorGrid3D`: the tet mesh's cartesian cells, with 26-column
  rows [A affine (12) | elemA | B affine (12) | elemB] (the plain version's
  peel) and their checked (n_cells, 2) id pair [elemA | elemB], through
  which kernel L3 reads the same affine values from ``walk_geom``.
- :class:`KuhnLocator3D`: exact analytic location on a proven structured
  Kuhn box (:func:`detect_box_kuhn`), kernel K.

The JAX package's other layouts change which element a walk starts from,
never its result: ``polar="auto"`` resolves to cartesian cells here
(``polar=True`` raises), and the peel variants "lines", "rows_split" and
"rows_ab" (and, on tets, also "rows_abc", "ids" and "ids4") map onto
"rows".
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from functools import cached_property
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from pumipic_torch.mesh.core import F32_EXACT_ID_LIMIT
from pumipic_torch.utils.device import resolve_device
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


def _device_walk(geom: torch.Tensor, e0: torch.Tensor, px: torch.Tensor,
                 py: torch.Tensor, iters: int = 24) -> torch.Tensor:
    """:func:`_host_walk` as torch ops on the tensors' device: the same
    gathers, the same f64 products and sums in the same order (f32 rows
    widened exactly, one op a kernel, so nothing is fused into an FMA) and
    the same ``-1e-6`` test, so its (N,) int64 ids equal the host walk's
    bit for bit.  ``geom`` is the (E, 12) f32 walk table, ``px``/``py``
    f64."""
    e = e0.to(torch.int64).clone()
    done = e < 0
    rows = geom[:, :9]

    def weights(g):
        l1 = g[:, 0] * px + g[:, 1] * py + g[:, 2]
        l2 = g[:, 3] * px + g[:, 4] * py + g[:, 5]
        return l1, l2, 1.0 - l1 - l2

    for _ in range(iters):
        g = rows[e.clamp(min=0)]
        l1, l2, w0 = weights(g)
        done_new = done | (torch.minimum(torch.minimum(l1, l2), w0) >= -1e-6)
        kmin = torch.where(w0 <= l1, 0, 1)
        kmin = torch.where(l2 < torch.minimum(w0, l1), 2, kmin)
        nxt = torch.gather(g[:, 6:9], 1, kmin[:, None])[:, 0].to(torch.int64)
        e = torch.where(done_new, e, nxt)
        done = done_new | (e < 0)
        if bool(done.all()):
            break
    l1, l2, w0 = weights(rows[e.clamp(min=0)])
    ok = (e >= 0) & (torch.minimum(torch.minimum(l1, l2), w0) >= -1e-6)
    return torch.where(ok, e, -1)


def attach_cell_rows(grid: LocatorGrid2D, walk_geom,
                     samples_per_cell: int = 8,
                     seed: int = 1729) -> LocatorGrid2D:
    """Return a copy of ``grid`` whose cells carry TWO candidate walk rows.

    Candidates are calibrated by stratified random samples per cell located
    exactly: A = the element covering the most samples, B = the second (B =
    A when one element covers the whole cell).  Same seed and draws as the
    JAX package, so the table is bit-equal.  On a CUDA grid the samples
    are walked on the card (:func:`_device_walk`), on the CPU by numpy
    (:func:`_host_walk`); the draws and the candidates' choice stay on the
    host either way.
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
    dev = grid.cell_elem.device
    if dev.type == "cuda":
        def put(a):
            return torch.as_tensor(a, device=dev)
        found = _device_walk(put(geom), put(ce[cell]), put(px), put(py)).cpu().numpy()
    else:
        found = _host_walk(geom, ce[cell], px, py)
    a, b = _top2_per_cell(cell, found, ce)

    rows = np.concatenate(
        [geom[a][:, 0:6], a[:, None].astype(np.float32),
         geom[b][:, 0:6], b[:, None].astype(np.float32)],
        axis=1).astype(np.float32)
    return LocatorGrid2D(grid.origin, grid.inv_h, grid.cell_elem, nx, ny,
                         torch.as_tensor(rows, device=grid.cell_elem.device))


def _flood_fill(grid: torch.Tensor) -> torch.Tensor:
    """Fill the empty (-1) cells of an (nx, ny) int64 grid by repeated
    4-neighbour dilation without wrap-around, as the JAX package does: each
    round takes the shifts +x, -x, +y, -y in turn, each filling the cells
    empty at the round's start and still empty from the grid as it then
    stands.  Torch ops on the grid's device (a round a few launches on the
    card, where numpy's rounds took most of the 1M mesh's grid build)."""
    while bool((grid < 0).any()):
        empty = grid < 0
        for sx, sy in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            shifted = torch.roll(grid, (sx, sy), dims=(0, 1))
            if sx == 1:
                shifted[0, :] = -1
            if sx == -1:
                shifted[-1, :] = -1
            if sy == 1:
                shifted[:, 0] = -1
            if sy == -1:
                shifted[:, -1] = -1
            grid = torch.where(empty & (grid < 0), shifted, grid)
        if bool((grid < 0).all()):
            raise ValueError("locator grid flood fill failed")
    return grid


def build_locator_grid(coords: np.ndarray, elem2verts: np.ndarray,
                       cells_per_elem: float = 16.0,
                       walk_geom=None, aux=None,
                       peel: str = "auto",
                       polar: object = "auto",
                       device=None) -> LocatorGrid2D:
    """Bucket element centroids into ~cells_per_elem*E cells on the host and
    flood-fill empty cells from their neighbours on ``device``
    (:func:`_flood_fill`); with ``walk_geom``, attach the 2-candidate cell
    rows (:func:`attach_cell_rows`: on a CUDA device calibrated by the
    device walk).

    ``polar``: "auto" and False give cartesian cells (the JAX package's
    polar cells only change walk start elements, never results); True
    raises.  ``peel``: every 2D layout maps onto "rows".  ``aux`` (the
    rotation capture channel) is not ported and raises.
    """
    device = resolve_device(device)
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
    cells = _flood_fill(torch.as_tensor(grid, device=device))

    lo32 = lo.astype(np.float32)
    ih32 = (1.0 / h).astype(np.float32)
    out = LocatorGrid2D(
        origin=(float(lo32[0]), float(lo32[1])),
        inv_h=(float(ih32[0]), float(ih32[1])),
        cell_elem=cells.reshape(-1).to(LID_DTYPE),
        nx=int(nx), ny=int(ny),
    )
    if walk_geom is not None:
        out = attach_cell_rows(out, walk_geom)
    return out


# ---------------------------------------------------------------------------
# structured-annulus analytic locator
# ---------------------------------------------------------------------------

def _f32(v) -> float:
    """``v`` rounded to float32, as a Python float."""
    return float(np.float32(v))


@dataclass(frozen=True)
class AnnulusLocator2D:
    """Analytic point location on a proven structured annulus (port of the
    JAX package's ``AnnulusLocator2D``): the sector is an ``atan2`` floor,
    the ring a floor of the projection on the wedge bisector, the triangle
    one cross-product sign against the quad diagonal.  No table, no walk.

    ``cx``, ``cy``, ``r_in``, ``dr`` and ``theta0`` are exact f32 values (the
    JAX package stores them as f32 scalars).  ``perm`` maps canonical to
    actual element ids for imported (reordered) annuli, None for the
    generator's order.  Locating is kernel A (:mod:`pumipic_torch.ops.locate`).
    """

    cx: float
    cy: float
    r_in: float
    dr: float
    n_rings: int
    n_sectors: int
    ring_class: bool = False
    theta0: float = 0.0
    perm: Optional[torch.Tensor] = None   # (E,) i32 canonical -> actual id

    @cached_property
    def _memo(self) -> dict:
        """What :meth:`scalars` (by ``eps``) and :meth:`sector_table` (by
        device) computed, kept for the locator's later calls."""
        return {}

    def scalars(self, eps: float = 1e-6) -> Dict[str, float]:
        """The per-mesh f32 scalars of ``locate_parts``, computed with f32
        torch ops in the JAX package's order at the first call for ``eps``
        and kept: 2π, the sector angle ``dth``, ``m = cos(dth/2)``, and the
        inside bounds ``r_in - tol``, ``r_out + tol`` with ``tol =
        eps·r_out``.  Kernel A and its plain version both read these
        values."""
        key = ("scalars", eps)
        if key not in self._memo:
            f = lambda v: torch.tensor(v, dtype=torch.float32)   # noqa: E731
            two_pi = f(2.0 * np.pi)
            dth = two_pi / self.n_sectors
            m = torch.cos(0.5 * dth)
            r_out = f(self.r_in) + f(self.dr) * self.n_rings
            tol = eps * r_out
            self._memo[key] = {"two_pi": float(two_pi), "dth": float(dth),
                               "m": float(m), "lo": float(f(self.r_in) - tol),
                               "hi": float(r_out + tol)}
        return dict(self._memo[key])

    def sector_table(self, device) -> torch.Tensor:
        """(n_sectors, 6) f32 on ``device``: cos and sin of each sector's
        bisector ``θ0 + (k + 0.5)·dth`` and of its two rays ``θa = θ0 +
        k·dth`` and ``θa + dth``, by the expressions of kernel A's plain
        version at ``kf = k`` with the same f32 torch ops on ``device``, so
        row k equals that version's per-point values there bit for bit.
        Kernel A reads it in place of six libm calls per point; built at
        the first call for a device and kept."""
        device = torch.device(device)
        key = ("sector_table", device)
        if key not in self._memo:
            dth = self.scalars()["dth"]
            kf = torch.arange(self.n_sectors, dtype=torch.float32, device=device)
            phi = self.theta0 + (kf + 0.5) * dth
            tha = self.theta0 + kf * dth
            thd = tha + dth
            self._memo[key] = torch.stack(
                [torch.cos(phi), torch.sin(phi), torch.cos(tha), torch.sin(tha),
                 torch.cos(thd), torch.sin(thd)], dim=1).contiguous()
        return self._memo[key]

    def class_of(self, elem: torch.Tensor) -> torch.Tensor:
        """Classification from the element id on a ``ring_class``-proven
        mesh: ring + 1 = elem // (2·n_sectors) + 1."""
        if not self.ring_class or self.perm is not None:
            raise ValueError("class_of needs a ring_class-proven mesh in "
                             "the generator's element order")
        return elem // (2 * self.n_sectors) + 1

    def locate(self, px: torch.Tensor, py: torch.Tensor):
        """Points -> (elem, inside): the containing triangle (INVALID outside
        the chord-exact annulus).  Kernel A on CUDA tensors."""
        from pumipic_torch.ops.locate import annulus_locate

        active = torch.ones(px.shape, dtype=torch.bool, device=px.device)
        return annulus_locate(self, px, py, active)

    def locate_parts(self, px: torch.Tensor, py: torch.Tensor):
        """(elem, inside, rf, kf, trif): :meth:`locate` plus the f32 ring,
        sector and triangle indices, computed by kernel A's plain version."""
        from pumipic_torch.ops.locate import annulus_locate_parts_plain

        return annulus_locate_parts_plain(self, px, py)


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
                              cls: Optional[np.ndarray] = None,
                              device=None) -> Optional[AnnulusLocator2D]:
    """An :class:`AnnulusLocator2D` iff (coords, tris) IS a structured
    annulus mesh (vertices on a full ring × sector lattice, connectivity
    equal to ``annulus_mesh``'s up to rotation and reordering), else None.
    With ``cls`` equal to ``annulus_mesh``'s per-ring classification (and
    the generator's order) the locator is ``ring_class``-proven.  Same
    decision and values as the JAX package's ``detect_annulus_structured``."""
    from pumipic_torch.mesh.generate import annulus_mesh

    device = resolve_device(device)
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
    base = dict(cx=_f32(c[0]), cy=_f32(c[1]), r_in=_f32(r_in),
                dr=_f32((r_out - r_in) / n_rings), n_rings=n_rings,
                n_sectors=n_sectors)
    identity = (
        ref_coords.shape == coords.shape
        and np.allclose(ref_coords, coords, rtol=1e-6, atol=2e-6 * r_out)
        and np.array_equal(np.sort(ref_tris, axis=1), np.sort(tris, axis=1))
    )
    if identity:
        ring_class = cls is not None and np.array_equal(
            np.asarray(cls).ravel(), ref_cls.ravel())
        return AnnulusLocator2D(**base, ring_class=ring_class)
    got = _detect_annulus_permuted(
        coords, tris, c, rad, n_rings, n_sectors, r_in, r_out, level_tol)
    if got is None:
        return None
    theta0, sigma = got
    _check_ids_f32_exact(tris)
    return AnnulusLocator2D(**base, theta0=_f32(theta0),
                            perm=torch.as_tensor(sigma.astype(np.int32),
                                                 device=device))


# ---------------------------------------------------------------------------
# flux-band locator grid
# ---------------------------------------------------------------------------

# element ids ride the f32 cell-row columns: exact only below 2^24
_F32_EXACT_ID_LIMIT = F32_EXACT_ID_LIMIT

# byte budget for the band rows table, the JAX package's table-sizing rule
BAND_ROWS_BYTES_BUDGET = 10.8e6

# The JAX package's row-gather cost model at 10M indices, MEASURED ON ITS
# TPU (perf/gather_cost_surface.py).  It is no GPU cost model: the port
# keeps it only as the reference's rule for sizing n_theta (so that the
# band table has the JAX package's shape) and for ``cost_gate_ms``'s API.
_GATHER_SMALL_BYTES = 12e6
_GATHER_SMALL_BASE_MS = 29.8
_GATHER_SMALL_PER_COL_MS = 6.78
_GATHER_LARGE_BASE_MS = 68.0
_GATHER_LARGE_PER_MB_MS = 0.665
_GATHER_LARGE_PER_COL_MS = 0.47
_BAND_EVAL_MS = 7.2
_CART_CELL_MS = 2.5


def predict_rowgather_ms(n_rows: int, stored_cols: int,
                         consumed_cols: int) -> float:
    """The JAX package's TPU-measured prediction for one 10M-index row
    gather (see the constants above); a table-sizing rule here, not a
    prediction of any GPU time."""
    mb = n_rows * stored_cols * 4 / 1e6
    if mb * 1e6 <= _GATHER_SMALL_BYTES:
        return (_GATHER_SMALL_BASE_MS
                + _GATHER_SMALL_PER_COL_MS * max(consumed_cols - 2, 0))
    return (_GATHER_LARGE_BASE_MS
            + _GATHER_LARGE_PER_MB_MS * max(mb - 27.4, 0.0)
            + _GATHER_LARGE_PER_COL_MS * max(consumed_cols - 2, 0))


@dataclass(frozen=True)
class BandGrid2D:
    """Flux-band locator cells (port of the JAX package's ``BandGrid2D``):
    cells keyed by (flux band, θ-bin) instead of cartesian squares, with
    the same two calibrated candidate rows per cell as
    :class:`LocatorGrid2D`.

    A cell id comes from a fitted forward model R(b, θ) of the band
    surfaces: θ-harmonics by recurrence from (x/r, y/r) projected onto
    ``rank`` SVD modes (``coef_v``), per-particle Chebyshev coefficients
    (``coef_u``), a polynomial seed (``inv_coef``) refined by
    ``newton_iters`` Newton/Clenshaw steps into the band coordinate b*, and
    the diamond angle τ ∈ [0, 4) binned into ``n_theta`` bins.  The cell
    id is kernel B (:func:`pumipic_torch.ops.locate.band_cell_of`).

    ``cx``/``cy`` are exact f32 values; the coefficient tensors are f32, as
    the JAX package stores them."""

    cx: float
    cy: float
    coef_u: torch.Tensor          # (P+1, rank) f32
    coef_v: torch.Tensor          # (rank, 2J+1) f32
    inv_coef: torch.Tensor        # (deg+1,) f32, ascending powers of r
    cell_rows: torch.Tensor       # (K·T, 14) f32 [A affine 6 | idA | B ... | idB]
    cell_elem: torch.Tensor       # (K·T,) i32 candidate A
    n_bands: int = 1              # K
    n_theta: int = 1              # T
    n_harm: int = 8               # J
    n_cheb: int = 8               # P
    rank: int = 5
    newton_iters: int = 3

    def cell_of(self, px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
        """Points -> (N,) i32 cell ids (kernel B on CUDA tensors)."""
        from pumipic_torch.ops.locate import band_cell_of

        return band_cell_of(self, px, py)

    @cached_property
    def launch_params(self) -> np.ndarray:
        """Kernel B's launch parameters, packed on the host at the first
        launch (:func:`pumipic_torch.ops.locate.band_params`)."""
        from pumipic_torch.ops.locate import band_params

        return band_params(self)


def _ring_vertices_from_bands(tris: np.ndarray, cls: np.ndarray,
                              nverts: int) -> Optional[np.ndarray]:
    """Ring index per vertex from a band-ordered classification: a vertex
    incident to bands {j, j+1} lies on ring j (rings 0..K); single-band
    vertices are the domain's boundary rings.  None if the mesh is not a
    stitched band structure."""
    mn = np.full(nverts, 1 << 30, np.int64)
    mx = np.full(nverts, -1, np.int64)
    for k in range(3):
        np.minimum.at(mn, tris[:, k], cls)
        np.maximum.at(mx, tris[:, k], cls)
    if (mx < 0).any():
        return None
    K = int(cls.max())
    if (mx - mn > 1).any():
        return None
    solo = mn == mx
    if not np.all((mn[solo] == 1) | (mn[solo] == K)):
        return None
    return np.where(mn < mx, mn, np.where(mn == 1, 0, K)).astype(np.int64)


def detect_banded_locator(
    coords: np.ndarray,
    tris: np.ndarray,
    cls: Optional[np.ndarray],
    walk_geom,
    n_theta: Optional[int] = None,
    n_harm: int = 24,
    n_cheb: int = 12,
    samples_per_cell: int = 16,
    seed: int = 1729,
    resid_gate: float = 0.25,
    cost_gate_ms: Optional[float] = None,
    chunk: Optional[int] = 1 << 20,
    device=None,
) -> Optional[BandGrid2D]:
    """Build a :class:`BandGrid2D` iff the mesh is a stitched flux-band
    structure: band-ordered classification, star-shaped ring polygons, and
    a forward radius model (per-ring Fourier fit, Chebyshev smoothing
    across rings, SVD rank truncation) whose residual stays under
    ``resid_gate`` × the local ring spacing.  None otherwise.

    Same defaults, decisions and tables as the JAX package's
    ``detect_banded_locator`` (``cell_rows``/``cell_elem`` bit-equal).  The
    calibration evaluates its sample points' cells ``chunk`` points at a
    time (None: all at once); rows are independent, so the result does not
    depend on ``chunk``, and the host memory stays bounded (the 120k mesh
    has 7.8M samples)."""
    device = resolve_device(device)
    coords = np.asarray(coords, np.float64)
    tris = np.asarray(tris, np.int64)
    if cls is None or coords.shape[1] != 2 or tris.shape[1] != 3:
        return None
    cls = np.asarray(cls).ravel()
    if cls.size != tris.shape[0] or not np.issubdtype(cls.dtype, np.integer):
        return None
    if cls.min() != 1 or np.any(np.diff(cls) < 0):
        return None
    K = int(cls.max())
    if K < 4:
        return None
    ring = _ring_vertices_from_bands(tris, cls, coords.shape[0])
    if ring is None:
        return None
    geom = (walk_geom.cpu().numpy() if isinstance(walk_geom, torch.Tensor)
            else np.asarray(walk_geom))
    _check_ids_f32_exact(geom)
    E = tris.shape[0]

    center = coords.mean(axis=0)
    dx = coords[:, 0] - center[0]
    dy = coords[:, 1] - center[1]
    r_v = np.hypot(dx, dy)
    th_v = np.arctan2(dy, dx)
    if r_v.min() <= 1e-12 * r_v.max():
        return None

    ring_counts = np.bincount(ring, minlength=K + 1)
    J = max(min(n_harm, (int(ring_counts.min()) - 4) // 2), 4)
    P = min(n_cheb, K - 1)
    if J < 4 or P < 2:
        return None

    def ang_feats(th):
        n = len(th)
        A = np.empty((n, 2 * J + 1))
        A[:, 0] = 1.0
        c1, s1 = np.cos(th), np.sin(th)
        cj, sj = c1.copy(), s1.copy()
        A[:, 1], A[:, 1 + J] = cj, sj
        for j in range(1, J):
            cj, sj = cj * c1 - sj * s1, sj * c1 + cj * s1
            A[:, 1 + j], A[:, 1 + J + j] = cj, sj
        return A

    # stage 1: per-ring Fourier fits of the ring polygons' polar radius
    C = np.zeros((K + 1, 2 * J + 1))
    for b in range(K + 1):
        sel = ring == b
        nb = int(sel.sum())
        if nb < 2 * J + 4:
            return None
        order = np.argsort(th_v[sel])
        xs = dx[sel][order]
        ys = dy[sel][order]
        crs = xs * np.roll(ys, -1) - ys * np.roll(xs, -1)
        if not (np.all(crs > 0) or np.all(crs < 0)):
            return None                  # not star-shaped about the center
        A = ang_feats(th_v[sel])
        G = A.T @ A
        G[np.diag_indices_from(G)] += 1e-12 * max(np.trace(G), 1.0)
        C[b] = np.linalg.solve(G, A.T @ r_v[sel])

    # stage 2: Chebyshev smoothing across rings
    u = 2.0 * np.arange(K + 1) / K - 1.0
    Tb = np.polynomial.chebyshev.chebvander(u, P)
    G = Tb.T @ Tb
    G[np.diag_indices_from(G)] += 1e-12 * np.trace(G)
    coef = np.linalg.solve(G, Tb.T @ C)              # (P+1, 2J+1)

    th_grid = np.linspace(-np.pi, np.pi, 256, endpoint=False)
    Ag = ang_feats(th_grid)
    prof_full = Tb @ coef @ Ag.T
    gaps_full = np.diff(prof_full, axis=0)
    if gaps_full.min() <= 0:
        return None                                  # non-nested fit
    # smallest SVD rank whose profile error is well under the ring gap
    Uc, sv, Vt = np.linalg.svd(coef, full_matrices=False)
    rank = len(sv)
    for rr_ in range(2, len(sv) + 1):
        cr = (Uc[:, :rr_] * sv[:rr_]) @ Vt[:rr_]
        if np.abs(Tb @ cr @ Ag.T - prof_full).max() <= 0.1 * gaps_full.min():
            rank = rr_
            break
    rank = min(rank, 8)
    coef = (Uc[:, :rank] * sv[:rank]) @ Vt[:rank]

    # residual gate on the truncated model, relative to the local spacing
    Rfit = Tb @ coef
    eval_err = 0.0
    prof = Rfit @ Ag.T
    gaps = np.diff(prof, axis=0)
    if gaps.min() <= 0:
        return None
    for b in range(K + 1):
        sel = ring == b
        pred = ang_feats(th_v[sel]) @ (Tb[b] @ coef)
        err = np.abs(pred - r_v[sel])
        gi = np.clip(((th_v[sel] + np.pi) / (2 * np.pi) * 256).astype(int),
                     0, 255)
        local_gap = gaps[np.clip(b, 0, K - 1), gi]
        eval_err = max(eval_err, float((err / local_gap).max()))
    if eval_err > resid_gate:
        return None

    if n_theta is None:
        # the JAX package's T sizing: a hit-driven resolution capped by
        # the byte budget, or the smallest table past 27.5 MB, whichever
        # its TPU cost model prices lower (ties: more cells)
        per_band = np.bincount(cls - 1, minlength=K)
        want = 1 << int(np.ceil(np.log2(max(per_band.max(), 8))))
        cap_small = max(
            int(BAND_ROWS_BYTES_BUDGET / (14 * 4 * K)) // 256 * 256, 256)
        cands = {min(want, cap_small)}
        t_large = int(-(-27.5e6 // (14 * 4 * K * 256))) * 256
        if t_large <= 4 * want and K * t_large < _F32_EXACT_ID_LIMIT:
            cands.add(t_large)
        n_theta = min(
            sorted(cands, reverse=True),
            key=lambda t: predict_rowgather_ms(K * t, 14, 14))
    T = int(n_theta)
    if K * T >= _F32_EXACT_ID_LIMIT:
        raise ValueError(
            f"n_theta={T} gives K*T={K * T} >= 2^24: band cell ids are "
            f"computed in f32 and would round; use a smaller n_theta")

    if cost_gate_ms is not None:
        band_ms = _BAND_EVAL_MS + predict_rowgather_ms(K * T, 14, 14)
        if band_ms >= cost_gate_ms:
            return None

    # scalar Newton seed: ascending-power inverse of the angular-mean profile
    rmean = prof.mean(axis=1)
    inv_deg = min(10, K - 1)
    inv_coef = np.polynomial.polynomial.polyfit(rmean, u, inv_deg)

    # calibration through the composite assignment (f64 host mirror of the
    # cell id: same seed polynomial and Newton steps)
    def band_of(pts):
        dxq = pts[:, 0] - center[0]
        dyq = pts[:, 1] - center[1]
        rq = np.hypot(dxq, dyq)
        tq = np.arctan2(dyq, dxq)
        tau = np.where(
            dxq >= 0,
            np.where(dyq >= 0,
                     dyq / np.maximum(np.abs(dxq) + np.abs(dyq), 1e-30),
                     4.0 + dyq / np.maximum(np.abs(dxq) + np.abs(dyq),
                                            1e-30)),
            2.0 - dyq / np.maximum(np.abs(dxq) + np.abs(dyq), 1e-30))
        q = ang_feats(tq) @ coef.T                   # (n, P+1)

        def radius_and_slope(uv):
            bk1 = np.zeros_like(uv)
            bk2 = np.zeros_like(uv)
            dk1 = np.zeros_like(uv)
            dk2 = np.zeros_like(uv)
            for p in range(P, 0, -1):
                dk1, dk2 = 2.0 * bk1 + 2.0 * uv * dk1 - dk2, dk1
                bk1, bk2 = q[:, p] + 2.0 * uv * bk1 - bk2, bk1
            return q[:, 0] + uv * bk1 - bk2, bk1 + uv * dk1 - dk2

        uv = np.full(len(rq), inv_coef[-1])
        for p in range(len(inv_coef) - 2, -1, -1):
            uv = uv * rq + inv_coef[p]
        uv = np.clip(uv, -1.05, 1.05)
        for _ in range(3):
            val, dv = radius_and_slope(uv)
            uv = np.clip(uv - (val - rq) / np.maximum(dv, 1e-6), -1.05, 1.05)
        bst = (uv + 1.0) * (K / 2.0)
        return np.clip(np.floor(bst), 0, K - 1).astype(np.int64), tau

    def cell_of_h(pts):
        b, tau = band_of(pts)
        tb = np.clip((tau / 4.0 * T).astype(np.int64), 0, T - 1)
        return b * T + tb

    n_cells = K * T
    rng = np.random.default_rng(seed)
    cal_per_elem = max(int(samples_per_cell * n_cells / E), 8)
    te = np.repeat(np.arange(E, dtype=np.int64), cal_per_elem)
    w = rng.dirichlet((1.0, 1.0, 1.0), len(te))
    step = len(te) if chunk is None else max(int(chunk), 1)
    cell = np.empty(len(te), np.int64)
    for s in range(0, len(te), step):
        sl = slice(s, s + step)
        pts = (coords[tris[te[sl]]] * w[sl, :, None]).sum(axis=1)
        cell[sl] = cell_of_h(pts)

    cent = coords[tris].mean(axis=1)
    fb = np.zeros(n_cells, np.int64)
    fb[cell_of_h(cent)] = np.arange(E)
    a, b = _top2_per_cell(cell, te, fb)
    rows = np.concatenate(
        [geom[a][:, 0:6], a[:, None].astype(np.float64),
         geom[b][:, 0:6], b[:, None].astype(np.float64)],
        axis=1).astype(np.float32)

    def dev32(v):
        return torch.as_tensor(np.asarray(v, np.float32), device=device)

    return BandGrid2D(
        cx=_f32(center[0]), cy=_f32(center[1]),
        coef_u=dev32(Uc[:, :rank] * sv[:rank]),
        coef_v=dev32(Vt[:rank]),
        inv_coef=dev32(inv_coef),
        cell_rows=torch.as_tensor(rows, device=device),
        cell_elem=torch.as_tensor(a.astype(np.int32), device=device),
        n_bands=K, n_theta=T, n_harm=J, n_cheb=P, rank=rank,
    )


# ---------------------------------------------------------------------------
# tet meshes: the locator grid and the structured Kuhn box
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class LocatorGrid3D:
    """Cartesian locator grid of a tet mesh, cell id (ix·ny + iy)·nz + iz.
    ``origin``/``inv_h`` are host floats that are exact f32 values (the JAX
    package stores them as f32 arrays).  ``cell_rows`` (n_cells, 26) f32:

        [A affine (12) | elemA | B affine (12) | elemB]

    the two sample-calibrated candidates of each cell (the "rows" layout,
    onto which every other peel of the JAX package maps).  Kernel L3 reads
    their id columns (:meth:`candidate_ids`) and ``walk_geom`` in place of
    the 104-byte rows."""

    origin: Tuple[float, float, float]
    inv_h: Tuple[float, float, float]
    cell_elem: torch.Tensor               # (nx*ny*nz,) i32 nearest element
    nx: int
    ny: int
    nz: int
    cell_rows: Optional[torch.Tensor] = None   # (nx*ny*nz, 26) f32
    # the pair candidate_ids last checked, with the tensors it was checked
    # against; a grid from dataclasses.replace starts without one
    _checked: dict = field(default_factory=dict, init=False, repr=False,
                           compare=False)

    def cell_of(self, px: torch.Tensor, py: torch.Tensor,
                pz: torch.Tensor) -> torch.Tensor:
        """Points -> (N,) clamped cell ids in the JAX package's f32 index
        arithmetic (exact below 2^24 cells); the final integer clamp only
        guards non-finite points."""
        o, ih = self.origin, self.inv_h
        ix = torch.clamp(torch.floor((px - o[0]) * ih[0]), 0.0, self.nx - 1.0)
        iy = torch.clamp(torch.floor((py - o[1]) * ih[1]), 0.0, self.ny - 1.0)
        iz = torch.clamp(torch.floor((pz - o[2]) * ih[2]), 0.0, self.nz - 1.0)
        c = ((ix * float(self.ny) + iy) * float(self.nz) + iz).to(torch.int32)
        return torch.clamp(c, 0, self.nx * self.ny * self.nz - 1)

    def candidate_ids(self, walk_geom: torch.Tensor) -> torch.Tensor:
        """``cell_rows``' id columns 12 and 25 as an (n_cells, 2) i32 pair
        [elemA | elemB], which kernel L3 reads in place of the rows.  Raises
        ValueError unless each id is in range and ``walk_geom``'s row at it
        equals the row's affine columns bit for bit, so that the kernel
        tests what the plain version tests on the rows.  The pair is kept
        for the ``cell_rows`` and ``walk_geom`` tensors it was checked
        against; another tensor, or either written in place since, is
        checked again."""
        rows = self.cell_rows
        seen = self._checked.get("against")
        if (seen is not None and seen[0] is rows and seen[1] is walk_geom
                and seen[2:] == (rows._version, walk_geom._version)):
            return self._checked["ids"]
        if rows is None or rows.shape != (self.nx * self.ny * self.nz, 26):
            raise ValueError("candidate_ids: the grid needs (n_cells, 26) cell_rows")
        geom = walk_geom.to(rows.device)
        ids = torch.stack([rows[:, 12], rows[:, 25]], 1).to(torch.int32)
        ok = bool((ids >= 0).all()) and bool((ids < geom.shape[0]).all()) \
            and torch.equal(ids.to(rows.dtype), rows[:, [12, 25]])
        if ok:
            g = geom[ids.long()][..., 0:12].contiguous()           # (n_cells, 2, 12)
            aff = torch.stack([rows[:, 0:12], rows[:, 13:25]], 1).contiguous()
            ok = torch.equal(g.view(torch.int32), aff.view(torch.int32))
        if not ok:
            raise ValueError("candidate_ids: cell_rows' candidates do not equal "
                             "walk_geom's rows at their ids bit for bit")
        self._checked.update(
            against=(rows, walk_geom, rows._version, walk_geom._version),
            ids=ids.contiguous())
        return self._checked["ids"]


def _host_walk_3d(geom: np.ndarray, e0: np.ndarray, px, py, pz,
                  iters: int = 24) -> np.ndarray:
    """Vectorized host-side 3D BCC walk (build-time only): locate (px, py,
    pz) from e0; -1 where the walk exits the domain or does not settle."""
    e = np.asarray(e0, np.int64).copy()
    done = e < 0

    def bary(g):
        l1 = g[:, 0] * px + g[:, 1] * py + g[:, 2] * pz + g[:, 3]
        l2 = g[:, 4] * px + g[:, 5] * py + g[:, 6] * pz + g[:, 7]
        l3 = g[:, 8] * px + g[:, 9] * py + g[:, 10] * pz + g[:, 11]
        return l1, l2, l3, 1.0 - l1 - l2 - l3

    for _ in range(iters):
        g = geom[np.maximum(e, 0)]
        l1, l2, l3, w0 = bary(g)
        inside = np.minimum(np.minimum(l1, l2), np.minimum(l3, w0)) >= -1e-6
        done_new = done | inside
        wmin = w0.copy()
        kmin = np.zeros(len(e), np.int64)
        for k, lk in ((1, l1), (2, l2), (3, l3)):
            take = lk < wmin
            wmin = np.where(take, lk, wmin)
            kmin = np.where(take, k, kmin)
        nxt = np.take_along_axis(
            g[:, 12:16], kmin[:, None], axis=1)[:, 0].astype(np.int64)
        e = np.where(done_new, e, nxt)
        done = done_new | (~done_new & (e < 0))
        if done.all():
            break
    g = geom[np.maximum(e, 0)]
    l1, l2, l3, w0 = bary(g)
    ok = (e >= 0) & (np.minimum(np.minimum(l1, l2), np.minimum(l3, w0)) >= -1e-6)
    return np.where(ok, e, -1)


def attach_cell_rows_3d(grid: LocatorGrid3D, walk_geom,
                        samples_per_cell: int = 8,
                        seed: int = 1729) -> LocatorGrid3D:
    """A copy of ``grid`` whose cells carry TWO candidate walk rows [A affine
    (12) | elemA | B affine (12) | elemB]: the elements covering the most
    and second-most of ``samples_per_cell`` stratified random samples per
    cell, located on the host.  Same seed and draws as the JAX package's
    ``attach_cell_rows_3d``, so the table is bit-equal to its default
    layout."""
    geom = (walk_geom.cpu().numpy() if isinstance(walk_geom, torch.Tensor)
            else np.asarray(walk_geom))
    _check_ids_f32_exact(geom)
    ce = grid.cell_elem.cpu().numpy().astype(np.int64)
    nx, ny, nz = grid.nx, grid.ny, grid.nz
    n_grid = nx * ny * nz
    o = np.asarray(grid.origin, np.float64)
    h = 1.0 / np.asarray(grid.inv_h, np.float64)

    K = samples_per_cell
    rng = np.random.default_rng(seed)
    cell = np.repeat(np.arange(n_grid, dtype=np.int64), K)
    u = rng.uniform(size=(n_grid * K, 3))
    iz = cell % nz
    iy = (cell // nz) % ny
    ix = cell // (ny * nz)
    px = o[0] + (ix + u[:, 0]) * h[0]
    py = o[1] + (iy + u[:, 1]) * h[1]
    pz = o[2] + (iz + u[:, 2]) * h[2]
    found = _host_walk_3d(geom, ce[cell], px, py, pz)
    a, b = _top2_per_cell(cell, found, ce)
    rows = np.concatenate(
        [geom[a][:, 0:12], a[:, None].astype(np.float32),
         geom[b][:, 0:12], b[:, None].astype(np.float32)],
        axis=1).astype(np.float32)
    return dataclasses.replace(
        grid, cell_rows=torch.as_tensor(rows, device=grid.cell_elem.device))


def build_locator_grid_3d(coords: np.ndarray, elem2verts: np.ndarray,
                          cells_per_elem: float = 2.0,
                          walk_geom=None,
                          peel: str = "auto",
                          device=None) -> LocatorGrid3D:
    """Host build of a tet mesh's locator grid: bucket element centroids
    into ~cells_per_elem·E cells (cell counts per axis in proportion to the
    box) and flood-fill empty cells from their 6 neighbours; with
    ``walk_geom``, attach the 2-candidate cell rows.  Every peel of the JAX
    package ("auto" and its choice of "lines" above 32 MB, "lines",
    "rows_split", "rows_ab", "rows_abc", "ids", "ids4") maps onto "rows":
    they change which element a walk starts from, never its result."""
    device = resolve_device(device)
    if peel not in KNOWN_PEELS:
        raise ValueError(f"unknown peel {peel!r}; expected one of "
                         f"{KNOWN_PEELS}")
    coords = np.asarray(coords, np.float64)
    ev = np.asarray(elem2verts, np.int64)
    E = ev.shape[0]
    cent = coords[ev].mean(axis=1)

    lo = coords.min(axis=0)
    hi = coords.max(axis=0)
    extent = np.maximum(hi - lo, 1e-30)
    n_cells = max(int(E * cells_per_elem), 64)
    scale = (n_cells / np.prod(extent)) ** (1.0 / 3.0)
    nx, ny, nz = (max(int(e * scale), 1) for e in extent)
    h = extent / np.array([nx, ny, nz])

    ijk = np.clip(((cent - lo) / h).astype(np.int64),
                  0, np.array([nx - 1, ny - 1, nz - 1]))
    grid = np.full((nx, ny, nz), -1, np.int64)
    grid[ijk[:, 0], ijk[:, 1], ijk[:, 2]] = np.arange(E)

    while (grid < 0).any():
        empty = grid < 0
        filled_any = False
        for ax in (0, 1, 2):
            for s in (1, -1):
                shifted = np.roll(grid, s, axis=ax)
                idx = [slice(None)] * 3
                idx[ax] = 0 if s == 1 else -1
                shifted[tuple(idx)] = -1
                newfill = empty & (grid < 0) & (shifted >= 0)
                grid = np.where(empty & (grid < 0), shifted, grid)
                filled_any = filled_any or bool(newfill.any())
        if not filled_any:
            raise ValueError("3d locator grid flood fill failed")

    lo32 = lo.astype(np.float32)
    ih32 = (1.0 / h).astype(np.float32)
    out = LocatorGrid3D(
        origin=tuple(float(v) for v in lo32),
        inv_h=tuple(float(v) for v in ih32),
        cell_elem=torch.as_tensor(grid.reshape(-1).astype(np.int32),
                                  dtype=LID_DTYPE, device=device),
        nx=int(nx), ny=int(ny), nz=int(nz),
    )
    if walk_geom is not None:
        out = attach_cell_rows_3d(out, walk_geom)
    return out


@dataclass(frozen=True)
class KuhnLocator3D:
    """Analytic point location on a proven structured Kuhn box (6 tets per
    hex cell along vertex-permutation paths, ``box_tet_mesh``'s layout):
    the cell from a floor, the tet from the descending order of the
    fractional coordinates, element id = cell·6 + path.  No table, no walk;
    exact up to f32 ties on shared faces.  Points outside the box get
    INVALID (on the convex box, destination outside ⟺ the path exits).

    ``origin``/``inv_h`` are exact f32 values; ``perm`` maps canonical to
    actual element ids for an imported (reordered) box, None for the
    generator's order.  Locating is kernel K
    (:func:`pumipic_torch.ops.locate.kuhn_push_locate`)."""

    origin: Tuple[float, float, float]
    inv_h: Tuple[float, float, float]
    nx: int = 1
    ny: int = 1
    nz: int = 1
    perm: Optional[torch.Tensor] = None   # (E,) i32 canonical -> actual id

    def locate(self, px: torch.Tensor, py: torch.Tensor, pz: torch.Tensor):
        """Points -> (elem, inside): the containing tet, INVALID outside the
        box.  Kernel K on CUDA tensors."""
        from pumipic_torch.ops.locate import kuhn_push_locate

        x = torch.stack([px, py, pz], dim=1)
        active = torch.ones(px.shape, dtype=torch.bool, device=px.device)
        _, elem = kuhn_push_locate(self, x, active)
        return elem, elem >= 0


def detect_box_kuhn(coords: np.ndarray, tets: np.ndarray,
                    device=None) -> Optional[KuhnLocator3D]:
    """A :class:`KuhnLocator3D` iff (coords, tets) IS a structured Kuhn box
    mesh: vertices on a full uniform rectilinear lattice and connectivity
    equal to ``box_tet_mesh``'s for the reconstructed (nx, ny, nz), in the
    generator's order or, through a recovered permutation, in any other
    (an imported box).  Same decision and values as the JAX package's
    ``detect_box_kuhn``."""
    from pumipic_torch.mesh.generate import box_tet_mesh

    device = resolve_device(device)
    coords = np.asarray(coords)
    tets = np.asarray(tets)
    if coords.shape[1] != 3 or tets.shape[1] != 4:
        return None
    xs = np.unique(coords[:, 0])
    ys = np.unique(coords[:, 1])
    zs = np.unique(coords[:, 2])
    nx, ny, nz = len(xs) - 1, len(ys) - 1, len(zs) - 1
    if min(nx, ny, nz) < 1:
        return None
    if coords.shape[0] != (nx + 1) * (ny + 1) * (nz + 1):
        return None
    if tets.shape[0] != 6 * nx * ny * nz or tets.shape[0] >= F32_EXACT_ID_LIMIT:
        return None
    # uniform lattice spacing per axis (the floor division assumes it)
    if not all(np.allclose(np.diff(a), np.diff(a).mean(),
                           rtol=1e-6, atol=1e-12) and np.diff(a).mean() > 0
               for a in (xs, ys, zs)):
        return None
    h = np.array([xs[-1] - xs[0], ys[-1] - ys[0], zs[-1] - zs[0]])
    h = h / np.array([nx, ny, nz])
    base = dict(origin=tuple(_f32(v) for v in (xs[0], ys[0], zs[0])),
                inv_h=tuple(_f32(v) for v in 1.0 / h), nx=nx, ny=ny, nz=nz)
    ref_coords, ref_tets = box_tet_mesh(
        nx, ny, nz, xs[-1] - xs[0], ys[-1] - ys[0], zs[-1] - zs[0])
    if (np.allclose(ref_coords + np.array([xs[0], ys[0], zs[0]]), coords,
                    rtol=1e-6, atol=1e-12)
            # a tet as a point set is its vertex set (Mesh3D.from_arrays
            # may swap two vertices to fix the orientation)
            and np.array_equal(np.sort(ref_tets, axis=1), np.sort(tets, axis=1))):
        return KuhnLocator3D(**base)
    # an imported ordering: recover the vertex lattice from the snapped
    # coordinates and match every tet to a canonical path simplex as a set
    corner = np.array([xs[0], ys[0], zs[0]])
    ijk = np.round((coords - corner) / h).astype(np.int64)
    if not np.allclose(corner + ijk * h, coords, rtol=1e-6, atol=1e-12):
        return None
    lat = (ijk[:, 0] * (ny + 1) + ijk[:, 1]) * (nz + 1) + ijk[:, 2]
    if (ijk.min() < 0 or (ijk.max(axis=0) != [nx, ny, nz]).any()
            or len(np.unique(lat)) != coords.shape[0]):
        return None
    pv = np.empty(coords.shape[0], np.int64)
    pv[lat] = np.arange(coords.shape[0])
    cs = np.sort(pv[ref_tets], axis=1)             # canonical tets, actual ids
    ts = np.sort(tets, axis=1)
    oc = np.lexsort(cs.T)
    ot = np.lexsort(ts.T)
    if not np.array_equal(cs[oc], ts[ot]):
        return None
    sigma = np.empty(tets.shape[0], np.int64)
    sigma[oc] = ot                                 # canonical id -> actual id
    return KuhnLocator3D(**base, perm=torch.as_tensor(sigma.astype(np.int32),
                                                      device=device))
