"""Adjacency-walk particle search (port of ``pumipic_tpu.ops.search``: the
2D search the FULL-mode step runs and the 3D BCC search of
pseudoPushAndSearch).

Each active particle walks from a start element toward the element that
contains its destination: test containment with the barycentric affine
forms of ``Mesh2D.walk_geom``; if outside, cross the side opposite the most
negative weight.  A walk that crosses an exposed side is handed to the
boundary handler; the only handler ported is :func:`remove_on_exit`, which
deletes the particle.  Walkers still unfinished after the iteration budget
are deleted, as the reference does at its loop limit.

:func:`walk_locate` is the wrapper of kernel L (``kernels/csrc/locate.cu``):
one thread per particle, with the whole walk inside the kernel.  Its plain
version :func:`walk_locate_plain` steps the unfinished walkers as a batch.
The peel takes a cartesian :class:`LocatorGrid2D`, whose cell id kernel L
computes itself, or a flux-band :class:`BandGrid2D`, whose cell ids kernel
B computes first and hands to kernel L ("given cells").

:func:`walk_locate_3d` is the wrapper of kernel L3
(``kernels/csrc/locate3d.cu``), the tet version of L: the 26-column peel of
a :class:`LocatorGrid3D` and the BCC walk over ``Mesh3D.walk_geom``, or the
plain walk; :func:`walk_locate_3d_plain` is its plain version.  Refused
with ``NotImplementedError`` (the next 3D slice): the hybrid and
intersection cores, boundary handlers other than :func:`remove_on_exit`
(``reflect_on_exit_3d``), ``record_exit``, ``recover="project"``,
:func:`check_initial_parents` and :func:`trace_particle_through_mesh`.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple, Union

import torch

from pumipic_torch import kernels
from pumipic_torch.kernels import _build
from pumipic_torch.mesh.core import Mesh2D, Mesh3D
from pumipic_torch.mesh.locator import BandGrid2D, LocatorGrid2D, LocatorGrid3D
from pumipic_torch.ops.locate import band_cell_of, band_cell_of_plain

INVALID = -1
# Containment tolerance, relative to the accumulated |terms| of the affine
# form l = A·x + c (its f32 evaluation error), with a small absolute floor.
BCC_REL_TOL = 8.0 * 2.0 ** -24      # ~8 ulps of the largest term
BCC_ABS_TOL = 1e-7

Grid = Union[LocatorGrid2D, BandGrid2D]


def remove_on_exit(elem: torch.Tensor):
    """The boundary handler: walkers that cross an exposed side leave the
    domain and are deleted (``RemoveParticleOnGeometricModelExit``).
    Returns (element to continue in = INVALID, done = True) per walker, with
    the destination unchanged.  Kernel L applies it inline; other handlers
    are not ported."""
    return torch.full_like(elem, INVALID), torch.ones_like(elem, dtype=torch.bool)


class SearchResult(NamedTuple):
    elem_ids: torch.Tensor                # (N,) i32 parent element; INVALID if removed
    dest_c: Tuple[torch.Tensor, ...]      # per-component (N,) final destination
    iters: torch.Tensor                   # () i32 walk iterations taken
    all_found: torch.Tensor               # () bool: everyone finished in budget
    active: Optional[torch.Tensor] = None  # (N,) bool, elem_ids >= 0

    @property
    def dest(self) -> torch.Tensor:
        """(N, dim) stacked destination."""
        return torch.stack(self.dest_c, dim=-1)


# ---------------------------------------------------------------------------
# plain PyTorch version of kernel L
# ---------------------------------------------------------------------------

def bary_inside(a0, a1, a2, a3, a4, a5, dx, dy):
    """(l1, l2, w0, inside): barycentric weights of (dx, dy) in the affine
    row and the tolerance-relative containment test, in the JAX package's
    f32 expression order (``_row_core_2d``)."""
    l1 = a0 * dx + a1 * dy + a2
    l2 = a3 * dx + a4 * dy + a5
    w0 = 1.0 - l1 - l2
    m1 = (a0 * dx).abs() + (a1 * dy).abs() + a2.abs()
    m2 = (a3 * dx).abs() + (a4 * dy).abs() + a5.abs()
    t1 = BCC_REL_TOL * m1 + BCC_ABS_TOL
    t2 = BCC_REL_TOL * m2 + BCC_ABS_TOL
    inside = (w0 >= -(t1 + t2)) & (l1 >= -t1) & (l2 >= -t2)
    return l1, l2, w0, inside


def _cells_plain(grid: Grid, dx, dy) -> torch.Tensor:
    """The peel's cell id of each destination: the cartesian cell, or the
    flux-band cell by kernel B's plain version."""
    if isinstance(grid, BandGrid2D):
        return band_cell_of_plain(grid, dx, dy)
    return grid.cell_of(dx, dy)


def _peel(grid: Grid, dx, dy):
    """(elem, inside): the cell's two candidate rows tested in order A, B;
    elem = B only when B alone contains the point."""
    g = grid.cell_rows[_cells_plain(grid, dx, dy).long()]   # (N, 14)
    in_a = bary_inside(*g[:, 0:6].unbind(1), dx, dy)[3]
    in_b = bary_inside(*g[:, 7:13].unbind(1), dx, dy)[3]
    inside = in_a | in_b
    elem = torch.where(in_a | ~inside, g[:, 6], g[:, 13]).to(torch.int32)
    return elem, inside


def walk_locate_plain(walk_geom: torch.Tensor, dest_x, dest_y, elem_start,
                      active, max_iters: int, grid: Optional[Grid] = None):
    """Plain PyTorch version of kernel L; returns (elem, active, iters,
    all_found) with the kernel's semantics (see :func:`walk_locate`)."""
    n_elems = walk_geom.shape[0]
    start = torch.clamp(elem_start.to(torch.int32), 0, n_elems - 1)
    elem = torch.where(active, start, INVALID)
    fbg = torch.full_like(elem, -2)
    it0 = 0
    done = ~active
    if grid is not None:
        it0 = 1
        e0, inside = _peel(grid, dest_x, dest_y)
        elem = torch.where(active, e0, INVALID)
        fbg = torch.where(active & ~inside, start, -2)
        done = ~active | inside
    idx = torch.nonzero(~done).flatten()
    steps = 0
    for _ in range(max(max_iters - it0, 0)):
        if idx.numel() == 0:
            break
        steps += 1
        e, f = elem[idx], fbg[idx]
        g = walk_geom[e.long()]                             # (w, 12)
        dx, dy = dest_x[idx], dest_y[idx]
        l1, l2, w0, inside = bary_inside(*g[:, 0:6].unbind(1), dx, dy)
        wmin = torch.minimum(w0, l1)
        kmin = torch.where(w0 <= l1, 0, 1)
        kmin = torch.where(l2 < wmin, 2, kmin)
        nxt = torch.gather(g[:, 6:9], 1, kmin[:, None])[:, 0].to(torch.int32)
        exposed = nxt == INVALID
        retry = ~inside & exposed & (f >= 0)
        hit = ~inside & exposed & (f < 0)
        out_e, out_done = remove_on_exit(e)
        new_e = torch.where(inside, e, torch.where(
            retry, f, torch.where(hit, out_e, nxt)))
        elem[idx] = new_e
        fbg[idx] = torch.where(retry, -2, f)
        fin = inside | (hit & out_done)
        done[idx] = fin
        idx = idx[~fin]
    unfinished = idx.numel()
    if unfinished:
        elem[idx] = INVALID
    dev = elem.device
    return (elem, elem >= 0,
            torch.tensor(it0 + steps, dtype=torch.int32, device=dev),
            torch.tensor(unfinished == 0, device=dev))


# ---------------------------------------------------------------------------
# kernel L wrapper
# ---------------------------------------------------------------------------

def walk_locate(walk_geom: torch.Tensor, dest_x, dest_y, elem_start, active,
                max_iters: int, grid: Optional[Grid] = None):
    """Locate every active particle's destination; returns (elem, active,
    iters, all_found).

    With ``grid`` (cell rows attached): the peel tests the destination
    cell's two candidates (iteration 1; a :class:`BandGrid2D`'s cells come
    from kernel B); misses walk from candidate A on a
    guess trajectory that, on hitting the boundary, retries once from the
    clamped ``elem_start``.  Without ``grid``: the plain walk from the
    clamped ``elem_start``.  Walkers left after ``max_iters`` iterations are
    deleted; ``iters`` is the iteration count of a batch walk that stops when
    no walker is left, and ``all_found`` says no walker was deleted at the
    limit.  Inactive particles get INVALID.

    Kernel L on CUDA tensors, :func:`walk_locate_plain` on CPU tensors."""
    tensors = [walk_geom, dest_x, dest_y, elem_start, active]
    if grid is not None:
        if grid.cell_rows is None:
            raise ValueError("walk_locate: the locator grid has no cell rows")
        tensors.append(grid.cell_rows)
    if not kernels.use_kernel("locate", *tensors):
        return walk_locate_plain(walk_geom, dest_x, dest_y, elem_start, active,
                                 max_iters, grid)
    n = dest_x.shape[0]
    if (dest_x.dtype != torch.float32 or dest_y.dtype != torch.float32
            or walk_geom.dtype != torch.float32
            or elem_start.dtype != torch.int32 or active.dtype != torch.bool):
        raise ValueError("walk_locate: f32 dest/walk_geom, i32 elem_start "
                         "and bool active expected")
    if walk_geom.data_ptr() % 16 or (grid is not None
                                     and grid.cell_rows.data_ptr() % 8):
        raise ValueError("walk_locate: walk_geom must be 16-byte and "
                         "cell_rows 8-byte aligned")
    dev = dest_x.device
    elem = torch.empty(n, dtype=torch.int32, device=dev)
    act = torch.empty(n, dtype=torch.bool, device=dev)
    stats = torch.zeros(2, dtype=torch.int32, device=dev)
    it0 = 0 if grid is None else 1
    P = ctypes.c_void_p
    rows = cells = None
    ox, oy, ihx, ihy, nx, ny = 0.0, 0.0, 0.0, 0.0, 1, 1
    if isinstance(grid, BandGrid2D):
        cells = band_cell_of(grid, dest_x, dest_y)          # kernel B
        rows = grid.cell_rows.data_ptr()
    elif grid is not None:
        rows = grid.cell_rows.data_ptr()
        (ox, oy), (ihx, ihy), nx, ny = grid.origin, grid.inv_h, grid.nx, grid.ny
    err = _build.lib().pp_walk_locate(
        P(dest_x.data_ptr()), P(dest_y.data_ptr()), P(elem_start.data_ptr()),
        P(active.data_ptr()), P(walk_geom.data_ptr()), walk_geom.shape[0],
        P(rows), P(None if cells is None else cells.data_ptr()),
        ox, oy, ihx, ihy, nx, ny, max_iters, it0,
        P(elem.data_ptr()), P(act.data_ptr()), P(stats.data_ptr()), n,
        P(kernels.stream_handle()))
    _build.check(err, "locate")
    kernels.LAUNCHES["locate"] += 1
    return elem, act, stats[0] + it0, stats[1] == 0


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def _components(x):
    if isinstance(x, tuple):
        return x
    return tuple(x[:, i].contiguous() for i in range(x.shape[1]))


def _check_options(boundary_handler, record_exit, recover, aux_capture=None):
    if boundary_handler is not remove_on_exit:
        raise NotImplementedError("only remove_on_exit is ported")
    if record_exit:
        raise NotImplementedError("record_exit is not ported")
    if recover != "off":
        raise NotImplementedError("recover='project' is not ported")
    if aux_capture is not None:
        raise NotImplementedError("aux_capture is not ported")


def search_mesh_2d(mesh: Mesh2D, x_orig, x_tgt, elem_init: torch.Tensor,
                   active: torch.Tensor, max_iters: int = 200,
                   boundary_handler=remove_on_exit, record_exit: bool = False,
                   widths=None, recover: str = "off") -> SearchResult:
    """Walk every active particle from ``elem_init`` (clamped into range) to
    the element containing ``x_tgt``.  Inactive particles get INVALID.
    ``widths`` (the TPU compaction pyramid) is accepted and ignored: the
    kernel keeps finished walkers idle instead of compacting."""
    _check_options(boundary_handler, record_exit, recover)
    dx, dy = _components(x_tgt)
    elem, act, iters, all_found = walk_locate(
        mesh.walk_geom, dx, dy, elem_init.to(torch.int32), active, max_iters)
    return SearchResult(elem, (dx, dy), iters, all_found, act)


def search_mesh_2d_accel(mesh: Mesh2D, grid: Grid, x_orig, x_tgt,
                         elem_prev: torch.Tensor, active: torch.Tensor,
                         max_iters: int = 200,
                         boundary_handler=remove_on_exit,
                         record_exit: bool = False, widths=None,
                         aux_capture=None, recover: str = "off") -> SearchResult:
    """Grid-accelerated search through the cell-row peel ("rows" layout of
    a cartesian or flux-band grid; the other layouts are not ported):
    results equal :func:`search_mesh_2d`'s, with the peel counted as one
    iteration."""
    _check_options(boundary_handler, record_exit, recover, aux_capture)
    if grid.cell_rows is None:
        raise NotImplementedError("only the cell-rows peel is ported")
    dx, dy = _components(x_tgt)
    elem, act, iters, all_found = walk_locate(
        mesh.walk_geom, dx, dy, elem_prev.to(torch.int32), active, max_iters,
        grid=grid)
    return SearchResult(elem, (dx, dy), iters, all_found, act)


# ---------------------------------------------------------------------------
# tets: plain PyTorch version of kernel L3
# ---------------------------------------------------------------------------

def bary_inside_3d(a, dx, dy, dz):
    """(l1, l2, l3, w0, inside): barycentric weights of (dx, dy, dz) in the
    affine rows ``a`` (12 (N,) tensors) and the tolerance-relative
    containment test, summed left to right as ``_core_3d_bcc`` does."""
    l1 = a[0] * dx + a[1] * dy + a[2] * dz + a[3]
    l2 = a[4] * dx + a[5] * dy + a[6] * dz + a[7]
    l3 = a[8] * dx + a[9] * dy + a[10] * dz + a[11]
    w0 = 1.0 - l1 - l2 - l3
    m1 = (a[0] * dx).abs() + (a[1] * dy).abs() + (a[2] * dz).abs() + a[3].abs()
    m2 = (a[4] * dx).abs() + (a[5] * dy).abs() + (a[6] * dz).abs() + a[7].abs()
    m3 = (a[8] * dx).abs() + (a[9] * dy).abs() + (a[10] * dz).abs() + a[11].abs()
    t1 = BCC_REL_TOL * m1 + BCC_ABS_TOL
    t2 = BCC_REL_TOL * m2 + BCC_ABS_TOL
    t3 = BCC_REL_TOL * m3 + BCC_ABS_TOL
    inside = (w0 >= -(t1 + t2 + t3)) & (l1 >= -t1) & (l2 >= -t2) & (l3 >= -t3)
    return l1, l2, l3, w0, inside


def _peel_3d(grid: LocatorGrid3D, dx, dy, dz):
    """(elem, inside): the cell's two candidate rows tested in order A, B;
    elem = B only when B alone contains the point."""
    g = grid.cell_rows[grid.cell_of(dx, dy, dz).long()]          # (N, 26)
    in_a = bary_inside_3d(g[:, 0:12].unbind(1), dx, dy, dz)[4]
    in_b = bary_inside_3d(g[:, 13:25].unbind(1), dx, dy, dz)[4]
    inside = in_a | in_b
    elem = torch.where(in_a | ~inside, g[:, 12], g[:, 25]).to(torch.int32)
    return elem, inside


def walk_locate_3d_plain(walk_geom: torch.Tensor, dest: torch.Tensor,
                         elem_start, active, max_iters: int,
                         grid: Optional[LocatorGrid3D] = None):
    """Plain PyTorch version of kernel L3 (a batch walk over the unfinished
    walkers); returns (elem, active, iters, all_found, num_unfinished) with
    the kernel's semantics (see :func:`walk_locate_3d`)."""
    n_elems = walk_geom.shape[0]
    dx, dy, dz = dest.unbind(1)
    start = torch.clamp(elem_start.to(torch.int32), 0, n_elems - 1)
    elem = torch.where(active, start, INVALID)
    fbg = torch.full_like(elem, -2)
    it0 = 0
    done = ~active
    if grid is not None:
        it0 = 1
        e0, inside = _peel_3d(grid, dx, dy, dz)
        elem = torch.where(active, e0, INVALID)
        fbg = torch.where(active & ~inside, start, -2)
        done = ~active | inside
    idx = torch.nonzero(~done).flatten()
    steps = 0
    for _ in range(max(max_iters - it0, 0)):
        if idx.numel() == 0:
            break
        steps += 1
        e, f = elem[idx], fbg[idx]
        g = walk_geom[e.long()]                                  # (w, 16)
        l1, l2, l3, w0, inside = bary_inside_3d(
            g[:, 0:12].unbind(1), dx[idx], dy[idx], dz[idx])
        wmin = w0
        kmin = torch.zeros_like(e, dtype=torch.int64)
        for k, lk in ((1, l1), (2, l2), (3, l3)):
            take = lk < wmin
            wmin = torch.where(take, lk, wmin)
            kmin = torch.where(take, k, kmin)
        nxt = torch.gather(g[:, 12:16], 1, kmin[:, None])[:, 0].to(torch.int32)
        exposed = nxt == INVALID
        retry = ~inside & exposed & (f >= 0)
        hit = ~inside & exposed & (f < 0)
        out_e, out_done = remove_on_exit(e)
        elem[idx] = torch.where(inside, e, torch.where(
            retry, f, torch.where(hit, out_e, nxt)))
        fbg[idx] = torch.where(retry, -2, f)
        fin = inside | (hit & out_done)
        idx = idx[~fin]
    unfinished = idx.numel()
    if unfinished:
        elem[idx] = INVALID
    dev = elem.device
    return (elem, elem >= 0,
            torch.tensor(it0 + steps, dtype=torch.int32, device=dev),
            torch.tensor(unfinished == 0, device=dev),
            torch.tensor(unfinished, dtype=torch.int32, device=dev))


# ---------------------------------------------------------------------------
# kernel L3 wrapper
# ---------------------------------------------------------------------------

def walk_locate_3d(walk_geom: torch.Tensor, dest: torch.Tensor, elem_start,
                   active, max_iters: int, grid: Optional[LocatorGrid3D] = None):
    """Locate every active particle's (N, 3) destination in a tet mesh;
    returns (elem, active, iters, all_found, num_unfinished).

    With ``grid`` (cell rows attached): the peel tests the destination
    cell's two candidates (iteration 1); misses walk from candidate A on a
    guess trajectory that, on hitting the boundary, retries once from the
    clamped ``elem_start``.  Without ``grid``: the plain walk from the
    clamped ``elem_start``.  Walkers left after ``max_iters`` iterations are
    deleted (``num_unfinished`` counts them, ``all_found`` says there were
    none); ``iters`` is the iteration count of a batch walk that stops when
    no walker is left.  Inactive particles get INVALID.

    Kernel L3 on CUDA tensors (which reads the grid's checked candidate id
    pair, :meth:`LocatorGrid3D.candidate_ids`, and ``walk_geom`` in place of
    the rows), :func:`walk_locate_3d_plain` on CPU tensors."""
    if grid is not None and grid.cell_rows is None:
        raise ValueError("walk_locate_3d: the locator grid has no cell rows")
    if not kernels.use_kernel("locate3d", walk_geom, dest, elem_start, active):
        return walk_locate_3d_plain(walk_geom, dest, elem_start, active,
                                    max_iters, grid)
    n = dest.shape[0]
    E = walk_geom.shape[0]
    if (dest.dtype != torch.float32 or dest.shape != (n, 3)
            or walk_geom.dtype != torch.float32 or walk_geom.shape != (E, 16)
            or elem_start.dtype != torch.int32 or active.dtype != torch.bool):
        raise ValueError("walk_locate_3d: (N, 3) f32 dest, (E, 16) f32 "
                         "walk_geom, i32 elem_start and bool active expected")
    ids = None
    if grid is not None:
        ids = grid.candidate_ids(walk_geom)
        kernels.use_kernel("locate3d", walk_geom, ids)
    if walk_geom.data_ptr() % 16:
        raise ValueError("walk_locate_3d: walk_geom must be 16-byte aligned")
    if n >= 1 << 30:
        raise ValueError("walk_locate_3d: the kernel takes fewer than 2^30 particles")
    dev = dest.device
    elem = torch.empty(n, dtype=torch.int32, device=dev)
    act = torch.empty(n, dtype=torch.bool, device=dev)
    stats = torch.zeros(2, dtype=torch.int32, device=dev)
    it0 = 0 if grid is None else 1
    oh = (ctypes.c_float * 6)(*((0.0,) * 6 if grid is None
                                else (*grid.origin, *grid.inv_h)))
    nxyz = (1, 1, 1) if grid is None else (grid.nx, grid.ny, grid.nz)
    P = ctypes.c_void_p
    err = _build.lib().pp_walk_locate_3d(
        P(dest.data_ptr()), P(elem_start.data_ptr()), P(active.data_ptr()),
        P(walk_geom.data_ptr()), E,
        P(None if ids is None else ids.data_ptr()), oh, *nxyz,
        max_iters, it0, P(elem.data_ptr()), P(act.data_ptr()),
        P(stats.data_ptr()), n, P(kernels.stream_handle()))
    _build.check(err, "locate3d")
    kernels.LAUNCHES["locate3d"] += 1
    return elem, act, stats[0] + it0, stats[1] == 0, stats[1]


# ---------------------------------------------------------------------------
# public API, tets
# ---------------------------------------------------------------------------

def _check_method(method: str) -> None:
    """The BCC core is ported; the JAX package's other cores are refused
    (an unknown name is its BCC default)."""
    if method in ("hybrid", "intersection"):
        raise NotImplementedError(f"the {method!r} 3D walk core is not ported "
                                  f"(the BCC core is)")


def _dest3(x_tgt) -> torch.Tensor:
    """(N, 3) contiguous f32 destinations from an array or a tuple of
    components."""
    if isinstance(x_tgt, tuple):
        return torch.stack(x_tgt, dim=1)
    return x_tgt.contiguous()


def search_mesh_3d(mesh: Mesh3D, x_orig, x_tgt, elem_init: torch.Tensor,
                   active: torch.Tensor, max_iters: int = 200,
                   boundary_handler=remove_on_exit, method: str = "bcc",
                   record_exit: bool = False, widths=None,
                   recover: str = "off") -> SearchResult:
    """Tet-mesh BCC walk of every active particle from ``elem_init``
    (clamped into range) to the tet containing ``x_tgt`` (kernel L3's plain
    walk): greedy descent across the face opposite the most negative vertex
    weight; a walker crossing an exposed face is deleted; walkers left at
    the iteration limit are deleted.  Inactive particles get INVALID.
    ``widths`` (the TPU compaction pyramid) is accepted and ignored."""
    _check_options(boundary_handler, record_exit, recover)
    _check_method(method)
    dest = _dest3(x_tgt)
    elem, act, iters, all_found, _ = walk_locate_3d(
        mesh.walk_geom, dest, elem_init.to(torch.int32), active, max_iters)
    return SearchResult(elem, dest.unbind(1), iters, all_found, act)


def search_mesh_3d_accel(mesh: Mesh3D, grid: LocatorGrid3D, x_orig, x_tgt,
                         elem_prev: torch.Tensor, active: torch.Tensor,
                         max_iters: int = 200,
                         boundary_handler=remove_on_exit, method: str = "bcc",
                         record_exit: bool = False, widths=None,
                         recover: str = "off") -> SearchResult:
    """Grid-accelerated tet search through the cell-candidate peel (kernel
    L3, which reads the grid's checked candidate id pair; its plain version
    the 26-column rows): results equal :func:`search_mesh_3d`'s, with the peel counted as
    one iteration and a guess walk that retries once from the clamped
    ``elem_prev`` where it meets the boundary."""
    _check_options(boundary_handler, record_exit, recover)
    _check_method(method)
    if grid.cell_rows is None:
        raise NotImplementedError("only the cell-rows peel is ported")
    dest = _dest3(x_tgt)
    elem, act, iters, all_found, _ = walk_locate_3d(
        mesh.walk_geom, dest, elem_prev.to(torch.int32), active, max_iters,
        grid=grid)
    return SearchResult(elem, dest.unbind(1), iters, all_found, act)


def check_initial_parents(*args, **kwargs):
    """Not ported yet (the next 3D slice): raises."""
    raise NotImplementedError("check_initial_parents is not ported")


def trace_particle_through_mesh(*args, **kwargs):
    """Not ported yet (the next 3D slice): raises."""
    raise NotImplementedError("trace_particle_through_mesh is not ported")
