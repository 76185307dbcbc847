"""Adjacency-walk particle search (port of the 2D parts of
``pumipic_tpu.ops.search`` that the FULL-mode step runs).

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
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple, Union

import torch

from pumipic_torch import kernels
from pumipic_torch.kernels import _build
from pumipic_torch.mesh.core import Mesh2D
from pumipic_torch.mesh.locator import BandGrid2D, LocatorGrid2D
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
