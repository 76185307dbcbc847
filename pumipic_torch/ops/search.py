"""Adjacency-walk particle search (port of ``pumipic_tpu.ops.search``: the
2D search the FULL-mode step runs and the 3D searches of pseudoPushAndSearch
and the GITR-style app).

Each active particle walks from a start element toward the element that
contains its destination: test containment with the barycentric affine
forms of ``Mesh2D.walk_geom`` / ``Mesh3D.walk_geom``; if outside, cross the
side opposite the most negative weight.  A walk that crosses an exposed
side is handed to the boundary handler (the JAX package's protocol:
``handler(BoundaryCtx) -> BoundaryResult``): :func:`remove_on_exit`
deletes the particle, :func:`reflect_on_exit_3d` mirrors its destination
across the face and walks on from the crossing point.  Walkers still
unfinished after the iteration budget are deleted, as the reference does at
its loop limit.

:func:`walk_locate` is the wrapper of kernel L (``kernels/csrc/locate.cu``):
one thread per particle, with the whole walk inside the kernel.  Its plain
version :func:`walk_locate_plain` steps the unfinished walkers as a batch.
Where few slots walk and nothing is written for the rest, L's sparse plain
walk runs instead: :func:`walk_locate_into` (in place, the parent repair)
and :func:`walk_locate_count` (the counts alone, the picparts lost check).
:func:`check_initial_parents` is kernel J (``kernels/csrc/parents.cu``,
:func:`check_parents`) and the repair walk in place (L's sparse plain walk
in 2D, L3's, :func:`walk_locate_3d_into`, in 3D); :func:`check_parents_plain`
is its plain version.
The peel takes a cartesian :class:`LocatorGrid2D`, whose cell id kernel L
computes itself, or a flux-band :class:`BandGrid2D`, whose cell ids kernel
B computes first and hands to kernel L ("given cells").  Every other 2D
case (:func:`reflect_on_exit_2d`, ``record_exit``, ``recover="project"``)
runs kernel M2 (``kernels/csrc/trace2d.cu``) through :func:`trace_2d`, from
the plain start or either peel; :func:`trace_2d_plain` is its plain version
and runs any handler of the protocol on the CPU.

Tets: :func:`walk_locate_3d` is the wrapper of kernel L3
(``kernels/csrc/locate3d.cu``), the tet version of L for the fast case (the
BCC core, :func:`remove_on_exit`, no exit record, no recovery), and
:func:`walk_locate_3d_plain` its plain version.  :func:`trace_3d` is the
wrapper of kernel M (``kernels/csrc/trace3d.cu``) for every other case: the
BCC, hybrid and intersection (Möller–Trumbore) cores, remove or reflect,
``record_exit`` (exit face, hit count, crossing point) and
``recover="project"``, from the plain start or the locator peel;
:func:`trace_3d_plain` is its plain version and runs any handler of the
protocol on the CPU.  The TPU build recovers loop-limit survivors only on
its deepest compaction level (``search.py:860-887``); the port recovers
every survivor (see ROADMAP queue 3).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple, Union

import torch

from pumipic_torch import kernels
from pumipic_torch.kernels import _build
from pumipic_torch.mesh.core import Mesh2D, Mesh3D
from pumipic_torch.mesh.locator import BandGrid2D, LocatorGrid2D, LocatorGrid3D
from pumipic_torch.ops.geometry import closest_point_on_triangle, sqrt_rn
from pumipic_torch.ops.locate import band_cell_of, band_cell_of_plain
from pumipic_torch.ops.rows import row_gather_plain

INVALID = -1
# Containment tolerance, relative to the accumulated |terms| of the affine
# form l = A·x + c (its f32 evaluation error), with a small absolute floor.
BCC_REL_TOL = 8.0 * 2.0 ** -24      # ~8 ulps of the largest term
BCC_ABS_TOL = 1e-7
# the intersection core's plane slack, scaled by |plane offset|
MT_TOL = 1e-6
# recover="project": a loop-limit survivor is accepted on its current tet
# when its destination lies within this fraction of the tet's longest edge
# of the tet's closure, and the projected point moves this fraction toward
# the centroid so that later containment tests strictly hold
RECOVER_REL_TOL = 1e-3
RECOVER_NUDGE = 1e-5

Grid = Union[LocatorGrid2D, BandGrid2D]


class BoundaryCtx(NamedTuple):
    """What a boundary handler sees for the walkers of a step."""

    elem: torch.Tensor                    # (w,) element the walker is leaving
    side: Optional[torch.Tensor]          # (w,) mesh face crossed
    orig: Optional[Tuple[torch.Tensor, ...]]  # per-component (w,) segment origin
    dest: Optional[Tuple[torch.Tensor, ...]]  # per-component (w,) destination
    mesh: object
    # the crossing point and its segment parameter (``find_exit_face``); None
    # unless the handler needs them or the search records exits
    hit: Optional[Tuple[torch.Tensor, ...]] = None
    t: Optional[torch.Tensor] = None


class BoundaryResult(NamedTuple):
    dest: Optional[Tuple[torch.Tensor, ...]]  # None: destination unchanged
    elem: torch.Tensor                    # element to continue in (INVALID: removed)
    done: torch.Tensor                    # True: the walker stops


def remove_on_exit(ctx: BoundaryCtx) -> BoundaryResult:
    """The default handler: a walker that crosses an exposed side leaves the
    domain and is deleted (``RemoveParticleOnGeometricModelExit``); its
    destination is unchanged.  Kernels L, L3 and M apply it inline."""
    return BoundaryResult(None, torch.full_like(ctx.elem, INVALID),
                          torch.ones_like(ctx.elem, dtype=torch.bool))


remove_on_exit.modifies_dest = False


def reflect_on_exit_2d(ctx: BoundaryCtx) -> BoundaryResult:
    """Specular reflection off the exposed edge: the destination is mirrored
    across the edge's line and the walker goes on from its element (the
    walk restarts the segment at the crossing point).  Kernel M2 applies it
    inline through :func:`reflect_tangents`, in this order of f32
    operations (the edge's length a correctly rounded sqrt)."""
    m = ctx.mesh
    tx, ty, ax, ay = _edge_frames(m, m.edge2verts[torch.clamp(ctx.side, min=0).long()])
    dx, dy = ctx.dest
    adx, ady = dx - ax, dy - ay
    along = adx * tx + ady * ty
    return BoundaryResult((ax + 2 * along * tx - adx, ay + 2 * along * ty - ady),
                          ctx.elem, torch.zeros_like(ctx.elem, dtype=torch.bool))


reflect_on_exit_2d.modifies_dest = True


def _edge_frames(mesh: Mesh2D, ev: torch.Tensor):
    """(t_x, t_y, a_x, a_y) of the edges ``ev`` ((k, 2) vertex ids): the
    unit tangent from the first vertex a, the reference's f32 operations in
    its order (the length a correctly rounded sqrt)."""
    ev = ev.long()
    ax, ay = mesh.coords[ev[:, 0]].unbind(1)
    bx, by = mesh.coords[ev[:, 1]].unbind(1)
    tx, ty = bx - ax, by - ay
    inv = 1.0 / torch.clamp(sqrt_rn(tx * tx + ty * ty), min=1e-30)
    return tx * inv, ty * inv, ax, ay


def _cached(mesh, key: str, sources, build):
    """``build()``, kept on the mesh for the tensors ``sources`` it reads
    (another tensor, or one written in place since, builds it again)."""
    seen = mesh._derived.get(key)
    if (seen is not None and len(seen[0]) == len(sources)
            and all(a is b for a, b in zip(seen[0], sources))
            and seen[1] == tuple(t._version for t in sources)):
        return seen[2]
    table = build()
    mesh._derived[key] = (tuple(sources), tuple(t._version for t in sources), table)
    return table


def reflect_tangents(mesh: Mesh2D) -> torch.Tensor:
    """(n_edges, 4) f32, each edge's unit tangent [t_x t_y] and first vertex
    [a_x a_y]: what kernel M2's reflect handler reads in place of
    ``edge2verts`` and ``coords``.  Formed with :func:`reflect_on_exit_2d`'s
    f32 operations in its order, so a mirror through a row equals that
    handler's bit for bit.  Kept on the mesh for the ``edge2verts`` and
    ``coords`` tensors it was built from (another tensor, or either
    written in place since, builds it again)."""
    return _cached(mesh, "tangents", (mesh.edge2verts, mesh.coords),
                   lambda: torch.stack(_edge_frames(mesh, mesh.edge2verts), 1).contiguous())


def parent_rows(mesh: Mesh2D) -> torch.Tensor:
    """(E, 8) f32, each triangle's affine rows ``walk_geom[:, 0:6]`` bit for
    bit and two zero pads: what kernel J's 2D test reads, one 32-byte
    sector a row (a 48-byte ``walk_geom`` row puts every odd row's first 24
    bytes across two).  Measured (PERF.md §6): J on these rows is as fast
    as on ``walk_geom`` at the seeding's order and after one 2D path call,
    and 23% faster at the order five path calls leave and in the path; why
    the sectors bind at that order only is open.  Kept on the mesh for its
    ``walk_geom`` tensor (another tensor, or one written in place since,
    builds it again)."""
    return _cached(mesh, "parent_rows", (mesh.walk_geom,),
                   lambda: torch.nn.functional.pad(mesh.walk_geom[:, 0:6], (0, 2)))


def reflect_on_exit_3d(ctx: BoundaryCtx) -> BoundaryResult:
    """Specular reflection off the exposed face (the GITR-style wall): the
    destination is mirrored across the face's plane and the walker goes on
    from its element (the walk restarts the segment at the crossing point).
    Kernel M applies it inline, in this order of f32 operations (the
    normal's length a correctly rounded sqrt)."""
    m = ctx.mesh
    fv = m.face2verts[torch.clamp(ctx.side, min=0).long()].long()
    a, b, c = (m.coords[fv[:, j]] for j in range(3))
    ax, ay, az = a.unbind(1)
    ux, uy, uz = (b - a).unbind(1)
    vx, vy, vz = (c - a).unbind(1)
    nx = uy * vz - uz * vy
    ny = uz * vx - ux * vz
    nz = ux * vy - uy * vx
    inv = 1.0 / torch.clamp(sqrt_rn(nx * nx + ny * ny + nz * nz), min=1e-30)
    nx, ny, nz = nx * inv, ny * inv, nz * inv
    dx, dy, dz = ctx.dest
    s = (dx - ax) * nx + (dy - ay) * ny + (dz - az) * nz
    return BoundaryResult((dx - 2 * s * nx, dy - 2 * s * ny, dz - 2 * s * nz),
                          ctx.elem, torch.zeros_like(ctx.elem, dtype=torch.bool))


reflect_on_exit_3d.modifies_dest = True


def reflect_normals(mesh: Mesh3D) -> torch.Tensor:
    """(n_faces, 8) f32, each face's unit normal [n_x n_y n_z 0] and its
    first vertex [a_x a_y a_z 0]: what kernel M's reflect handler reads in
    place of ``face2verts`` and ``coords``.  Formed with
    :func:`reflect_on_exit_3d`'s f32 operations in its order, so a mirror
    through a row equals that handler's bit for bit.  Kept on the mesh for
    the ``face2verts`` and ``coords`` tensors it was built from; another
    tensor, or either written in place since, builds it again."""
    def build():
        fv = mesh.face2verts.long()
        a, b, c = (mesh.coords[fv[:, j]] for j in range(3))
        ax, ay, az = a.unbind(1)
        ux, uy, uz = (b - a).unbind(1)
        vx, vy, vz = (c - a).unbind(1)
        nx = uy * vz - uz * vy
        ny = uz * vx - ux * vz
        nz = ux * vy - uy * vx
        inv = 1.0 / torch.clamp(sqrt_rn(nx * nx + ny * ny + nz * nz), min=1e-30)
        zero = torch.zeros_like(nx)
        return torch.stack([nx * inv, ny * inv, nz * inv, zero, ax, ay, az, zero],
                           1).contiguous()

    return _cached(mesh, "normals", (mesh.face2verts, mesh.coords), build)


class SearchResult(NamedTuple):
    elem_ids: torch.Tensor                # (N,) i32 parent element; INVALID if removed
    dest_c: Tuple[torch.Tensor, ...]      # per-component (N,) final destination
    iters: torch.Tensor                   # () i32 walk iterations taken
    all_found: torch.Tensor               # () bool: everyone finished in budget
    active: Optional[torch.Tensor] = None  # (N,) bool, elem_ids >= 0
    # with record_exit: the face of the last real boundary hit (-1: none),
    # the crossing point there (the initial destination where none) and the
    # number of real hits
    exit_side: Optional[torch.Tensor] = None
    hit_c: Optional[Tuple[torch.Tensor, ...]] = None
    num_hits: Optional[torch.Tensor] = None
    # with recover="project": loop-limit survivors accepted by projection
    num_recovered: Optional[torch.Tensor] = None

    @property
    def dest(self) -> torch.Tensor:
        """(N, dim) destination: the walk's own (N, dim) output where the
        components are its columns (no copy; kernel M's results), else the
        components stacked."""
        return _joined(self.dest_c)

    @property
    def hit(self) -> Optional[torch.Tensor]:
        """(N, dim) crossing points of the exit record (None without it),
        as :attr:`dest` joins them."""
        return None if self.hit_c is None else _joined(self.hit_c)


def _joined(parts: Tuple[torch.Tensor, ...]) -> torch.Tensor:
    """(N, k) rows of k per-component (N,) tensors: a view of the (N, k)
    block they lie in, without a copy, where they are its columns in order
    (split off one contiguous (N, k) tensor); else their stack."""
    p0, k = parts[0], len(parts)
    store = p0.untyped_storage().data_ptr()
    if all(p.dim() == 1 and p.shape == p0.shape and p.stride() == (k,)
           and p.dtype == p0.dtype and p.untyped_storage().data_ptr() == store
           and p.storage_offset() == p0.storage_offset() + j
           for j, p in enumerate(parts)):
        return p0.as_strided((p0.shape[0], k), (k, 1))
    return torch.stack(parts, dim=-1)


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


def _walk_batch(walk_geom: torch.Tensor, dest_x, dest_y, elem_start, active,
                max_iters: int, grid: Optional[Grid] = None,
                steps_of: Optional[torch.Tensor] = None,
                rows_read: Optional[torch.Tensor] = None):
    """The batch walk of :func:`walk_locate_plain`: (elem, iterations,
    walkers deleted at the limit), the last two as Python ints.  Where
    given, ``steps_of`` ((N,) integers) gains each walker's steps, the
    ``walk_geom`` rows it reads, and ``rows_read`` ((E,) bool) is set at
    each row read."""
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
        if steps_of is not None:
            steps_of[idx] += 1
        if rows_read is not None:
            rows_read[e.long()] = True
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
        out = remove_on_exit(BoundaryCtx(e, None, None, None, None))
        new_e = torch.where(inside, e, torch.where(
            retry, f, torch.where(hit, out.elem, nxt)))
        elem[idx] = new_e
        fbg[idx] = torch.where(retry, -2, f)
        fin = inside | (hit & out.done)
        done[idx] = fin
        idx = idx[~fin]
    unfinished = idx.numel()
    if unfinished:
        elem[idx] = INVALID
    return elem, it0 + steps, unfinished


def walk_locate_plain(walk_geom: torch.Tensor, dest_x, dest_y, elem_start,
                      active, max_iters: int, grid: Optional[Grid] = None):
    """Plain PyTorch version of kernel L; returns (elem, active, iters,
    all_found) with the kernel's semantics (see :func:`walk_locate`)."""
    elem, iters, unfinished = _walk_batch(walk_geom, dest_x, dest_y, elem_start,
                                          active, max_iters, grid)
    dev = elem.device
    return (elem, elem >= 0, torch.tensor(iters, dtype=torch.int32, device=dev),
            torch.tensor(unfinished == 0, device=dev))


def walk_locate_into_plain(walk_geom: torch.Tensor, dest_x, dest_y, elem_start,
                           walkers, max_iters: int, elem: torch.Tensor,
                           stats: torch.Tensor) -> None:
    """Plain PyTorch version of :func:`walk_locate_into`."""
    e, iters, unfinished = _walk_batch(walk_geom, dest_x, dest_y, elem_start,
                                       walkers, max_iters)
    elem.copy_(torch.where(walkers, e, elem))
    stats[0:1].clamp_(min=iters)
    stats[1] += unfinished
    stats[2] += (walkers & (e >= 0)).sum(dtype=torch.int32)


# ---------------------------------------------------------------------------
# kernel L wrapper
# ---------------------------------------------------------------------------

def _column(t: torch.Tensor, n: int, dev, name: str):
    """(pointer, stride) of an (n,) f32 column of any stride on ``dev``."""
    if t.dtype != torch.float32 or t.shape != (n,) or t.device != dev:
        raise ValueError(f"{name}: ({n},) f32 destination columns on {dev} expected")
    return t.data_ptr(), t.stride(0)


def _walk_plain(walk_geom: torch.Tensor, dest_x, dest_y, elem_start, walkers,
                max_iters: int, elem=None, stats=None) -> torch.Tensor:
    """Launch kernel L's sparse plain walk (``pp_walk_plain``): the
    walkers' slots of ``elem`` in place, or with no ``elem`` the counts
    alone (a given ``stats`` holds kernel J's zeroed counts, else the launch
    zeroes its own).  Returns the stats, [max steps, walkers deleted at the
    limit, walkers found]."""
    n = walkers.shape[0]
    dev = walkers.device
    if (walk_geom.dtype != torch.float32 or walk_geom.dim() != 2
            or walk_geom.shape[1] != 12 or elem_start.dtype != torch.int32
            or walkers.dtype != torch.bool or elem_start.shape != (n,)):
        raise ValueError("walk_locate: f32 (E, 12) walk_geom, i32 elem_start "
                         "and bool walkers expected")
    if walk_geom.data_ptr() % 16:
        raise ValueError("walk_locate: walk_geom must be 16-byte aligned")
    if n >= 1 << 31:
        raise ValueError("walk_locate: the plain walk takes fewer than 2^31 particles")
    px, sx = _column(dest_x, n, dev, "walk_locate")
    py, sy = _column(dest_y, n, dev, "walk_locate")
    zero = stats is None
    if zero:
        stats = torch.empty(3, dtype=torch.int32, device=dev)
    P = ctypes.c_void_p
    err = _build.lib().pp_walk_plain(
        P(px), sx, P(py), sy, P(elem_start.data_ptr()), P(walkers.data_ptr()),
        P(walk_geom.data_ptr()), walk_geom.shape[0], max_iters,
        P(None if elem is None else elem.data_ptr()), P(stats.data_ptr()), int(zero), n,
        P(kernels.stream_handle()))
    _build.check(err, "locate")
    kernels.LAUNCHES["locate"] += 1
    return stats


def walk_locate(walk_geom: torch.Tensor, dest_x, dest_y, elem_start, active,
                max_iters: int, grid: Optional[Grid] = None):
    """Locate every active particle's destination; returns (elem, active,
    iters, all_found): :func:`walk_locate_counted` with ``all_found`` in
    place of its count."""
    elem, act, iters, deleted = walk_locate_counted(
        walk_geom, dest_x, dest_y, elem_start, active, max_iters, grid)
    return elem, act, iters, deleted == 0


def walk_locate_counted(walk_geom: torch.Tensor, dest_x, dest_y, elem_start, active,
                        max_iters: int, grid: Optional[Grid] = None):
    """Locate every active particle's destination; returns (elem, active,
    iters, deleted), ``deleted`` the walkers deleted at the limit (0-d
    i32).

    With ``grid`` (cell rows attached): the peel tests the destination
    cell's two candidates (iteration 1; a :class:`BandGrid2D`'s cells come
    from kernel B); misses walk from candidate A on a
    guess trajectory that, on hitting the boundary, retries once from the
    clamped ``elem_start``.  Without ``grid``: the plain walk from the
    clamped ``elem_start``.  Walkers left after ``max_iters`` iterations are
    deleted; ``iters`` is the iteration count of a batch walk that stops when
    no walker is left.  Inactive particles get INVALID.

    Kernel L on CUDA tensors (the peel form one thread a particle; without
    a grid its dense plain walk, lockstep tiles of 32 slots, every slot
    written: see :func:`walk_locate_into` for the sparse walks),
    :func:`walk_locate_plain`'s batch walk on CPU tensors."""
    tensors = [walk_geom, dest_x, dest_y, elem_start, active]
    if grid is not None:
        if grid.cell_rows is None:
            raise ValueError("walk_locate: the locator grid has no cell rows")
        tensors.append(grid.cell_rows)
    if not kernels.use_kernel("locate", *tensors):
        elem, iters, unfinished = _walk_batch(walk_geom, dest_x, dest_y, elem_start,
                                              active, max_iters, grid)
        dev = elem.device
        return (elem, elem >= 0, torch.tensor(iters, dtype=torch.int32, device=dev),
                torch.tensor(unfinished, dtype=torch.int32, device=dev))
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
    P = ctypes.c_void_p
    if grid is None:                                       # the dense plain walk
        err = _build.lib().pp_walk_dense(
            P(dest_x.data_ptr()), P(dest_y.data_ptr()), P(elem_start.data_ptr()),
            P(active.data_ptr()), P(walk_geom.data_ptr()), walk_geom.shape[0],
            max_iters, P(elem.data_ptr()), P(act.data_ptr()), P(stats.data_ptr()), n,
            P(kernels.stream_handle()))
    else:                                                  # the peel (iteration 1) + walk
        cells = None
        ox, oy, ihx, ihy, nx, ny = 0.0, 0.0, 0.0, 0.0, 1, 1
        if isinstance(grid, BandGrid2D):
            cells = band_cell_of(grid, dest_x, dest_y)      # kernel B
        else:
            (ox, oy), (ihx, ihy), nx, ny = grid.origin, grid.inv_h, grid.nx, grid.ny
        err = _build.lib().pp_walk_locate(
            P(dest_x.data_ptr()), P(dest_y.data_ptr()), P(elem_start.data_ptr()),
            P(active.data_ptr()), P(walk_geom.data_ptr()), walk_geom.shape[0],
            P(grid.cell_rows.data_ptr()), P(None if cells is None else cells.data_ptr()),
            ox, oy, ihx, ihy, nx, ny, max_iters, 1,
            P(elem.data_ptr()), P(act.data_ptr()), P(stats.data_ptr()), n,
            P(kernels.stream_handle()))
    _build.check(err, "locate")
    kernels.LAUNCHES["locate"] += 1
    return elem, act, stats[0] if grid is None else stats[0] + 1, stats[1]


def walk_locate_count(walk_geom: torch.Tensor, dest_x, dest_y, elem_start, walkers,
                      max_iters: int):
    """The plain walk of the ``walkers`` (bool mask) for its counts alone:
    (found, all_found), the walkers that end in an element (i32 0-d) and
    whether none was deleted at the limit, as :func:`walk_locate`'s
    ``(elem >= 0).sum()`` and ``all_found`` give them.  Kernel L's sparse
    plain walk with no output but its counts on CUDA tensors (the
    destination columns of any stride), :func:`walk_locate_plain` on CPU
    tensors."""
    if not kernels.use_kernel("locate", walk_geom, elem_start, walkers):
        elem, _, _, all_found = walk_locate_plain(walk_geom, dest_x, dest_y, elem_start,
                                                  walkers, max_iters)
        return (elem >= 0).sum(dtype=torch.int32), all_found
    stats = _walk_plain(walk_geom, dest_x, dest_y, elem_start, walkers, max_iters)
    return stats[2], stats[1] == 0


def walk_locate_into(walk_geom: torch.Tensor, dest_x, dest_y, elem_start, walkers,
                     max_iters: int, elem: torch.Tensor, stats: torch.Tensor) -> None:
    """The plain walk of the ``walkers`` (bool mask) in place: each walker's
    element (INVALID where it leaves the mesh or meets the limit) into
    ``elem`` (i32; other slots are not touched), and into ``stats`` (i32,
    zeroed by the caller): [0] the most steps a walker took, [1] the
    walkers deleted at the limit, [2] the walkers found.  Kernel L's sparse
    plain walk on CUDA tensors (the destination columns of any stride; a
    slot that does not walk costs its mask byte), its plain version
    :func:`walk_locate_into_plain` on CPU tensors."""
    if not kernels.use_kernel("locate", walk_geom, elem_start, walkers, elem, stats):
        return walk_locate_into_plain(walk_geom, dest_x, dest_y, elem_start, walkers,
                                      max_iters, elem, stats)
    if elem.dtype != torch.int32 or elem.shape != walkers.shape or stats.dtype != torch.int32:
        raise ValueError("walk_locate_into: i32 elem and stats expected")
    _walk_plain(walk_geom, dest_x, dest_y, elem_start, walkers, max_iters, elem,
                stats=stats)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def _components(x):
    if isinstance(x, tuple):
        return x
    return tuple(x[:, i].contiguous() for i in range(x.shape[1]))


def _columns(x):
    """The per-component (N,) tensors of an (N, dim) array, as views (no
    copy), or the tuple as given."""
    if isinstance(x, tuple):
        return x
    return x.unbind(1)


def _rows_of(x) -> torch.Tensor:
    """(N, dim) contiguous f32 points from an array or a tuple of
    components."""
    if isinstance(x, tuple):
        return torch.stack(x, dim=1)
    return x.contiguous()


def _fast_case_2d(boundary_handler, record_exit: bool, recover: str) -> bool:
    """The case kernel L runs: remove-on-exit, no exit record and no
    recovery."""
    return boundary_handler is remove_on_exit and not record_exit and recover == "off"


def search_mesh_2d(mesh: Mesh2D, x_orig, x_tgt, elem_init: torch.Tensor,
                   active: torch.Tensor, max_iters: int = 200,
                   boundary_handler=remove_on_exit, record_exit: bool = False,
                   widths=None, recover: str = "off") -> SearchResult:
    """Walk every active particle from ``elem_init`` (clamped into range) to
    the element containing ``x_tgt``.  Inactive particles get INVALID;
    walkers left at the iteration limit are deleted (or, with
    ``recover="project"``, recovered where they are stranded at their
    triangle's closure).  :func:`remove_on_exit` with neither
    ``record_exit`` nor ``recover`` runs kernel L's plain walk; every other
    case :func:`trace_2d` (kernel M2).  ``widths`` (the TPU compaction
    pyramid) is accepted and ignored: the kernels keep finished walkers
    idle instead of compacting."""
    _check_walk_options(boundary_handler, recover)
    if _fast_case_2d(boundary_handler, record_exit, recover):
        dx, dy = _components(x_tgt)
        elem, act, iters, all_found = walk_locate(
            mesh.walk_geom, dx, dy, elem_init.to(torch.int32), active, max_iters)
        return SearchResult(elem, (dx, dy), iters, all_found, act)
    orig = None if x_orig is None else _rows_of(x_orig)
    return trace_2d(mesh, orig, _rows_of(x_tgt), elem_init.to(torch.int32), active,
                    max_iters, boundary_handler, record_exit, recover)


def search_mesh_2d_accel(mesh: Mesh2D, grid: Grid, x_orig, x_tgt,
                         elem_prev: torch.Tensor, active: torch.Tensor,
                         max_iters: int = 200,
                         boundary_handler=remove_on_exit,
                         record_exit: bool = False, widths=None,
                         aux_capture=None, recover: str = "off") -> SearchResult:
    """Grid-accelerated search through the cell-row peel ("rows" layout of
    a cartesian or flux-band grid; the other layouts are not ported):
    results equal :func:`search_mesh_2d`'s, with the peel counted as one
    iteration and a guess walk that retries once from the clamped
    ``elem_prev`` where it meets the boundary (a guess walk's boundary hit
    is never a real hit).  Kernel L in the fast case, kernel M2 in every
    other.  ``aux_capture`` (a TPU gather-saving knob) is not ported."""
    _check_walk_options(boundary_handler, recover)
    if aux_capture is not None:
        raise NotImplementedError("aux_capture is not ported")
    if grid.cell_rows is None:
        raise NotImplementedError("only the cell-rows peel is ported")
    if _fast_case_2d(boundary_handler, record_exit, recover):
        dx, dy = _components(x_tgt)
        elem, act, iters, all_found = walk_locate(
            mesh.walk_geom, dx, dy, elem_prev.to(torch.int32), active, max_iters,
            grid=grid)
        return SearchResult(elem, (dx, dy), iters, all_found, act)
    orig = None if x_orig is None else _rows_of(x_orig)
    return trace_2d(mesh, orig, _rows_of(x_tgt), elem_prev.to(torch.int32), active,
                    max_iters, boundary_handler, record_exit, recover, grid=grid)


def search_mesh_2d_pt(mesh: Mesh2D, pt, elem_init, max_iters: int = 100) -> torch.Tensor:
    """Single-point location (``search_mesh_2d_pt``, adjacency.hpp:1160-1252):
    the () i32 id of the element containing ``pt``, walked from
    ``elem_init``, or -1."""
    dev = mesh.device
    p = torch.as_tensor(pt, dtype=torch.float32, device=dev).reshape(1, 2)
    e = torch.as_tensor(elem_init, dtype=torch.int32, device=dev).reshape(1)
    res = search_mesh_2d(mesh, p, p, e, torch.ones(1, dtype=torch.bool, device=dev),
                         max_iters)
    return res.elem_ids[0]


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


def _walk_batch_3d(walk_geom: torch.Tensor, dx, dy, dz, elem_start, active,
                   max_iters: int, grid: Optional[LocatorGrid3D] = None,
                   rows_read: Optional[torch.Tensor] = None):
    """The batch walk of :func:`walk_locate_3d_plain` over the unfinished
    walkers: (elem, iterations, walkers deleted at the limit), the last two
    as Python ints.  Where given, ``rows_read`` ((E,) bool) is set at each
    ``walk_geom`` row a walk step reads."""
    n_elems = walk_geom.shape[0]
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
        if rows_read is not None:
            rows_read[e.long()] = True
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
        out = remove_on_exit(BoundaryCtx(e, None, None, None, None))
        elem[idx] = torch.where(inside, e, torch.where(
            retry, f, torch.where(hit, out.elem, nxt)))
        fbg[idx] = torch.where(retry, -2, f)
        fin = inside | (hit & out.done)
        idx = idx[~fin]
    unfinished = idx.numel()
    if unfinished:
        elem[idx] = INVALID
    return elem, it0 + steps, unfinished


def walk_locate_3d_plain(walk_geom: torch.Tensor, dest: torch.Tensor,
                         elem_start, active, max_iters: int,
                         grid: Optional[LocatorGrid3D] = None):
    """Plain PyTorch version of kernel L3 (a batch walk over the unfinished
    walkers); returns (elem, active, iters, all_found, num_unfinished) with
    the kernel's semantics (see :func:`walk_locate_3d`)."""
    elem, iters, unfinished = _walk_batch_3d(walk_geom, *dest.unbind(1), elem_start,
                                             active, max_iters, grid)
    dev = elem.device
    return (elem, elem >= 0,
            torch.tensor(iters, dtype=torch.int32, device=dev),
            torch.tensor(unfinished == 0, device=dev),
            torch.tensor(unfinished, dtype=torch.int32, device=dev))


def walk_locate_3d_into_plain(walk_geom: torch.Tensor, dest_x, dest_y, dest_z,
                              elem_start, walkers, max_iters: int, elem: torch.Tensor,
                              stats: torch.Tensor) -> None:
    """Plain PyTorch version of :func:`walk_locate_3d_into`."""
    e, iters, unfinished = _walk_batch_3d(walk_geom, dest_x, dest_y, dest_z, elem_start,
                                          walkers, max_iters)
    elem.copy_(torch.where(walkers, e, elem))
    stats[0:1].clamp_(min=iters)
    stats[1] += unfinished
    stats[2] += (walkers & (e >= 0)).sum(dtype=torch.int32)


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


def walk_locate_3d_into(walk_geom: torch.Tensor, dest_x, dest_y, dest_z, elem_start,
                        walkers, max_iters: int, elem: torch.Tensor,
                        stats: torch.Tensor) -> None:
    """The plain walk of the ``walkers`` (bool mask) in a tet mesh, in place:
    :func:`walk_locate_into`'s contract with (N,) destination columns x, y
    and z (views of any stride).  Kernel L3's sparse plain walk on CUDA
    tensors (L3's plain-walk steps and budget on kernel L's sparse
    schedule), :func:`walk_locate_3d_into_plain` on CPU tensors."""
    if not kernels.use_kernel("locate3d", walk_geom, elem_start, walkers, elem, stats):
        return walk_locate_3d_into_plain(walk_geom, dest_x, dest_y, dest_z, elem_start,
                                         walkers, max_iters, elem, stats)
    n = walkers.shape[0]
    dev = walkers.device
    if (walk_geom.dtype != torch.float32 or walk_geom.dim() != 2
            or walk_geom.shape[1] != 16 or elem_start.dtype != torch.int32
            or walkers.dtype != torch.bool or elem_start.shape != (n,)
            or elem.dtype != torch.int32 or elem.shape != (n,)
            or stats.dtype != torch.int32):
        raise ValueError("walk_locate_3d_into: f32 (E, 16) walk_geom, i32 elem_start, "
                         "bool walkers, i32 elem and stats expected")
    if walk_geom.data_ptr() % 16:
        raise ValueError("walk_locate_3d_into: walk_geom must be 16-byte aligned")
    if n >= 1 << 31:
        raise ValueError("walk_locate_3d_into: fewer than 2^31 particles expected")
    cols = [_column(c, n, dev, "walk_locate_3d_into") for c in (dest_x, dest_y, dest_z)]
    P = ctypes.c_void_p
    err = _build.lib().pp_walk_plain_3d(
        *(a for p, st in cols for a in (P(p), st)), P(elem_start.data_ptr()),
        P(walkers.data_ptr()), P(walk_geom.data_ptr()), walk_geom.shape[0], max_iters,
        P(elem.data_ptr()), P(stats.data_ptr()), n, P(kernels.stream_handle()))
    _build.check(err, "locate3d")
    kernels.LAUNCHES["locate3d"] += 1


# ---------------------------------------------------------------------------
# tets, every other case: plain PyTorch version of kernel M
# ---------------------------------------------------------------------------

# kernel M's walk cores: search method -> core id ("bcc" for any other name,
# as the JAX package's default)
CORES = {"bcc": 0, "hybrid": 1, "intersection": 2}


def core_of(method: str) -> str:
    return method if method in CORES else "bcc"


def _affine3(g, c: int, x, y, z):
    """l(x) = A·x + c of the affine row at column c, summed left to right."""
    return g[:, c] * x + g[:, c + 1] * y + g[:, c + 2] * z + g[:, c + 3]


def _pick4(k, vals):
    """vals[k] per walker, k in 0..3."""
    return torch.where(k == 0, vals[0], torch.where(
        k == 1, vals[1], torch.where(k == 2, vals[2], vals[3])))


def _most_negative(ws):
    """(wmin, k): the most negative of w0..w3, the first on ties (strictly
    smaller moves; NaN never does)."""
    wmin, k = ws[0], torch.zeros_like(ws[0], dtype=torch.int64)
    for j in (1, 2, 3):
        take = ws[j] < wmin
        wmin = torch.where(take, ws[j], wmin)
        k = torch.where(take, j, k)
    return wmin, k


def _core_bcc(g, dest, orig, need_t):
    """(inside, exit k, t) of ``_core_3d_bcc`` on walk_geom rows: the face
    opposite the most negative destination weight; t = w_o / (w_o - w_d)
    of that weight along orig -> dest."""
    dx, dy, dz = dest
    l1, l2, l3, w0, inside = bary_inside_3d(g[:, :12].unbind(1), dx, dy, dz)
    wmin, k = _most_negative((w0, l1, l2, l3))
    t = None
    if need_t:
        ox, oy, oz = orig
        lo = [_affine3(g, 4 * j, ox, oy, oz) for j in range(3)]
        wo = _pick4(k, (1.0 - lo[0] - lo[1] - lo[2], *lo))
        den = wo - wmin
        t = wo / torch.where(den == 0, torch.ones_like(den), den)
    return inside, k, t


def _core_hybrid(g, dest, orig, need_t):
    """``_core_3d_hybrid``: the earliest crossing among the faces whose
    weight falls along orig -> dest (the rate is the directional derivative
    -A_k·v, exactly 0 for a stationary walker), else the BCC choice."""
    dx, dy, dz = dest
    ox, oy, oz = orig
    l1, l2, l3, w0, inside = bary_inside_3d(g[:, :12].unbind(1), dx, dy, dz)
    _, k_bcc = _most_negative((w0, l1, l2, l3))
    lo = [_affine3(g, 4 * j, ox, oy, oz) for j in range(3)]
    lo = [1.0 - lo[0] - lo[1] - lo[2]] + lo
    vx, vy, vz = dx - ox, dy - oy, dz - oz
    lv = [g[:, 4 * j] * vx + g[:, 4 * j + 1] * vy + g[:, 4 * j + 2] * vz
          for j in range(3)]
    lv = [-lv[0] - lv[1] - lv[2]] + lv
    t_exit = torch.full_like(dx, torch.inf)
    k_seg = torch.zeros_like(k_bcc)
    for j in range(4):
        den = -lv[j]
        tj = lo[j] / torch.where(den == 0, torch.ones_like(den), den)
        valid = (den > 0) & (tj < t_exit)
        t_exit = torch.where(valid, tj, t_exit)
        k_seg = torch.where(valid, j, k_seg)
    seg_ok = torch.isfinite(t_exit)
    k = torch.where(seg_ok, k_seg, k_bcc)
    t = torch.where(seg_ok, t_exit, 1.0) if need_t else None
    return inside, k, t


def _core_mt(g, dest, orig, need_t):
    """``_core_3d_mt`` on walk_planes rows: clip orig -> dest against the
    tet's outward unit face planes and cross the exit face.  A moving
    segment that exits no face is at its parent; a stationary walker is
    never declared inside by that rule and descends across the most
    violated plane."""
    dx, dy, dz = dest
    ox, oy, oz = orig
    vx, vy, vz = dx - ox, dy - oy, dz - oz
    inside = torch.ones_like(dx, dtype=torch.bool)
    t_exit = torch.full_like(dx, torch.inf)
    k_exit = torch.zeros_like(dx, dtype=torch.int64)
    viol_best = torch.full_like(dx, -torch.inf)
    k_viol = torch.zeros_like(k_exit)
    for i in range(4):
        nx, ny, nz, off = (g[:, 4 * i + j] for j in range(4))
        s_dest = nx * dx + ny * dy + nz * dz
        inside = inside & (s_dest <= off + MT_TOL * (1.0 + off.abs()))
        viol = s_dest - off
        take = viol > viol_best
        viol_best = torch.where(take, viol, viol_best)
        k_viol = torch.where(take, i, k_viol)
        ndd = nx * vx + ny * vy + nz * vz
        s_orig = nx * ox + ny * oy + nz * oz
        ti = (off - s_orig) / torch.where(ndd == 0, torch.ones_like(ndd), ndd)
        valid = (ndd > 0) & (ti < t_exit)
        t_exit = torch.where(valid, ti, t_exit)
        k_exit = torch.where(valid, i, k_exit)
    moving = (vx != 0.0) | (vy != 0.0) | (vz != 0.0)
    fin = torch.isfinite(t_exit)
    k = torch.where(fin, k_exit, k_viol)
    inside = inside | (moving & ~fin)
    t = torch.where(fin, t_exit, 1.0) if need_t else None
    return inside, k, t


_CORE_FNS = {"bcc": (_core_bcc, 12), "hybrid": (_core_hybrid, 12),
             "intersection": (_core_mt, 16)}   # core -> (fn, neighbour column)


def _walk_table(mesh: Mesh3D, core: str) -> torch.Tensor:
    return mesh.walk_planes if core == "intersection" else mesh.walk_geom


def _sq3(a, b):
    """|a - b|² of per-component triples, summed left to right."""
    d = [x - y for x, y in zip(a, b)]
    return d[0] * d[0] + d[1] * d[1] + d[2] * d[2]


def _det3(a, b, c):
    return (a[0] * (b[1] * c[2] - b[2] * c[1]) - a[1] * (b[0] * c[2] - b[2] * c[0])
            + a[2] * (b[0] * c[1] - b[1] * c[0]))


def recover_project(mesh: Mesh3D, e: torch.Tensor, dest):
    """``_make_recover`` (3D): (ok, q) for loop-limit survivors in tets
    ``e`` with destinations ``dest`` (per-component): q is the closest point
    of the tet's closure (the destination itself where the tet contains it
    within its volume tolerance, else the nearest of its four faces'
    closest points), nudged toward the centroid; ok where that distance is
    within RECOVER_REL_TOL of the tet's longest edge."""
    ev = mesh.elem2verts[torch.clamp(e, min=0).long()].long()
    vs = [tuple(mesh.coords[ev[:, i]].unbind(1)) for i in range(4)]
    p = tuple(dest)
    p3 = torch.stack(p, dim=1)
    best = d2 = None
    for (i, j, k) in ((1, 2, 3), (0, 2, 3), (0, 1, 3), (0, 1, 2)):
        q = closest_point_on_triangle(p3, *(torch.stack(vs[m], 1) for m in (i, j, k)))
        qd = _sq3(q.unbind(1), p)
        if best is None:
            best, d2 = q, qd
        else:
            take = qd < d2
            best = torch.where(take[:, None], q, best)
            d2 = torch.minimum(qd, d2)
    sub = [tuple(x - y for x, y in zip(vs[m], vs[0])) for m in (1, 2, 3)]
    vol = _det3(*sub)
    sgn = torch.sign(torch.where(vol == 0, torch.ones_like(vol), vol))
    tolv = 1e-6 * vol.abs()
    contained = torch.ones_like(vol, dtype=torch.bool)
    for k in range(4):
        reps = [p if m == k else vs[m] for m in range(4)]
        wk = _det3(*(tuple(x - y for x, y in zip(reps[m], reps[0])) for m in (1, 2, 3)))
        contained = contained & (wk * sgn >= -tolv)
    d2 = torch.where(contained, 0.0, d2)
    best = torch.where(contained[:, None], p3, best)
    scale2 = torch.zeros_like(vol)
    for i in range(4):
        for j in range(i + 1, 4):
            scale2 = torch.maximum(scale2, _sq3(vs[i], vs[j]))
    ok = d2 <= (RECOVER_REL_TOL ** 2) * scale2
    four = torch.tensor(4.0, dtype=vol.dtype, device=vol.device)
    q = tuple(best.unbind(1))
    cent = [(((vs[0][c] + vs[1][c]) + vs[2][c]) + vs[3][c]) / four for c in range(3)]
    return ok, tuple(qc + (cc - qc) * RECOVER_NUDGE for qc, cc in zip(q, cent))


def _needs_hit(boundary_handler, record_exit: bool) -> bool:
    """Whether the walk forms each crossing point: for the exit record, and
    for a handler that moves the destination (the continuation segment
    restarts at the wall) or asks for it."""
    return bool(record_exit or getattr(boundary_handler, "modifies_dest", True)
                or getattr(boundary_handler, "needs_hit", False))


def _check_walk_options(boundary_handler, recover: str) -> None:
    if not callable(boundary_handler):
        raise ValueError("boundary_handler must be callable")
    if recover not in ("off", "project"):
        raise ValueError(f"unknown recover mode {recover!r}; expected 'off' or "
                         f"'project'")


def trace_3d_plain(mesh: Mesh3D, orig: torch.Tensor, dest: torch.Tensor,
                   elem_start, active, max_iters: int, method: str = "bcc",
                   boundary_handler=remove_on_exit, record_exit: bool = False,
                   recover: str = "off", grid: Optional[LocatorGrid3D] = None
                   ) -> SearchResult:
    """Plain PyTorch version of kernel M (a batch walk over the unfinished
    walkers, :func:`trace_3d`'s semantics), with any handler of the
    protocol."""
    _check_walk_options(boundary_handler, recover)
    core = core_of(method)
    core_fn, nb = _CORE_FNS[core]
    table = _walk_table(mesh, core)
    n_elems = table.shape[0]
    needs_hit = _needs_hit(boundary_handler, record_exit)
    d = [c.clone() for c in dest.unbind(1)]
    o = [c.clone() for c in orig.unbind(1)]
    start = torch.clamp(elem_start.to(torch.int32), 0, n_elems - 1)
    elem = torch.where(active, start, INVALID)
    fbg = torch.full_like(elem, -2)
    done = ~active
    it0 = 0
    if grid is not None:
        it0 = 1
        e0, inside = _peel_3d(grid, *d)
        elem = torch.where(active, e0, INVALID)
        fbg = torch.where(active & ~inside, start, -2)
        done = ~active | inside
    side_rec = torch.full_like(elem, INVALID)
    nhits = torch.zeros_like(elem)
    hit_rec = [c.clone() for c in d]
    idx = torch.nonzero(~done).flatten()
    steps = 0
    for _ in range(max(max_iters - it0, 0)):
        if idx.numel() == 0:
            break
        steps += 1
        e, f = elem[idx], fbg[idx]
        dw, ow = tuple(c[idx] for c in d), tuple(c[idx] for c in o)
        g = table[e.long()]
        inside, k, t = core_fn(g, dw, ow, needs_hit)
        nxt = torch.gather(g[:, nb:nb + 4], 1, k[:, None])[:, 0].to(torch.int32)
        side = torch.gather(mesh.elem2faces[e.long()], 1, k[:, None])[:, 0]
        exposed = nxt == INVALID
        retry = ~inside & exposed & (f >= 0)
        real = ~inside & exposed & (f < 0)
        hit = None
        if needs_hit:
            tc = torch.clamp(t, 0.0, 1.0)
            hit = tuple(oc + tc * (dc - oc) for oc, dc in zip(ow, dw))
        bres = boundary_handler(BoundaryCtx(e, side, ow, dw, mesh, hit, t))
        elem[idx] = torch.where(inside, e, torch.where(
            retry, f, torch.where(exposed, bres.elem.to(e.dtype), nxt)))
        fbg[idx] = torch.where((f >= 0) & ~retry & ~inside, f, -2)
        if bres.dest is not None:
            for c in range(3):
                d[c][idx] = torch.where(real, bres.dest[c], dw[c])
                o[c][idx] = torch.where(real, hit[c], ow[c])
        if record_exit:
            side_rec[idx] = torch.where(real, side, side_rec[idx])
            nhits[idx] += real.to(nhits.dtype)
            for c in range(3):
                hit_rec[c][idx] = torch.where(real, hit[c], hit_rec[c][idx])
        idx = idx[~(inside | (real & bres.done))]
    dev = elem.device
    num_rec = None
    if recover == "project":
        n_ok = 0
        if idx.numel():
            e = elem[idx]
            ok, q = recover_project(mesh, e, tuple(c[idx] for c in d))
            ok = ok & (e >= 0)
            for c in range(3):
                d[c][idx] = torch.where(ok, q[c], d[c][idx])
            n_ok = int(ok.sum())
            idx = idx[~ok]
        num_rec = torch.tensor(n_ok, dtype=torch.int32, device=dev)
    elem[idx] = INVALID
    rec = {}
    if record_exit:
        rec = dict(exit_side=side_rec, hit_c=tuple(hit_rec), num_hits=nhits)
    return SearchResult(
        elem, tuple(d), torch.tensor(it0 + steps, dtype=torch.int32, device=dev),
        torch.tensor(idx.numel() == 0, device=dev), elem >= 0,
        num_recovered=num_rec, **rec)


# ---------------------------------------------------------------------------
# kernel M wrapper
# ---------------------------------------------------------------------------

def trace_3d(mesh: Mesh3D, orig: Optional[torch.Tensor], dest: torch.Tensor,
             elem_start, active, max_iters: int, method: str = "bcc",
             boundary_handler=remove_on_exit, record_exit: bool = False,
             recover: str = "off", grid: Optional[LocatorGrid3D] = None
             ) -> SearchResult:
    """The tet walk of every active particle from ``elem_start`` (clamped;
    or, with ``grid``, the peel of the destination cell's two candidates,
    counted as one iteration, then a guess walk that retries once from the
    clamped start where it meets the boundary) to the tet containing its
    (N, 3) ``dest``, along the segment from ``orig`` (N, 3; unused, and may
    be None, for the BCC core without a hit point).

    ``method``: "bcc" (greedy barycentric descent), "hybrid" (segment clip
    off the same rows, greedy fallback) or "intersection" (clip against the
    outward face planes of ``walk_planes``).  ``boundary_handler``:
    :func:`remove_on_exit` or :func:`reflect_on_exit_3d` (mirror the
    destination, walk on from the crossing point).  ``record_exit``: the
    exit face, crossing point and count of real boundary hits.
    ``recover="project"``: loop-limit survivors whose destination lies at
    the closure of their tet are accepted there, at the projected point.

    Kernel M (``kernels/csrc/trace3d.cu``) on CUDA tensors, which knows the
    two handlers above (reflect through the mesh's :func:`reflect_normals`)
    and raises NotImplementedError for any other; :func:`trace_3d_plain` on
    CPU tensors.  The result's (N, 3) ``dest`` and ``hit`` are then the
    kernel's own outputs, not copies."""
    _check_walk_options(boundary_handler, recover)
    core = core_of(method)
    needs_orig = _needs_hit(boundary_handler, record_exit) or core != "bcc"
    if orig is None:
        if needs_orig:
            raise ValueError("trace_3d: this walk needs the segment origins")
        orig = dest
    if grid is not None and grid.cell_rows is None:
        raise ValueError("trace_3d: the locator grid has no cell rows")
    table = _walk_table(mesh, core)
    if not kernels.use_kernel("trace3d", dest, orig, elem_start, active, table,
                              mesh.walk_geom):
        return trace_3d_plain(mesh, orig, dest, elem_start, active, max_iters, method,
                              boundary_handler, record_exit, recover, grid)
    if boundary_handler is remove_on_exit:
        reflect = 0
    elif boundary_handler is reflect_on_exit_3d:
        reflect = 1
    else:
        raise NotImplementedError("kernel M knows remove_on_exit and "
                                  "reflect_on_exit_3d; other handlers run on the CPU")
    n, E = dest.shape[0], mesh.nelems
    if (dest.dtype != torch.float32 or dest.shape != (n, 3) or orig.shape != (n, 3)
            or orig.dtype != torch.float32 or elem_start.dtype != torch.int32
            or active.dtype != torch.bool or elem_start.shape != (n,)
            or active.shape != (n,)):
        raise ValueError("trace_3d: (N, 3) f32 orig and dest, i32 elem_start and "
                         "bool active expected")
    if n >= 1 << 30:
        raise ValueError("trace_3d: the kernel takes fewer than 2^30 particles")
    for t in (mesh.walk_geom, mesh.walk_planes):
        if t.data_ptr() % 16:
            raise ValueError("trace_3d: walk tables must be 16-byte aligned")
    ids = None
    if grid is not None:
        ids = grid.candidate_ids(mesh.walk_geom)
    normals = reflect_normals(mesh) if reflect else None
    mesh_t = (mesh.elem2faces, normals, mesh.coords, mesh.elem2verts)
    kernels.use_kernel("trace3d", dest, *(t for t in (*mesh_t, ids) if t is not None))
    dev = dest.device
    elem = torch.empty(n, dtype=torch.int32, device=dev)
    act = torch.empty(n, dtype=torch.bool, device=dev)
    stats = torch.zeros(3, dtype=torch.int32, device=dev)
    new_dest = torch.empty_like(dest) if (reflect or recover == "project") else None
    rec = None
    if record_exit:
        rec = (torch.empty(n, dtype=torch.int32, device=dev),
               torch.empty(n, dtype=torch.int32, device=dev), torch.empty_like(dest))
    it0 = 0 if grid is None else 1
    oh = (ctypes.c_float * 6)(*((0.0,) * 6 if grid is None
                                else (*grid.origin, *grid.inv_h)))
    nxyz = (1, 1, 1) if grid is None else (grid.nx, grid.ny, grid.nz)
    P = ctypes.c_void_p

    def ptr(t):
        return P(None if t is None else t.data_ptr())

    if n:
        err = _build.lib().pp_trace_3d(
            ptr(orig), ptr(dest), ptr(elem_start), ptr(active), ptr(table),
            ptr(mesh.walk_geom), *(ptr(t) for t in mesh_t), E, ptr(ids), oh, *nxyz,
            max_iters, it0, CORES[core], reflect, int(record_exit),
            int(recover == "project"), ptr(elem), ptr(act), ptr(new_dest),
            *(ptr(t) for t in (rec or (None,) * 3)), ptr(stats), n,
            P(kernels.stream_handle()))
        _build.check(err, "trace3d")
        kernels.LAUNCHES["trace3d"] += 1
    out = dest if new_dest is None else new_dest
    extra = {}
    if record_exit:
        extra = dict(exit_side=rec[0], num_hits=rec[1], hit_c=tuple(rec[2].unbind(1)))
    if recover == "project":
        extra["num_recovered"] = stats[2]
    return SearchResult(elem, tuple(out.unbind(1)), stats[0] + it0, stats[1] == 0,
                        act, **extra)


# ---------------------------------------------------------------------------
# triangles, every other case: plain PyTorch version of kernel M2
# ---------------------------------------------------------------------------

def _core_2d(g, dest, orig, need_t):
    """(inside, exit k, t) of ``_row_core_2d`` on walk_geom rows: the side
    opposite the most negative destination weight; t = w_o / (w_o - w_min)
    of that weight along orig -> dest."""
    dx, dy = dest
    l1, l2, w0, inside = bary_inside(*g[:, 0:6].unbind(1), dx, dy)
    wmin = torch.minimum(w0, l1)
    k = torch.where(w0 <= l1, 0, 1)
    k = torch.where(l2 < wmin, 2, k)
    t = None
    if need_t:
        wmin = torch.minimum(wmin, l2)
        ox, oy = orig
        l1o = g[:, 0] * ox + g[:, 1] * oy + g[:, 2]
        l2o = g[:, 3] * ox + g[:, 4] * oy + g[:, 5]
        w0o = 1.0 - l1o - l2o
        wo = torch.where(k == 0, w0o, torch.where(k == 1, l1o, l2o))
        den = wo - wmin
        t = wo / torch.where(den == 0, torch.ones_like(den), den)
    return inside, k, t


def recover_project_2d(mesh: Mesh2D, e: torch.Tensor, dest):
    """``_make_recover`` (2D): (ok, q) for loop-limit survivors in triangles
    ``e`` with destinations ``dest`` (per-component): q is the triangle's
    closest point to the destination (``closest_point_on_triangle`` at
    z = 0), nudged toward the centroid; ok where that distance is within
    RECOVER_REL_TOL of the triangle's longest edge."""
    ev = mesh.elem2verts[torch.clamp(e, min=0).long()].long()
    vs = [mesh.coords[ev[:, i]] for i in range(3)]                # (w, 2) each
    zero = torch.zeros_like(dest[0])
    p3 = torch.stack([dest[0], dest[1], zero], dim=1)
    q3 = closest_point_on_triangle(p3, *(torch.cat([v, zero[:, None]], 1) for v in vs))
    d2 = _sq3(q3.unbind(1), p3.unbind(1))
    scale2 = torch.zeros_like(zero)
    for i in range(3):
        for j in range(i + 1, 3):
            d = vs[i] - vs[j]
            scale2 = torch.maximum(scale2, d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1])
    ok = d2 <= (RECOVER_REL_TOL ** 2) * scale2
    three = torch.tensor(3.0, dtype=zero.dtype, device=zero.device)
    cent = [((vs[0][:, c] + vs[1][:, c]) + vs[2][:, c]) / three for c in range(2)]
    return ok, tuple(q3[:, c] + (cent[c] - q3[:, c]) * RECOVER_NUDGE for c in range(2))


def trace_2d_plain(mesh: Mesh2D, orig: torch.Tensor, dest: torch.Tensor,
                   elem_start, active, max_iters: int,
                   boundary_handler=remove_on_exit, record_exit: bool = False,
                   recover: str = "off", grid: Optional[Grid] = None) -> SearchResult:
    """Plain PyTorch version of kernel M2 (a batch walk over the unfinished
    walkers, :func:`trace_2d`'s semantics), with any handler of the
    protocol."""
    _check_walk_options(boundary_handler, recover)
    n_elems = mesh.walk_geom.shape[0]
    needs_hit = _needs_hit(boundary_handler, record_exit)
    d = [c.clone() for c in dest.unbind(1)]
    o = [c.clone() for c in orig.unbind(1)]
    start = torch.clamp(elem_start.to(torch.int32), 0, n_elems - 1)
    elem = torch.where(active, start, INVALID)
    fbg = torch.full_like(elem, -2)
    done = ~active
    it0 = 0
    if grid is not None:
        it0 = 1
        e0, inside = _peel(grid, *d)
        elem = torch.where(active, e0, INVALID)
        fbg = torch.where(active & ~inside, start, -2)
        done = ~active | inside
    side_rec = torch.full_like(elem, INVALID)
    nhits = torch.zeros_like(elem)
    hit_rec = [c.clone() for c in d]
    idx = torch.nonzero(~done).flatten()
    steps = 0
    for _ in range(max(max_iters - it0, 0)):
        if idx.numel() == 0:
            break
        steps += 1
        e, f = elem[idx], fbg[idx]
        dw, ow = tuple(c[idx] for c in d), tuple(c[idx] for c in o)
        g = mesh.walk_geom[e.long()]                             # (w, 12)
        inside, k, t = _core_2d(g, dw, ow, needs_hit)
        nxt = torch.gather(g[:, 6:9], 1, k[:, None])[:, 0].to(torch.int32)
        side = torch.gather(g[:, 9:12], 1, k[:, None])[:, 0].to(torch.int32)
        exposed = nxt == INVALID
        retry = ~inside & exposed & (f >= 0)
        real = ~inside & exposed & (f < 0)
        hit = None
        if needs_hit:
            tc = torch.clamp(t, 0.0, 1.0)
            hit = tuple(oc + tc * (dc - oc) for oc, dc in zip(ow, dw))
        bres = boundary_handler(BoundaryCtx(e, side, ow, dw, mesh, hit, t))
        elem[idx] = torch.where(inside, e, torch.where(
            retry, f, torch.where(exposed, bres.elem.to(e.dtype), nxt)))
        fbg[idx] = torch.where((f >= 0) & ~retry & ~inside, f, -2)
        if bres.dest is not None:
            for c in range(2):
                d[c][idx] = torch.where(real, bres.dest[c], dw[c])
                o[c][idx] = torch.where(real, hit[c], ow[c])
        if record_exit:
            side_rec[idx] = torch.where(real, side, side_rec[idx])
            nhits[idx] += real.to(nhits.dtype)
            for c in range(2):
                hit_rec[c][idx] = torch.where(real, hit[c], hit_rec[c][idx])
        idx = idx[~(inside | (real & bres.done))]
    dev = elem.device
    num_rec = None
    if recover == "project":
        n_ok = 0
        if idx.numel():
            e = elem[idx]
            ok, q = recover_project_2d(mesh, e, tuple(c[idx] for c in d))
            ok = ok & (e >= 0)
            for c in range(2):
                d[c][idx] = torch.where(ok, q[c], d[c][idx])
            n_ok = int(ok.sum())
            idx = idx[~ok]
        num_rec = torch.tensor(n_ok, dtype=torch.int32, device=dev)
    elem[idx] = INVALID
    rec = {}
    if record_exit:
        rec = dict(exit_side=side_rec, hit_c=tuple(hit_rec), num_hits=nhits)
    return SearchResult(
        elem, tuple(d), torch.tensor(it0 + steps, dtype=torch.int32, device=dev),
        torch.tensor(idx.numel() == 0, device=dev), elem >= 0,
        num_recovered=num_rec, **rec)


# ---------------------------------------------------------------------------
# kernel M2 wrapper
# ---------------------------------------------------------------------------

def trace_2d(mesh: Mesh2D, orig: Optional[torch.Tensor], dest: torch.Tensor,
             elem_start, active, max_iters: int, boundary_handler=remove_on_exit,
             record_exit: bool = False, recover: str = "off",
             grid: Optional[Grid] = None) -> SearchResult:
    """The triangle walk of every active particle from ``elem_start``
    (clamped; or, with ``grid``, the peel of the destination cell's two
    candidate rows, counted as one iteration, then a guess walk that retries
    once from the clamped start where it meets the boundary) to the
    triangle containing its (N, 2) ``dest``, along the segment from
    ``orig`` (N, 2; unused, and may be None, without a hit point).

    ``boundary_handler``: :func:`remove_on_exit` or :func:`reflect_on_exit_2d`
    (mirror the destination, walk on from the crossing point).
    ``record_exit``: the exit edge, crossing point and count of real
    boundary hits.  ``recover="project"``: loop-limit survivors whose
    destination lies at the closure of their triangle are accepted there,
    at the projected point.  ``grid``: a cartesian :class:`LocatorGrid2D`
    (the kernel computes each cell) or a :class:`BandGrid2D` (kernel B
    computes the cells first), both with cell rows.

    Kernel M2 (``kernels/csrc/trace2d.cu``) on CUDA tensors, which knows the
    two handlers above (reflect through the mesh's :func:`reflect_tangents`)
    and raises NotImplementedError for any other; :func:`trace_2d_plain` on
    CPU tensors.  The result's (N, 2) ``dest`` and ``hit`` are then the
    kernel's own outputs, not copies."""
    _check_walk_options(boundary_handler, recover)
    if orig is None:
        if _needs_hit(boundary_handler, record_exit):
            raise ValueError("trace_2d: this walk needs the segment origins")
        orig = dest
    if grid is not None and grid.cell_rows is None:
        raise ValueError("trace_2d: the locator grid has no cell rows")
    if not kernels.use_kernel("trace2d", dest, orig, elem_start, active,
                              mesh.walk_geom):
        return trace_2d_plain(mesh, orig, dest, elem_start, active, max_iters,
                              boundary_handler, record_exit, recover, grid)
    if boundary_handler is remove_on_exit:
        reflect = 0
    elif boundary_handler is reflect_on_exit_2d:
        reflect = 1
    else:
        raise NotImplementedError("kernel M2 knows remove_on_exit and "
                                  "reflect_on_exit_2d; other handlers run on the CPU")
    n, E = dest.shape[0], mesh.nelems
    if (dest.dtype != torch.float32 or dest.shape != (n, 2) or orig.shape != (n, 2)
            or orig.dtype != torch.float32 or elem_start.dtype != torch.int32
            or active.dtype != torch.bool or elem_start.shape != (n,)
            or active.shape != (n,)):
        raise ValueError("trace_2d: (N, 2) f32 orig and dest, i32 elem_start and "
                         "bool active expected")
    if n >= 1 << 30:
        raise ValueError("trace_2d: the kernel takes fewer than 2^30 particles")
    if mesh.walk_geom.data_ptr() % 16 or (grid is not None
                                          and grid.cell_rows.data_ptr() % 8):
        raise ValueError("trace_2d: walk_geom must be 16-byte and cell_rows "
                         "8-byte aligned")
    tangents = reflect_tangents(mesh) if reflect else None
    cells = None
    ox, oy, ihx, ihy, nx, ny = 0.0, 0.0, 0.0, 0.0, 1, 1
    if isinstance(grid, BandGrid2D):
        cells = band_cell_of(grid, dest[:, 0].contiguous(), dest[:, 1].contiguous())
    elif grid is not None:
        (ox, oy), (ihx, ihy), nx, ny = grid.origin, grid.inv_h, grid.nx, grid.ny
    rows = None if grid is None else grid.cell_rows
    kernels.use_kernel("trace2d", dest, *(t for t in (
        tangents, mesh.coords, mesh.elem2verts, rows, cells) if t is not None))
    dev = dest.device
    elem = torch.empty(n, dtype=torch.int32, device=dev)
    act = torch.empty(n, dtype=torch.bool, device=dev)
    stats = torch.zeros(3, dtype=torch.int32, device=dev)
    new_dest = torch.empty_like(dest) if (reflect or recover == "project") else None
    rec = None
    if record_exit:
        rec = (torch.empty(n, dtype=torch.int32, device=dev),
               torch.empty(n, dtype=torch.int32, device=dev), torch.empty_like(dest))
    it0 = 0 if grid is None else 1
    P = ctypes.c_void_p

    def ptr(t):
        return P(None if t is None else t.data_ptr())

    if n:
        err = _build.lib().pp_trace_2d(
            ptr(orig), ptr(dest), ptr(elem_start), ptr(active), ptr(mesh.walk_geom), E,
            ptr(tangents), ptr(mesh.coords), ptr(mesh.elem2verts), ptr(rows),
            ptr(cells), ox, oy, ihx, ihy, nx, ny, max_iters, it0, reflect,
            int(record_exit), int(recover == "project"), ptr(elem), ptr(act),
            ptr(new_dest), *(ptr(t) for t in (rec or (None,) * 3)), ptr(stats), n,
            P(kernels.stream_handle()))
        _build.check(err, "trace2d")
        kernels.LAUNCHES["trace2d"] += 1
    out = dest if new_dest is None else new_dest
    extra = {}
    if record_exit:
        extra = dict(exit_side=rec[0], num_hits=rec[1], hit_c=tuple(rec[2].unbind(1)))
    if recover == "project":
        extra["num_recovered"] = stats[2]
    return SearchResult(elem, tuple(out.unbind(1)), stats[0] + it0, stats[1] == 0,
                        act, **extra)


# ---------------------------------------------------------------------------
# public API, tets
# ---------------------------------------------------------------------------

def _fast_case(method: str, boundary_handler, record_exit: bool, recover: str) -> bool:
    """The case kernel L3 runs: the BCC core, remove-on-exit, no exit record
    and no recovery."""
    return (core_of(method) == "bcc" and boundary_handler is remove_on_exit
            and not record_exit and recover == "off")


def search_mesh_3d(mesh: Mesh3D, x_orig, x_tgt, elem_init: torch.Tensor,
                   active: torch.Tensor, max_iters: int = 200,
                   boundary_handler=remove_on_exit, method: str = "bcc",
                   record_exit: bool = False, widths=None,
                   recover: str = "off") -> SearchResult:
    """Tet-mesh walk of every active particle from ``elem_init`` (clamped
    into range) to the tet containing ``x_tgt``; inactive particles get
    INVALID; walkers left at the iteration limit are deleted (or, with
    ``recover="project"``, recovered where they are stranded at their
    tet's closure).  The BCC core with :func:`remove_on_exit` and neither
    ``record_exit`` nor ``recover`` runs kernel L3's plain walk; every other
    case :func:`trace_3d` (kernel M).  ``widths`` (the TPU compaction
    pyramid) is accepted and ignored."""
    _check_walk_options(boundary_handler, recover)
    dest = _rows_of(x_tgt)
    if _fast_case(method, boundary_handler, record_exit, recover):
        elem, act, iters, all_found, _ = walk_locate_3d(
            mesh.walk_geom, dest, elem_init.to(torch.int32), active, max_iters)
        return SearchResult(elem, dest.unbind(1), iters, all_found, act)
    orig = None if x_orig is None else _rows_of(x_orig)
    return trace_3d(mesh, orig, dest, elem_init.to(torch.int32), active, max_iters,
                    method, boundary_handler, record_exit, recover)


def search_mesh_3d_accel(mesh: Mesh3D, grid: LocatorGrid3D, x_orig, x_tgt,
                         elem_prev: torch.Tensor, active: torch.Tensor,
                         max_iters: int = 200,
                         boundary_handler=remove_on_exit, method: str = "bcc",
                         record_exit: bool = False, widths=None,
                         recover: str = "off") -> SearchResult:
    """Grid-accelerated tet search through the cell-candidate peel: results
    equal :func:`search_mesh_3d`'s, with the peel counted as one iteration
    and a guess walk that retries once from the clamped ``elem_prev`` where
    it meets the boundary (a guess walk's boundary hit is never a real
    hit).  Kernel L3 in the fast case, kernel M in every other."""
    _check_walk_options(boundary_handler, recover)
    if grid.cell_rows is None:
        raise NotImplementedError("only the cell-rows peel is ported")
    dest = _rows_of(x_tgt)
    if _fast_case(method, boundary_handler, record_exit, recover):
        elem, act, iters, all_found, _ = walk_locate_3d(
            mesh.walk_geom, dest, elem_prev.to(torch.int32), active, max_iters,
            grid=grid)
        return SearchResult(elem, dest.unbind(1), iters, all_found, act)
    orig = None if x_orig is None else _rows_of(x_orig)
    return trace_3d(mesh, orig, dest, elem_prev.to(torch.int32), active, max_iters,
                    method, boundary_handler, record_exit, recover, grid=grid)


def check_parents_plain(mesh, x_orig, elem_init: torch.Tensor, active: torch.Tensor,
                        mode: str = "repair", max_iters: int = 32, locator=None):
    """Plain PyTorch version of :func:`check_initial_parents` (kernel J and
    the repair walk): the containment test on gathered ``walk_geom`` rows,
    then the repair as the plain walk of the bad particles in place
    (:func:`walk_locate_into_plain`, :func:`walk_locate_3d_into_plain`)."""
    orig = _components(x_orig)
    e_raw = elem_init.to(torch.int32)
    in_table = (e_raw >= 0) & (e_raw < mesh.nelems)
    e_safe = torch.clamp(e_raw, 0, mesh.nelems - 1)
    g = row_gather_plain(mesh.walk_geom, e_safe)
    if mesh.dim == 2:
        inside = bary_inside(*g[:, 0:6].unbind(1), *orig)[3]
    else:
        inside = bary_inside_3d(g[:, 0:12].unbind(1), *orig)[4]
    bad = active & (~inside | ~in_table)
    elem = torch.where(active & ~bad, e_safe, INVALID)
    stats = torch.zeros(4, dtype=torch.int32, device=e_raw.device)
    stats[3] = bad.sum()
    if mode == "delete":
        return elem, stats[3], stats[2]
    start = e_safe
    if locator is not None:
        start = locator.cell_elem[locator.cell_of(*orig).long()]
    walk = walk_locate_into_plain if mesh.dim == 2 else walk_locate_3d_into_plain
    walk(mesh.walk_geom, *orig, start.to(torch.int32), bad, max_iters, elem, stats)
    return elem, stats[3], stats[2]


def check_parents(mesh, x_orig, elem_init: torch.Tensor, active: torch.Tensor,
                  mask: bool):
    """Kernel J (``kernels/csrc/parents.cu``) on CUDA tensors: the parent
    check in one pass, reading the origin where it lies (an (N, dim)
    tensor or a tuple of columns of any stride) and each parent's affine
    rows (2D: :func:`parent_rows`, one 32-byte sector a row; 3D:
    ``walk_geom``'s 64-byte rows).  Returns (elem, bad,
    stats): ``elem`` i32 (the clamped parent where active and good, else
    INVALID), ``bad`` the bool mask of bad parents (None unless ``mask``),
    ``stats`` four i32 counters, zeroed by the launch, with ``stats[3]``
    the number of bad parents and ``stats[0:3]`` free for the repair walk
    (:func:`walk_locate_into`, :func:`walk_locate_3d_into`)."""
    e = elem_init.to(torch.int32)
    if not kernels.use_kernel("check_parents", mesh.walk_geom, e, active):
        raise ValueError("check_parents: the kernel takes CUDA tensors; "
                         "check_parents_plain is its plain version")
    geom = parent_rows(mesh) if mesh.dim == 2 else mesh.walk_geom
    n, dim = e.shape[0], mesh.dim
    dev = e.device
    cols = _columns(x_orig)
    if len(cols) != dim or active.dtype != torch.bool or active.shape != (n,):
        raise ValueError(f"check_parents: {dim} origin components and a bool "
                         f"({n},) active mask expected")
    ptrs = [_column(c, n, dev, "check_parents") for c in cols]
    if geom.dtype != torch.float32 or geom.data_ptr() % 16:
        raise ValueError("check_parents: f32 rows, 16-byte aligned, expected")
    elem = torch.empty(n, dtype=torch.int32, device=dev)
    bad = torch.empty(n, dtype=torch.bool, device=dev) if mask else None
    stats = torch.empty(4, dtype=torch.int32, device=dev)
    P = ctypes.c_void_p
    origin = (P * 3)(*(p for p, _ in ptrs), *([None] * (3 - dim)))
    strides = (ctypes.c_longlong * 3)(*(st for _, st in ptrs), *([0] * (3 - dim)))
    err = _build.lib().pp_check_parents(
        dim, P(e.data_ptr()), P(active.data_ptr()), origin, strides,
        P(geom.data_ptr()), geom.shape[1], geom.shape[0], P(elem.data_ptr()),
        P(None if bad is None else bad.data_ptr()), P(stats.data_ptr()), n,
        P(kernels.stream_handle()))
    _build.check(err, "check_parents")
    kernels.LAUNCHES["check_parents"] += 1
    return elem, bad, stats


def check_initial_parents(mesh, x_orig, elem_init: torch.Tensor, active: torch.Tensor,
                          mode: str = "repair", max_iters: int = 32, locator=None):
    """Validate, and with ``mode="repair"`` repair, the claimed parents on
    walk entry (``check_initial_parents``, adjacency.tpp:72-151): a particle
    whose origin its parent does not contain (BCC test with the walk's
    tolerance), or whose parent id is out of range, is bad.  "delete" gives
    bad particles INVALID; "repair" walks each from its clamped parent (or
    ``locator``'s guess of its origin) to its origin and deletes only those
    that walk off the mesh.  Returns (elem i32, num_bad, num_repaired), with
    INVALID where inactive or deleted; the counts stay on the device.

    On CUDA tensors: kernel J, then the plain walk of J's bad particles in
    place into J's output, kernel L's in 2D and L3's in 3D (a memset, J and
    the walk; no other launch without a locator).  On CPU tensors:
    :func:`check_parents_plain`."""
    if mode not in ("delete", "repair"):
        raise ValueError(f"unknown mode {mode!r}; expected 'delete' or 'repair'")
    if not kernels.use_kernel("check_parents", mesh.walk_geom, elem_init, active):
        return check_parents_plain(mesh, x_orig, elem_init, active, mode, max_iters,
                                   locator)
    elem, bad, stats = check_parents(mesh, x_orig, elem_init, active, mode == "repair")
    if mode == "delete":
        return elem, stats[3], stats[2]
    start = elem_init.to(torch.int32)                  # the walks clamp it
    if locator is not None:
        start = locator.cell_elem[locator.cell_of(*_columns(x_orig)).long()]
    walk = walk_locate_into if mesh.dim == 2 else walk_locate_3d_into
    walk(mesh.walk_geom, *_columns(x_orig), start, bad, max_iters, elem, stats)
    return elem, stats[3], stats[2]


def trace_particle_through_mesh(mesh, x_orig, x_tgt, elem_init: torch.Tensor,
                                active: torch.Tensor, max_iters: int = 200,
                                boundary_handler=remove_on_exit,
                                record_exit: bool = False,
                                validate_parents: str = "off",
                                recover: str = "off") -> SearchResult:
    """The unified 2D/3D driver (``trace_particle_through_mesh``,
    adjacency.tpp:460-615): with ``validate_parents`` "delete" or "repair",
    :func:`check_initial_parents` first; then :func:`search_mesh_2d` or
    :func:`search_mesh_3d`, with every handler, exit record and recovery
    mode they take."""
    if validate_parents != "off":
        elem_init, _, _ = check_initial_parents(mesh, x_orig, elem_init, active,
                                                mode=validate_parents)
        active = active & (elem_init >= 0)
    if mesh.dim == 2:
        return search_mesh_2d(mesh, x_orig, x_tgt, elem_init, active, max_iters,
                              boundary_handler, record_exit, recover=recover)
    return search_mesh_3d(mesh, x_orig, x_tgt, elem_init, active, max_iters,
                          boundary_handler, record_exit=record_exit, recover=recover)
