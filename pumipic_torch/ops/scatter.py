"""Gyro-ring charge scatter (port of the gyro-ring parts of
``pumipic_tpu.ops.scatter``; reference ``test/gyroScatter.hpp``).

- ``accumulateToRings``: every particle deposits into the two gyro rings
  bracketing its gyro radius at each vertex of its element.  With the
  reference's uniform placeholder radius the ring pair is the same for
  every particle, so particles are counted per element (kernel H); with a
  per-particle radius they are counted per (element, ring) key (kernel H's
  key mode).  Either count is then expanded to the vertices (kernel D,
  pass 1).
- ``scatterToMappedVerts``: each (vertex, ring, point) slot's value / P goes
  to the three vertices of the element containing the ring point, through
  the static gyro-average map (kernel D, pass 2).

Every deposit is a sum owned by one output and taken in a fixed order, so
the fields are deterministic; on the main path they are integer counts and
multiples of 1/P, exact in f32.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from pumipic_torch import kernels
from pumipic_torch.kernels import _build
from pumipic_torch.mesh.core import Mesh2D
from pumipic_torch.utils.device import resolve_device


# ---------------------------------------------------------------------------
# kernel H: per-element histogram
# ---------------------------------------------------------------------------

def _ring_width(gyro_rmax: float, num_rings: int) -> float:
    """f32(rmax / R), as a Python float."""
    return float(np.float32(gyro_rmax / num_rings))


def ring_of_radius(ptcl_radius: torch.Tensor, gyro_rmax: float,
                   num_rings: int) -> torch.Tensor:
    """The lower of the two rings bracketing each radius, as f32:
    clip(floor(rg / f32(rmax / R)) - 1, 0, R - 2), with an IEEE division
    (a 0-d tensor divisor: torch's CUDA division by a Python scalar
    multiplies by its reciprocal instead)."""
    rw = ptcl_radius.new_full((), _ring_width(gyro_rmax, num_rings))
    return torch.clamp(torch.floor(ptcl_radius / rw) - 1.0, 0.0,
                       num_rings - 2.0)


def histogram_plain(elem: torch.Tensor, active: torch.Tensor, num_keys: int,
                    ptcl_radius=None, num_rings: int = 1,
                    gyro_rmax: float = 0.0) -> torch.Tensor:
    """Plain version of kernel H: (num_keys,) int32 counts of key =
    active ? elem : num_keys, keys outside [0, num_keys) dropped.  With
    ``ptcl_radius`` (key mode, ``num_keys`` elements): (num_keys·R,)
    counts of the two keys elem·R + rd and elem·R + rd + 1 per active
    particle, rd from :func:`ring_of_radius` (a NaN ring deposits
    nothing)."""
    if ptcl_radius is None:
        key = torch.where(active, elem.to(torch.int64), num_keys)
        key = torch.where((key >= 0) & (key < num_keys), key, num_keys)
        return torch.bincount(key, minlength=num_keys + 1)[:num_keys].to(torch.int32)
    R, ER = num_rings, num_keys * num_rings
    rdf = ring_of_radius(ptcl_radius, gyro_rmax, R)
    ok = active & (elem >= 0) & (elem < num_keys) & ~torch.isnan(rdf)
    base = elem.to(torch.int64) * R + torch.where(ok, rdf, 0.0).to(torch.int64)
    keys = torch.cat([torch.where(ok, base, ER), torch.where(ok, base + 1, ER)])
    return torch.bincount(keys, minlength=ER + 1)[:ER].to(torch.int32)


def histogram(elem: torch.Tensor, active: torch.Tensor, num_keys: int,
              ptcl_radius=None, num_rings: int = 1,
              gyro_rmax: float = 0.0) -> torch.Tensor:
    """Particles per element (active particles only), or with
    ``ptcl_radius`` per (element, ring) key (see :func:`histogram_plain`).
    Kernel H on CUDA tensors (at any alignment: its launcher finds where
    the 16-byte loads may start), :func:`histogram_plain` on CPU
    tensors."""
    tensors = (elem, active) + (() if ptcl_radius is None else (ptcl_radius,))
    if not kernels.use_kernel("histogram", *tensors):
        return histogram_plain(elem, active, num_keys, ptcl_radius,
                               num_rings, gyro_rmax)
    if elem.dtype != torch.int32 or active.dtype != torch.bool:
        raise ValueError("histogram: i32 elem and bool active expected")
    P = ctypes.c_void_p
    n = elem.shape[0]
    if ptcl_radius is None:
        counts = torch.zeros(num_keys, dtype=torch.int32, device=elem.device)
        if n == 0:
            return counts
        err = _build.lib().pp_histogram(
            P(elem.data_ptr()), P(active.data_ptr()), num_keys,
            P(counts.data_ptr()), n, P(kernels.stream_handle()))
    else:
        if ptcl_radius.dtype != torch.float32 or ptcl_radius.shape != elem.shape:
            raise ValueError("histogram: f32 radius of elem's shape expected")
        if num_rings < 2 or num_keys * num_rings >= 1 << 31:
            raise ValueError("histogram: key mode needs R >= 2 and E·R < 2^31")
        counts = torch.zeros(num_keys * num_rings, dtype=torch.int32,
                             device=elem.device)
        if n == 0:
            return counts
        err = _build.lib().pp_histogram_rings(
            P(elem.data_ptr()), P(active.data_ptr()), P(ptcl_radius.data_ptr()),
            _ring_width(gyro_rmax, num_rings), num_keys, num_rings,
            P(counts.data_ptr()), n, P(kernels.stream_handle()))
    _build.check(err, "histogram")
    kernels.LAUNCHES["histogram"] += 1
    return counts


# ---------------------------------------------------------------------------
# kernel W: the GITR-style wall tally (H's weighted mode)
# ---------------------------------------------------------------------------

def wall_tally_plain(side: torch.Tensor, mask: torch.Tensor, weight, n_faces: int
                     ) -> torch.Tensor:
    """Plain version of kernel W: (n_faces,) int32 sums of ``weight`` (1
    where None) over the particles with ``mask`` whose ``side`` lies in
    [0, n_faces); a weight <= 0 adds nothing."""
    w = torch.ones_like(side) if weight is None else weight.to(torch.int32)
    ok = mask & (side >= 0) & (side < n_faces) & (w > 0)
    key = torch.where(ok, side.to(torch.int64), n_faces)
    counts = torch.zeros(n_faces + 1, dtype=torch.int32, device=side.device)
    return counts.index_add_(0, key, torch.where(ok, w, 0))[:n_faces]


def wall_tally(side: torch.Tensor, mask: torch.Tensor, weight, n_faces: int
               ) -> torch.Tensor:
    """The wall flux of one step, per boundary face: each particle with
    ``mask`` adds its int32 ``weight`` (1 where None) to the count of face
    ``side`` (i32; sides outside [0, n_faces) add nothing).  The GITR-style
    app counts its lost particles on their exit faces (absorb) or its
    reflections, ``num_hits``, on the last face hit (reflect).  Integer
    adds, so the result is exact in any order.  Kernel W (H's weighted mode,
    ``kernels/csrc/histogram.cu``) on CUDA tensors, :func:`wall_tally_plain`
    on CPU tensors."""
    tensors = (side, mask) + (() if weight is None else (weight,))
    if not kernels.use_kernel("wall_tally", *tensors):
        return wall_tally_plain(side, mask, weight, n_faces)
    n = side.shape[0]
    if (side.dtype != torch.int32 or mask.dtype != torch.bool or mask.shape != (n,)
            or (weight is not None and (weight.dtype != torch.int32
                                        or weight.shape != (n,)))):
        raise ValueError("wall_tally: i32 sides, bool mask and i32 weights of one "
                         "length expected")
    counts = torch.zeros(n_faces, dtype=torch.int32, device=side.device)
    if n == 0:
        return counts
    P = ctypes.c_void_p
    err = _build.lib().pp_wall_tally(
        P(side.data_ptr()), P(mask.data_ptr()),
        P(None if weight is None else weight.data_ptr()), n_faces,
        P(counts.data_ptr()), n, P(kernels.stream_handle()))
    _build.check(err, "wall_tally")
    kernels.LAUNCHES["wall_tally"] += 1
    return counts


# ---------------------------------------------------------------------------
# kernel D: ring expansion and mapped scatter
# ---------------------------------------------------------------------------

def ring_pair(num_rings: int):
    """The two rings the uniform placeholder radius 1.125·ring-width
    brackets (gyroScatter.hpp:185); both are ring 0 when R == 1, which
    deposits each particle once."""
    if num_rings == 1:
        return 0, 0
    rd = min(max(int(1.125) - 1, 0), num_rings - 2)
    return rd, rd + 1


@dataclass(frozen=True)
class GyroMap:
    """The gyro-average map and its transpose.  ``flat`` is the reference's
    (V·R·P·3,) vertex ids laid out [vertex][ring][point][3], -1 where the
    ring point is outside the domain.  ``offsets``/``src``: for each output
    vertex u, the (v·R + r) ring slots of the entries that name u, in
    increasing entry order (CSR, built once on the host)."""

    flat: torch.Tensor
    offsets: torch.Tensor
    src: torch.Tensor

    @staticmethod
    def from_flat(flat, num_verts: int, num_rings: int, points_per_ring: int,
                  device=None) -> "GyroMap":
        device = resolve_device(device)
        m = (flat.cpu().numpy() if isinstance(flat, torch.Tensor)
             else np.asarray(flat)).astype(np.int64)
        if m.shape != (num_verts * num_rings * points_per_ring * 3,):
            raise ValueError(f"gyro map shape {m.shape} does not match "
                             f"V={num_verts} R={num_rings} P={points_per_ring}")
        valid = m >= 0
        u = m[valid]
        slot = (np.arange(m.size) // (points_per_ring * 3))[valid]
        order = np.argsort(u, kind="stable")
        offsets = np.concatenate(
            [[0], np.cumsum(np.bincount(u, minlength=num_verts))])
        return GyroMap(
            torch.as_tensor(m.astype(np.int32), device=device),
            torch.as_tensor(offsets.astype(np.int32), device=device),
            torch.as_tensor(slot[order].astype(np.int32), device=device))


def ring_accum_plain(counts: torch.Tensor, mesh: Mesh2D,
                     num_rings: int) -> torch.Tensor:
    """Plain version of kernel D pass 1: (V, R) ring sums of the counts over
    each vertex's elements (index_add_, as the JAX package's segment_sum
    over [element][vertex][ring] keys).  ``counts`` is (E,) per element,
    deposited into the uniform radius's ring pair, or (E, R) per
    (element, ring)."""
    R = num_rings
    E = mesh.nelems
    cf = counts.to(torch.float32)
    if cf.dim() == 2:
        elem_ring = cf
    else:
        rd, ru = ring_pair(R)
        elem_ring = torch.zeros(E, R, dtype=torch.float32, device=cf.device)
        elem_ring[:, rd] += cf
        if ru != rd:
            elem_ring[:, ru] += cf
    keys = (mesh.elem2verts.to(torch.int64)[:, :, None] * R
            + torch.arange(R, device=cf.device)[None, None, :])   # (E, 3, R)
    vals = elem_ring[:, None, :].expand(E, 3, R)
    out = torch.zeros(mesh.nverts * R, dtype=torch.float32, device=cf.device)
    out.index_add_(0, keys.reshape(-1), vals.reshape(-1))
    return out.reshape(mesh.nverts, R)


def deposit_rings(counts: torch.Tensor, mesh: Mesh2D,
                  num_rings: int) -> torch.Tensor:
    """(V, R) ring accumulation from (E,) per-element or (E, R)
    per-(element, ring) counts.  Kernel D pass 1 on CUDA tensors,
    :func:`ring_accum_plain` on CPU tensors."""
    args = (counts, mesh.vert2elem_offsets, mesh.vert2elem_vals)
    if not kernels.use_kernel("deposit", *args):
        return ring_accum_plain(counts, mesh, num_rings)
    if counts.dtype != torch.int32 or counts.shape not in (
            (mesh.nelems,), (mesh.nelems, num_rings)):
        raise ValueError("deposit: (E,) or (E, R) i32 counts expected")
    out = torch.empty(mesh.nverts, num_rings, dtype=torch.float32,
                      device=counts.device)
    P = ctypes.c_void_p
    if counts.dim() == 2:
        err = _build.lib().pp_deposit_rings_er(
            *(P(t.data_ptr()) for t in args), mesh.nverts, num_rings,
            P(out.data_ptr()), P(kernels.stream_handle()))
    else:
        rd, ru = ring_pair(num_rings)
        err = _build.lib().pp_deposit_rings(
            *(P(t.data_ptr()) for t in args), mesh.nverts, num_rings, rd, ru,
            P(out.data_ptr()), P(kernels.stream_handle()))
    _build.check(err, "deposit")
    kernels.LAUNCHES["deposit"] += 1
    return out


def mapped_plain(ring_accum: torch.Tensor, gyro_map: GyroMap, num_verts: int,
                 num_rings: int, points_per_ring: int) -> torch.Tensor:
    """Plain version of kernel D pass 2 (index_add_ over the flat map, as the
    JAX package's segment_sum)."""
    V, R, P = num_verts, num_rings, points_per_ring
    vals = ring_accum / ring_accum.new_full((), P)        # IEEE, as kernel D
    vals_exp = vals[:, :, None, None].expand(V, R, P, 3).reshape(-1)
    idx = gyro_map.flat.to(torch.int64)
    idx = torch.where(idx >= 0, idx, V)
    out = torch.zeros(V + 1, dtype=torch.float32, device=ring_accum.device)
    out.index_add_(0, idx, vals_exp)
    return out[:V]


def scatter_to_mapped_verts(ring_accum: torch.Tensor, gyro_map: GyroMap,
                            num_verts: int, num_rings: int,
                            points_per_ring: int) -> torch.Tensor:
    """Apply the gyro-average map: (V, R) ring accumulation -> (V,).  Kernel
    D pass 2 on CUDA tensors, :func:`mapped_plain` on CPU tensors.  The
    kernel adds each vertex's terms in its own fixed order (lanes, then a
    tree: ``deposit.cu``), so it equals the plain version where the terms
    and sums are exact (integer ring sums, P a power of 2, as on the main
    path) and may differ in the last bits where a term c/P rounds."""
    args = (ring_accum, gyro_map.offsets, gyro_map.src)
    if not kernels.use_kernel("deposit", *args):
        return mapped_plain(ring_accum, gyro_map, num_verts, num_rings,
                            points_per_ring)
    if ring_accum.dtype != torch.float32 or ring_accum.shape != (num_verts, num_rings):
        raise ValueError("deposit: (V, R) f32 ring_accum expected")
    out = torch.empty(num_verts, dtype=torch.float32, device=ring_accum.device)
    P = ctypes.c_void_p
    err = _build.lib().pp_deposit_mapped(
        *(P(t.data_ptr()) for t in args), num_verts, points_per_ring,
        P(out.data_ptr()), P(kernels.stream_handle()))
    _build.check(err, "deposit")
    kernels.LAUNCHES["deposit"] += 1
    return out


def accumulate_to_rings(elem: torch.Tensor, active: torch.Tensor, mesh: Mesh2D,
                        num_rings: int, gyro_rmax: float,
                        ptcl_radius=None) -> torch.Tensor:
    """Deposit particles into the two rings bracketing their gyro radius at
    each vertex of their element; returns (V, R) f32.  ``ptcl_radius``:
    per-particle radius ((N,) f32), or None for the reference's uniform
    placeholder 1.125·ring-width; with one ring every particle deposits
    once, whatever its radius.  Takes the mesh (for its vertex->element
    incidence) where the JAX function takes ``elem2verts`` and the vertex
    count."""
    if ptcl_radius is None or num_rings == 1:
        counts = histogram(elem, active, mesh.nelems)
    else:
        counts = histogram(elem, active, mesh.nelems, ptcl_radius, num_rings,
                           gyro_rmax).view(mesh.nelems, num_rings)
    return deposit_rings(counts, mesh, num_rings)
