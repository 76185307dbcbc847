"""Charge scatter and deposition (port of ``pumipic_tpu.ops.scatter``;
reference ``test/gyroScatter.hpp``).

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

The standard PIC charge deposit, :func:`scatter_to_verts_bcc` (each
particle's charge times its barycentric weights, to its parent's vertices),
and the weighted :func:`particles_per_element` run kernel V
(``kernels/csrc/vdeposit.cu``): a fixed-point sum with integer atomics,
so the result is the same on every run and independent of the order of
the adds (:func:`vertex_deposit_plain` says how).  Counts
(:func:`count_per_key`, :func:`count_per_key_matmul`, the unweighted
:func:`particles_per_element`) run kernel H.
"""
from __future__ import annotations

import ctypes
import math
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


def write_send_rows(field: torch.Tensor, send_rows) -> None:
    """Plain version of kernel D's epilogue: ``send_rows`` = (row_of (V,)
    int32, send (R, K) f32): ``send.view(-1)[row_of[u]] = field[u]`` where
    ``row_of[u] >= 0``; the other rows of ``send`` keep their values."""
    row_of, send = send_rows
    named = row_of >= 0
    send.view(-1)[row_of[named].long()] = field[named]


def scatter_to_mapped_verts(ring_accum: torch.Tensor, gyro_map: GyroMap,
                            num_verts: int, num_rings: int,
                            points_per_ring: int, send_rows=None) -> torch.Tensor:
    """Apply the gyro-average map: (V, R) ring accumulation -> (V,).  Kernel
    D pass 2 on CUDA tensors, :func:`mapped_plain` on CPU tensors.  The
    kernel adds each vertex's terms in its own fixed order (lanes, then a
    tree: ``deposit.cu``), so it equals the plain version where the terms
    and sums are exact (integer ring sums, P a power of 2, as on the main
    path) and may differ in the last bits where a term c/P rounds.
    ``send_rows`` (optional): (row_of (V,) int32, send (R, K) f32 contiguous)
    from :func:`pumipic_torch.parallel.reduce.sum_send_rows`; each vertex's
    value is also written to its row of ``send`` (the owner reduction's
    send rows, which kernel O's gather would otherwise gather), the other
    rows are left as they are."""
    args = (ring_accum, gyro_map.offsets, gyro_map.src)
    extra = () if send_rows is None else tuple(send_rows)
    if not kernels.use_kernel("deposit", *args, *extra):
        out = mapped_plain(ring_accum, gyro_map, num_verts, num_rings, points_per_ring)
        if send_rows is not None:
            write_send_rows(out, send_rows)
        return out
    if ring_accum.dtype != torch.float32 or ring_accum.shape != (num_verts, num_rings):
        raise ValueError("deposit: (V, R) f32 ring_accum expected")
    row_of, send = extra if extra else (None, None)
    if send_rows is not None and (
            row_of.dtype != torch.int32 or row_of.shape != (num_verts,)
            or send.dtype != torch.float32 or not send.is_contiguous()):
        raise ValueError("deposit: send rows need (V,) int32 rows and a contiguous f32 "
                         "buffer")
    out = torch.empty(num_verts, dtype=torch.float32, device=ring_accum.device)
    P = ctypes.c_void_p
    err = _build.lib().pp_deposit_mapped(
        *(P(t.data_ptr()) for t in args), num_verts, points_per_ring,
        P(out.data_ptr()), P(row_of.data_ptr() if row_of is not None else None),
        P(send.data_ptr() if send is not None else None), P(kernels.stream_handle()))
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


def gyro_scatter(elem: torch.Tensor, active: torch.Tensor, mesh: Mesh2D,
                 gyro_map: GyroMap, num_rings: int, points_per_ring: int,
                 gyro_rmax: float, send_rows=None) -> torch.Tensor:
    """Full gyroScatter (gyroScatter.hpp:169-232): ring accumulation, then
    the mapped scatter; returns the (V,) vertex field.  Takes the mesh and
    a :class:`GyroMap` where the JAX function takes ``elem2verts``, the
    flat map and the vertex count; ``send_rows``: as
    :func:`scatter_to_mapped_verts`'s."""
    ring = accumulate_to_rings(elem, active, mesh, num_rings, gyro_rmax)
    return scatter_to_mapped_verts(ring, gyro_map, mesh.nverts, num_rings,
                                   points_per_ring, send_rows)


# ---------------------------------------------------------------------------
# counts onto kernel H, under the JAX package's names
# ---------------------------------------------------------------------------

def count_per_key(key: torch.Tensor, num_keys: int) -> torch.Tensor:
    """(num_keys,) i32 histogram of int keys in [0, num_keys) (others
    ignored): kernel H with every key active."""
    return histogram(key.to(torch.int32),
                     torch.ones(key.shape, dtype=torch.bool, device=key.device),
                     num_keys)


def count_per_key_matmul(key: torch.Tensor, num_keys: int, lo_width=None,
                         onehot_dtype=None) -> torch.Tensor:
    """:func:`count_per_key` as f32, the JAX function's result type (its
    one-hot matrix product is how the TPU histogrammed; ``lo_width`` and
    ``onehot_dtype`` tune that product and are accepted and ignored)."""
    return count_per_key(key, num_keys).to(torch.float32)


def particles_per_element(elem: torch.Tensor, active: torch.Tensor, num_elems: int,
                          weights=None) -> torch.Tensor:
    """(num_elems,) f32 count (kernel H) or, with ``weights`` ((N,) f32), sum
    of weights (kernel V) of the active particles of each element; elements
    outside [0, num_elems) are dropped."""
    if weights is None:
        return histogram(elem, active, num_elems).to(torch.float32)
    return vertex_deposit(weights, None, elem, active, None, num_elems)


def scatter_to_verts_bcc(elem: torch.Tensor, active: torch.Tensor, bcc: torch.Tensor,
                         elem2verts: torch.Tensor, num_verts: int,
                         charge=None) -> torch.Tensor:
    """Standard PIC charge deposition: each active particle's ``charge`` (1
    where None) times its (N, k) barycentric weights ``bcc``, to the k
    vertices of its parent element (clamped into range); returns (V,) f32.
    Kernel V on CUDA tensors, :func:`vertex_deposit_plain` on CPU tensors."""
    return vertex_deposit(bcc, charge, elem, active, elem2verts, num_verts)


# ---------------------------------------------------------------------------
# kernel V: the deterministic weighted deposit
# ---------------------------------------------------------------------------

FIXED_BITS = 94            # K = FIXED_BITS - L - e (see vertex_deposit_plain)
_NONFINITE_BITS = 0x7F800000


def _log2_terms(n_terms: int) -> int:
    """ceil(log2(n_terms)), 0 for none or one."""
    return max(n_terms - 1, 0).bit_length()


def _terms_and_keys(w, q, elem, active, elem2verts, n_out):
    """The (N·k,) f32 terms and their (N·k,) int64 output keys, ``n_out``
    where a term is dropped (inactive, or a key outside [0, n_out))."""
    k = 1 if w.dim() == 1 else w.shape[1]
    t = w.reshape(w.shape[0], k)
    if q is not None:
        t = t * q[:, None]
    if elem2verts is None:
        keys = elem.to(torch.int64)[:, None]
    else:
        e = torch.clamp(elem.to(torch.int64), 0, elem2verts.shape[0] - 1)
        keys = elem2verts[e].to(torch.int64)
    ok = active[:, None] & (keys >= 0) & (keys < n_out)
    return t.reshape(-1), torch.where(ok, keys, n_out).reshape(-1)


def vertex_deposit_plain(w: torch.Tensor, q, elem: torch.Tensor, active: torch.Tensor,
                         elem2verts, n_out: int) -> torch.Tensor:
    """Plain version of kernel V: (n_out,) f32 sums of the terms w[i, j]·q[i]
    (w[i, j] where ``q`` is None; ``w`` (N, k), or (N,) for k = 1) of the
    active particles, term j keyed by ``elem2verts[elem[i], j]`` (the
    element clamped into range), or by ``elem[i]`` where ``elem2verts`` is
    None; keys outside [0, n_out) are dropped.

    The sum is taken in fixed point.  With e the exponent bound of the
    largest |term| (|term| < 2^e, e = max(biased exponent, 1) - 126) and
    L = ceil(log2(N·k)), each term is scaled by 2^K, K = 94 - L - e, and
    rounded to the nearest integer (ties to even); the integers are summed
    exactly as (H, Lo) int64 pairs (``index_add_``), and the exact sum is
    rounded once to f32 (a TwoSum double-double, rounded to odd in f64,
    then to nearest in f32) and scaled back by 2^-K in two exact steps.  So
    the result is the f32 rounding of the exact sum of the terms, each
    within 2^-(K+1) (terms within 70 - L binades of the largest are
    exact), whatever the order.

    Non-finite terms are summed as the reference's f32 ``segment_sum`` sums
    them and take no part in the scale or the fixed-point sum: an output
    is NaN where it has a NaN term or both infinities, +inf or -inf where
    it has only that one, and otherwise the finite sum above."""
    t, key = _terms_and_keys(w, q, elem, active, elem2verts, n_out)
    dev = t.device
    bits = t.abs().view(torch.int32)
    finite = bits < _NONFINITE_BITS
    ok = key < n_out
    # the non-finite terms' classes per output: +inf, -inf, NaN
    flags = torch.zeros(3, n_out + 1, dtype=torch.bool, device=dev)
    for c, hit in enumerate((t == math.inf, t == -math.inf, torch.isnan(t))):
        flags[c, torch.where(ok & hit, key, n_out)] = True
    key = torch.where(finite, key, n_out)
    bits = torch.where(ok & finite, bits, 0)
    mb = int(bits.max()) if bits.numel() else 0
    K = FIXED_BITS - _log2_terms(t.numel()) - (max(mb >> 23, 1) - 126)
    y = torch.round(t.double() * 2.0 ** K)             # exact product, then X
    hd = torch.floor(y * 2.0 ** -32)
    acc = torch.zeros(2, n_out + 1, dtype=torch.int64, device=dev)
    acc[0].index_add_(0, key, hd.to(torch.int64))
    acc[1].index_add_(0, key, (y - hd * 2.0 ** 32).to(torch.int64))
    H, Ls = acc[0, :n_out], acc[1, :n_out]
    H = H + (Ls >> 32)
    Ls = Ls & 0xFFFFFFFF
    a1 = H.double()
    A = a1 * 2.0 ** 32
    C = ((H - a1.to(torch.int64)) * 2 ** 32 + Ls).double()
    s = A + C
    bb = s - A
    err = (A - (s - bb)) + (C - bb)
    bits = s.view(torch.int64)                # round to odd: one ulp toward err
    step = torch.where((err > 0) == (s > 0), 1, -1)
    s = torch.where((err != 0) & ((bits & 1) == 0), (bits + step).view(torch.float64), s)
    e1 = (-K) >> 1
    out = s.to(torch.float32) * 2.0 ** e1 * 2.0 ** (-K - e1)
    pos, neg, nan = flags[:, :n_out]
    out = torch.where(pos, math.inf, torch.where(neg, -math.inf, out))
    return torch.where(nan | (pos & neg), math.nan, out)


def vertex_deposit(w: torch.Tensor, q, elem: torch.Tensor, active: torch.Tensor,
                   elem2verts, n_out: int) -> torch.Tensor:
    """The deterministic weighted deposit (see :func:`vertex_deposit_plain`):
    kernel V on CUDA tensors, the plain version on CPU tensors."""
    tensors = [t for t in (w, q, elem, active, elem2verts) if t is not None]
    if not kernels.use_kernel("vdeposit", *tensors):
        return vertex_deposit_plain(w, q, elem, active, elem2verts, n_out)
    n = elem.shape[0]
    k = 1 if w.dim() == 1 else w.shape[1]
    if (w.dtype != torch.float32 or w.shape[0] != n or elem.dtype != torch.int32
            or active.dtype != torch.bool or active.shape != (n,)
            or (q is not None and (q.dtype != torch.float32 or q.shape != (n,)))
            or (elem2verts is not None and (elem2verts.dtype != torch.int32
                                            or elem2verts.shape[1:] != (k,)))):
        raise ValueError("vdeposit: (N, k) f32 terms, (N,) f32 charge, i32 elem, "
                         "bool active and (E, k) i32 keys expected")
    if n * k >= 1 << 31:
        raise ValueError("vdeposit: the kernel takes fewer than 2^31 terms")
    dev = w.device
    out = torch.empty(n_out, dtype=torch.float32, device=dev)
    if n_out == 0:
        return out
    acc = torch.empty(n_out, 2, dtype=torch.int64, device=dev)
    flags = torch.empty(n_out, dtype=torch.int32, device=dev)
    max_bits = torch.zeros(1, dtype=torch.int32, device=dev)
    P = ctypes.c_void_p

    def ptr(t):
        return P(None if t is None else t.data_ptr())

    err = _build.lib().pp_vdeposit(
        ptr(w), ptr(q), ptr(elem), ptr(active), ptr(elem2verts), k,
        0 if elem2verts is None else elem2verts.shape[0], n_out,
        _log2_terms(n * k), ptr(acc), ptr(flags), ptr(max_bits), ptr(out), n,
        P(kernels.stream_handle()))
    _build.check(err, "vdeposit")
    kernels.LAUNCHES["vdeposit"] += 1
    return out
