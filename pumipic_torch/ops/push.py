"""Particle pushes (port of ``pumipic_tpu.ops.push``: the elliptical push
of pseudoXGCm and the straight-line push of pseudoPushAndSearch).

Particles advance along ellipses centred at (h, k) with minor/major ratio d
(``test/ellipticalPush.hpp``); the angle step per push is
deg·(0.01 if class 1 else 1)/class.  The step carries (cos φ, sin φ) and
rotates it by the per-class (cos Δ, sin Δ), with a Newton renormalization.
On a band-ordered mesh the class id comes from the element id by counting
band starts, so no per-particle table gather is needed; on any other
classification each particle gathers its element's row of the (E, 2)
rotation table (:func:`elliptical_rot_table`).

:func:`push_banded` is the wrapper of kernel P (``kernels/csrc/push.cu``),
:func:`push_table` of P's table mode.  :func:`push_phi` is the wrapper of
P's "phi" mode, the angle form (:func:`elliptical_push_components` with the
active mask) that the single-device ``PseudoXGCm`` app runs.  The
straight-line push and periodic wrap are fused into kernel K
(:func:`pumipic_torch.ops.locate.kuhn_push_locate`); :func:`push_and_wrap`
is the wrapper of K's push-only form.
"""
from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from pumipic_torch import kernels
from pumipic_torch.kernels import _build
from pumipic_torch.ops.geometry import cross, sqrt_rn
from pumipic_torch.utils.device import resolve_device


def elliptical_setup(x: torch.Tensor, y: torch.Tensor, h: float, k: float,
                     d: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each particle's polar angle ``phi`` and major axis ``b`` from its
    position (``ellipticalPush::setup``)."""
    phi = torch.atan2(d * (y - k), x - h)
    sin_phi = torch.sin(phi)
    safe = torch.where(sin_phi.abs() < 1e-12,
                       torch.full_like(sin_phi, 1e-12), sin_phi)
    b = (y - k) / safe
    return phi, b


def elliptical_push_components(phi, b, elem_class_id, deg: float, h: float,
                               k: float, d: float):
    """Advance along the ellipse by ``deg`` degrees scaled per class; returns
    (x, y, new_phi) as (N,) tensors, in the JAX package's f32 expression
    order.  The divisor 180 is a 0-d tensor (torch's CUDA division by a
    Python scalar multiplies by its reciprocal).  cos and sin are taken in
    f64 and rounded to f32, so the CPU and the card give the same values
    (their f32 cos/sin differ in the last bit; the JAX package's f32 ones
    are within an ulp of these)."""
    cid = torch.clamp(elem_class_id, min=1).to(phi.dtype)
    one = phi.new_ones(())
    center_factor = torch.where(elem_class_id == 1, one * 0.01, one)
    dist_by_class = center_factor / cid
    deg_p = deg * dist_by_class
    rad = phi + deg_p * math.pi / phi.new_full((), 180.0)
    a = b * d
    r64 = rad.double()
    cos, sin = torch.cos(r64).to(rad.dtype), torch.sin(r64).to(rad.dtype)
    return a * cos + h, b * sin + k, rad


def elliptical_push(phi, b, elem_class_id, deg: float, h: float, k: float,
                    d: float):
    """(new_xy (N, 2), new_phi (N,)); see :func:`elliptical_push_components`."""
    x, y, rad = elliptical_push_components(phi, b, elem_class_id, deg, h, k, d)
    return torch.stack([x, y], dim=-1), rad


def step_vector(direction, distance: float) -> np.ndarray:
    """The straight-line push's (dim,) f32 displacement f32(distance) · d,
    rounded once in f32 as the JAX package's ``distance * d`` is."""
    return np.float32(distance) * np.asarray(direction, np.float32)


def straight_line_push(x: torch.Tensor, direction, distance: float) -> torch.Tensor:
    """x_tgt = x + distance · direction (pseudoPushAndSearch's push), on
    (N, dim) f32 positions ((N, 3) on the card: :func:`push_and_wrap`)."""
    return push_and_wrap(x, step_vector(direction, distance))


def push_and_wrap_plain(x: torch.Tensor, step=None, wrap=None) -> torch.Tensor:
    """Plain version of :func:`push_and_wrap` (and the push of kernel K's
    plain version), on (N, dim) positions.  torch's remainder is fmod plus
    the sign fix, as JAX's ``%``."""
    if step is not None:
        x = x + torch.as_tensor(np.asarray(step, np.float32), device=x.device)
    if wrap is not None:
        lo, ext = (torch.as_tensor(np.asarray(a, np.float32), device=x.device)
                   for a in wrap)
        x = torch.remainder(x - lo, ext) + lo
    return x


def push_and_wrap(x: torch.Tensor, step=None, wrap=None) -> torch.Tensor:
    """x + step (a (dim,) f32 displacement, :func:`step_vector`; None for
    none), then with ``wrap`` = (lo, ext) ((dim,) f32 each) the periodic
    wrap (x - lo) % ext + lo into the box: the push of pseudoPushAndSearch's
    walk arm (kernel K fuses both into the Kuhn arm's locate).  Kernel K's
    push-only form on CUDA tensors ((N, 3) f32; the constants go by value,
    so nothing is copied to the card), :func:`push_and_wrap_plain` on CPU
    tensors."""
    if not kernels.use_kernel("push_wrap", x):
        return push_and_wrap_plain(x, step, wrap)
    n = x.shape[0]
    if x.dtype != torch.float32 or x.shape != (n, 3):
        raise ValueError("push_wrap: (N, 3) f32 positions expected")
    x_out = torch.empty_like(x)
    if n == 0:
        return x_out
    s = np.zeros(3, np.float32) if step is None else np.asarray(step, np.float32)
    lo, ext = (np.zeros(3, np.float32),) * 2 if wrap is None else (
        np.asarray(a, np.float32) for a in wrap)
    P = ctypes.c_void_p
    err = _build.lib().pp_push_wrap(
        P(x.data_ptr()), n, int(step is not None), int(wrap is not None),
        (ctypes.c_float * 9)(*s, *lo, *ext), P(x_out.data_ptr()),
        P(kernels.stream_handle()))
    _build.check(err, "push_wrap")
    kernels.LAUNCHES["push_wrap"] += 1
    return x_out


def rot_vals_from_class(cid_int: torch.Tensor, deg: float
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos Δ, sin Δ) from integer class ids, in the JAX package's f32
    expression order."""
    cid = torch.clamp(cid_int, min=1).to(torch.float32)
    center_factor = torch.where(cid_int == 1, 0.01, 1.0).to(torch.float32)
    delta = deg * center_factor / cid * (math.pi / 180.0)
    return torch.cos(delta), torch.sin(delta)


def detect_banded_class(cls) -> Optional[Tuple[int, ...]]:
    """Band starts iff the classification is BAND-ORDERED: nondecreasing in
    the element id with consecutive integer values v0..v0+K-1.  Returns
    ``(v0, start_1, ..., start_{K-1})`` (``starts[0]`` is v0 itself, the
    rest are the first elements of bands v0+1..), or None."""
    cls = np.asarray(cls).ravel()
    if cls.size == 0 or not np.issubdtype(cls.dtype, np.integer):
        return None
    if np.any(np.diff(cls) < 0):
        return None
    v0 = int(cls[0])
    vals = np.unique(cls)
    if not np.array_equal(vals, np.arange(v0, v0 + vals.size)):
        return None
    starts = np.searchsorted(cls, vals[1:])
    return (v0,) + tuple(int(s) for s in starts)


def class_from_bands(elem: torch.Tensor, starts: Tuple[int, ...]) -> torch.Tensor:
    """cid = v0 + #{band starts <= elem}."""
    s = torch.as_tensor(starts[1:], dtype=elem.dtype, device=elem.device)
    return starts[0] + torch.searchsorted(s, elem.contiguous(), right=True).to(torch.int32)


def elliptical_push_rot_vals(cphi, sphi, b, cd, sd, h: float, k: float,
                             d: float):
    """Trig-free elliptical push on per-particle rotation values; returns
    (x, y, new_cphi, new_sphi).  The Newton step f = 1.5 - 0.5·(c²+s²) keeps
    the carried unit vector from drifting in f32."""
    c2 = cphi * cd - sphi * sd
    s2 = sphi * cd + cphi * sd
    f = 1.5 - 0.5 * (c2 * c2 + s2 * s2)
    c2 = c2 * f
    s2 = s2 * f
    return b * d * c2 + h, b * s2 + k, c2, s2


@dataclass(frozen=True)
class BandRotation:
    """Per-class rotation table of a band-ordered mesh with classes
    v0..v0+K-1: ``starts`` holds the first element of bands v0+1..v0+K-1
    (i32), ``cd``/``sd`` the (K,) (cos Δ, sin Δ) of classes v0..v0+K-1, so
    an element's row is the number of starts at or below it."""

    starts: torch.Tensor
    cd: torch.Tensor
    sd: torch.Tensor

    @staticmethod
    def build(band_starts: Tuple[int, ...], deg: float, device=None
              ) -> "BandRotation":
        device = resolve_device(device)
        v0, K = band_starts[0], len(band_starts)
        cids = torch.arange(v0, v0 + K, dtype=torch.int32)
        cd, sd = rot_vals_from_class(cids, deg)
        return BandRotation(
            torch.as_tensor(band_starts[1:], dtype=torch.int32, device=device),
            cd.to(device), sd.to(device))


# shared memory the kernel holds its band starts and tables in (48 KB)
MAX_BANDS = 4096


def push_banded_plain(x0, x1, cphi, sphi, b, elem, active,
                      rot: BandRotation, h: float, k: float, d: float):
    """Plain PyTorch version of kernel P."""
    e = torch.clamp(elem, min=0).contiguous()
    j = torch.searchsorted(rot.starts, e, right=True)
    cd, sd = rot.cd[j], rot.sd[j]
    tx, ty, c2, s2 = elliptical_push_rot_vals(cphi, sphi, b, cd, sd, h, k, d)
    return (torch.where(active, tx, x0), torch.where(active, ty, x1),
            torch.where(active, c2, cphi), torch.where(active, s2, sphi))


def push_banded(x0, x1, cphi, sphi, b, elem, active, rot: BandRotation,
                h: float, k: float, d: float):
    """Banded trig-free push with the active mask applied: returns
    (xtgt0, xtgt1, cphi', sphi').  Kernel P on CUDA tensors, the plain
    version on CPU tensors."""
    args = (x0, x1, cphi, sphi, b, elem, active, rot.starts, rot.cd, rot.sd)
    if not kernels.use_kernel("push", *args):
        return push_banded_plain(x0, x1, cphi, sphi, b, elem, active, rot,
                                 h, k, d)
    n = x0.shape[0]
    for t in (x0, x1, cphi, sphi, b):
        if t.dtype != torch.float32 or t.shape != (n,):
            raise ValueError("push: f32 (N,) positions and angles expected")
    if elem.dtype != torch.int32 or active.dtype != torch.bool:
        raise ValueError("push: i32 elem and bool active expected")
    K = rot.cd.shape[0]
    if K > MAX_BANDS:
        raise ValueError(f"push: {K} bands exceed the kernel's {MAX_BANDS}")
    outs = [torch.empty_like(x0) for _ in range(4)]
    P = ctypes.c_void_p
    err = _build.lib().pp_push_banded(
        *(P(t.data_ptr()) for t in (x0, x1, cphi, sphi, b, elem, active,
                                    rot.starts)),
        K - 1, P(rot.cd.data_ptr()), P(rot.sd.data_ptr()),
        h, k, d, *(P(t.data_ptr()) for t in outs), n,
        P(kernels.stream_handle()))
    _build.check(err, "push")
    kernels.LAUNCHES["push"] += 1
    return tuple(outs)


# ---------------------------------------------------------------------------
# kernel P, table mode: the per-element rotation table
# ---------------------------------------------------------------------------

def elliptical_rot_table(elem_class_id, deg: float) -> torch.Tensor:
    """Per-ELEMENT rotation table (E, 2) f32 on the CPU: row e holds
    (cos Δe, sin Δe), Δe = deg · center_factor / class_id · π/180.  Δ is
    computed in the JAX package's f32 steps; cos and sin in f64, rounded to
    f32 (the table is built once on the host, so the card and the CPU read
    the same bits; XLA's f32 cos/sin are within an ulp of these)."""
    cls = np.asarray(elem_class_id.cpu() if isinstance(elem_class_id, torch.Tensor)
                     else elem_class_id).ravel()
    cid = np.maximum(cls, 1).astype(np.float32)
    center_factor = np.where(cls == 1, np.float32(0.01), np.float32(1.0))
    delta = np.float32(deg) * center_factor / cid * np.float32(math.pi / 180.0)
    d64 = delta.astype(np.float64)
    return torch.as_tensor(np.stack([np.cos(d64), np.sin(d64)], axis=1)
                           .astype(np.float32))


def rot_table_2d(rot_table: torch.Tensor) -> torch.Tensor:
    """The (E, 2) form of a rotation table.  The JAX package's 1-D sin Δ
    table (its TPU-only ``ROT_TABLE_1D``) maps to the rows (cos Δ, sin Δ)
    with cos Δ = √max(1 − sin²Δ, 0) in f32, the values its push recomputes
    per particle."""
    if rot_table.dim() == 2:
        return rot_table
    sd = rot_table
    return torch.stack([torch.sqrt(torch.clamp(1.0 - sd * sd, min=0.0)), sd], dim=1)


def elliptical_push_rot(cphi, sphi, b, elem, rot_table, h: float, k: float,
                        d: float):
    """Trig-free elliptical push gathering each particle's element row of
    the (E, 2) or 1-D rotation table (:func:`rot_table_2d`); returns (x, y,
    new_cphi, new_sphi), unmasked."""
    r = rot_table_2d(rot_table)[torch.clamp(elem, min=0).long()]
    return elliptical_push_rot_vals(cphi, sphi, b, r[:, 0], r[:, 1], h, k, d)


@dataclass(frozen=True)
class RotTable:
    """The per-element rotation table (E, 2) f32 of kernel P's table mode,
    on the device of the particles."""

    table: torch.Tensor

    @staticmethod
    def build(elem_class_id, deg: float, device=None,
              one_dim: bool = False) -> "RotTable":
        """From the classification; ``one_dim`` builds the JAX package's
        1-D sin Δ form first and maps it onto (E, 2)."""
        t = elliptical_rot_table(elem_class_id, deg)
        if one_dim:
            t = rot_table_2d(t[:, 1].contiguous())
        return RotTable(t.contiguous().to(resolve_device(device)))


def push_table_plain(x0, x1, cphi, sphi, b, elem, active, rot: RotTable,
                     h: float, k: float, d: float):
    """Plain PyTorch version of kernel P's table mode."""
    tx, ty, c2, s2 = elliptical_push_rot(cphi, sphi, b, elem, rot.table, h, k, d)
    return (torch.where(active, tx, x0), torch.where(active, ty, x1),
            torch.where(active, c2, cphi), torch.where(active, s2, sphi))


def push_table(x0, x1, cphi, sphi, b, elem, active, rot: RotTable,
               h: float, k: float, d: float):
    """Table-mode trig-free push with the active mask applied: each
    particle gathers the (cos Δ, sin Δ) row of its element ``max(elem,
    0)``; returns (xtgt0, xtgt1, cphi', sphi').  Kernel P (table mode) on
    CUDA tensors, :func:`push_table_plain` on CPU tensors."""
    args = (x0, x1, cphi, sphi, b, elem, active, rot.table)
    if not kernels.use_kernel("push_table", *args):
        return push_table_plain(x0, x1, cphi, sphi, b, elem, active, rot, h, k, d)
    n = x0.shape[0]
    for t in (x0, x1, cphi, sphi, b):
        if t.dtype != torch.float32 or t.shape != (n,):
            raise ValueError("push_table: f32 (N,) positions and angles expected")
    if elem.dtype != torch.int32 or elem.shape != (n,) or active.dtype != torch.bool:
        raise ValueError("push_table: i32 elem and bool active expected")
    E = rot.table.shape[0]
    if rot.table.dtype != torch.float32 or rot.table.shape != (E, 2) \
            or rot.table.data_ptr() % 8:
        raise ValueError("push_table: an 8-byte aligned (E, 2) f32 table expected")
    outs = [torch.empty_like(x0) for _ in range(4)]
    P = ctypes.c_void_p
    err = _build.lib().pp_push_table(
        *(P(t.data_ptr()) for t in (x0, x1, cphi, sphi, b, elem, active,
                                    rot.table)),
        E, h, k, d, *(P(t.data_ptr()) for t in outs), n,
        P(kernels.stream_handle()))
    _build.check(err, "push_table")
    kernels.LAUNCHES["push_table"] += 1
    return tuple(outs)


# ---------------------------------------------------------------------------
# kernel P, "phi" mode
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class BandClasses:
    """Class ids of a band-ordered mesh: class = v0 + #{starts <= elem},
    ``starts`` (K-1,) i32 on the device (from :func:`detect_banded_class`)."""

    v0: int
    starts: torch.Tensor

    @staticmethod
    def build(band_starts: Tuple[int, ...], device=None) -> "BandClasses":
        return BandClasses(int(band_starts[0]), torch.as_tensor(
            band_starts[1:], dtype=torch.int32, device=resolve_device(device)))


def push_phi_plain(x, phi, b, active, cls, deg: float, h: float, k: float,
                   d: float, bands: Optional[BandClasses] = None):
    """Plain version of kernel P's phi mode; see :func:`push_phi`."""
    if bands is not None:
        e = torch.clamp(cls, min=0).contiguous()
        cid = bands.v0 + torch.searchsorted(bands.starts, e, right=True).to(torch.int32)
    else:
        cid = cls
    tx, ty, rad = elliptical_push_components(phi, b, cid, deg, h, k, d)
    tx = torch.where(active, tx, x[:, 0])
    ty = torch.where(active, ty, x[:, 1])
    return tx, ty, torch.stack([tx, ty], dim=-1), torch.where(active, rad, phi)


def push_phi(x, phi, b, active, cls, deg: float, h: float, k: float, d: float,
             bands: Optional[BandClasses] = None):
    """Elliptical push in angle form with the active mask applied: returns
    (xtgt0, xtgt1, xtgt (N, 2), phi').  ``x`` is the (N, 2) position (kept
    where inactive).  With ``bands``, ``cls`` is each particle's element and
    its class comes from the band starts; without, ``cls`` is the class id
    per particle.  Kernel P (phi mode) on CUDA tensors, the plain version on
    CPU tensors."""
    args = (x, phi, b, active, cls) + (() if bands is None else (bands.starts,))
    if not kernels.use_kernel("push", *args):
        return push_phi_plain(x, phi, b, active, cls, deg, h, k, d, bands)
    n = phi.shape[0]
    if x.dtype != torch.float32 or x.shape != (n, 2):
        raise ValueError("push_phi: (N, 2) f32 positions expected")
    for t in (phi, b):
        if t.dtype != torch.float32 or t.shape != (n,):
            raise ValueError("push_phi: f32 (N,) angles and axes expected")
    if cls.dtype != torch.int32 or cls.shape != (n,) or active.dtype != torch.bool:
        raise ValueError("push_phi: i32 (N,) elem or class ids and bool active expected")
    n_starts = 0 if bands is None else bands.starts.shape[0]
    if n_starts > MAX_BANDS:
        raise ValueError(f"push_phi: {n_starts + 1} bands exceed the kernel's {MAX_BANDS}")
    tx, ty, phi_out = (torch.empty_like(phi) for _ in range(3))
    xy = torch.empty_like(x)
    P = ctypes.c_void_p
    err = _build.lib().pp_push_phi(
        *(P(t.data_ptr()) for t in (x, phi, b, active, cls)),
        P(None if bands is None else bands.starts.data_ptr()), n_starts,
        0 if bands is None else bands.v0, int(bands is not None),
        deg, h, k, d, *(P(t.data_ptr()) for t in (tx, ty, xy, phi_out)), n,
        P(kernels.stream_handle()))
    _build.check(err, "push")
    kernels.LAUNCHES["push"] += 1
    return tx, ty, xy, phi_out


# ---------------------------------------------------------------------------
# Boris push (the GITR-style app): kernel R fuses the 3D grid E field with it
# ---------------------------------------------------------------------------

ELEMENTARY_CHARGE = 1.60217662e-19
PROTON_MASS = 1.6737236e-27


def boris_factors(dt: float, charge: float, amu: float) -> Tuple[float, float]:
    """(q', 2q') rounded to f32, where q' = q·e/(amu·m_p)·dt/2 is taken in
    f64 as the JAX package's Python floats take it; its weak-typed f32
    arithmetic then rounds each once (2q' doubles exactly)."""
    q = charge * ELEMENTARY_CHARGE / (amu * PROTON_MASS) * dt * 0.5
    return float(np.float32(q)), float(np.float32(2.0 * q))


def boris_push(x: torch.Tensor, v: torch.Tensor, e_field: torch.Tensor,
               b_field: torch.Tensor, dt: float, charge: float = 1.0,
               amu: float = 10.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Boris rotation velocity update and position step on (N, 3) tensors
    (``pushBoris``, pumipic_push.hpp:17-74): with q' = q·e/(amu·m_p)·dt/2
    and coeff = 2q'/(1+(q'|B|)²), v⁻ = v - q'E; v' = v⁻ + q'(v⁻×B);
    v⁺ = v⁻ + coeff(v'×B) + q'E; x ← x + v⁺ dt.  The reference subtracts the
    first half kick and adds it back after the rotation; so does this.
    Every scalar is a 0-d f32 tensor (torch's division by a Python scalar
    multiplies by its reciprocal), in the JAX package's operation order;
    |B| is the correctly rounded sqrt (:func:`~pumipic_torch.ops.geometry.sqrt_rn`)."""
    qp, two_qp = boris_factors(dt, charge, amu)
    f32 = dict(dtype=torch.float32, device=x.device)
    qp_t, two_qp_t = torch.tensor(qp, **f32), torch.tensor(two_qp, **f32)
    b = b_field
    b_mag = sqrt_rn(b[:, 0] * b[:, 0] + b[:, 1] * b[:, 1] + b[:, 2] * b[:, 2])[:, None]
    s = qp_t * b_mag
    coeff = two_qp_t / (1.0 + s * s)
    qp_e = qp_t * e_field
    v_minus = v - qp_e
    v_prime = v_minus + qp_t * cross(v_minus, b)
    v_new = v_minus + coeff * cross(v_prime, b) + qp_e
    return x + v_new * torch.tensor(float(np.float32(dt)), **f32), v_new


def _vec3(a) -> np.ndarray:
    """Three f32 values from a tensor, an array or a sequence."""
    if isinstance(a, torch.Tensor):
        a = a.cpu().numpy()
    return np.asarray(a, np.float32).reshape(3)


def boris_push_grid_plain(x, v, e_grid, origin, spacing, b, dt: float,
                          charge: float = 1.0, amu: float = 10.0):
    """Plain PyTorch version of kernel R: E by
    :func:`~pumipic_torch.ops.interpolate.interpolate_3d_grid` at ``x``, a
    uniform B, then :func:`boris_push`."""
    from pumipic_torch.ops.interpolate import interpolate_3d_grid

    o, h, bv = (torch.as_tensor(_vec3(a), device=x.device) for a in (origin, spacing, b))
    e = interpolate_3d_grid(e_grid, o, h, x)
    return boris_push(x, v, e, bv.expand(x.shape[0], 3), dt, charge, amu)


def grid_corner_rows(e_grid: torch.Tensor) -> torch.Tensor:
    """The corner table kernel R reads in place of ``e_grid`` (nx, ny, nz,
    3): ((nx-1)(ny-1)(nz-1), 32) f32, cell (i, j, k) at row
    (i·(ny-1) + j)·(nz-1) + k, holding its 8 corners m = 4·di + 2·dj + dk
    as e_grid[i+di, j+dj, k+dk, 0:3] at floats 3m .. 3m+2 and 8 zeros: one
    128-byte row a cell, in the order the trilinear sum takes them."""
    nx, ny, nz = e_grid.shape[:3]
    parts = [e_grid[di:nx - 1 + di, dj:ny - 1 + dj, dk:nz - 1 + dk]
             for di in (0, 1) for dj in (0, 1) for dk in (0, 1)]
    parts.append(e_grid.new_zeros((nx - 1, ny - 1, nz - 1, 8)))
    return torch.cat(parts, dim=3).reshape(-1, 32).contiguous()


def boris_coeff(b: np.ndarray, qp: float, two_qp: float) -> float:
    """2q'/(1 + (q'|B|)²) for a uniform B (3 f32 values) in numpy f32
    scalars, each operation rounded once in the plain version's order, so
    it equals what :func:`boris_push` computes per particle (|B| a
    correctly rounded sqrt)."""
    f = np.float32
    b = np.asarray(b, np.float32)
    b_mag = np.sqrt(b[0] * b[0] + b[1] * b[1] + b[2] * b[2])
    s = f(qp) * b_mag
    return float(f(two_qp) / (f(1.0) + s * s))


def boris_push_grid(x: torch.Tensor, v: torch.Tensor, e_grid: torch.Tensor,
                    origin, spacing, b, dt: float, charge: float = 1.0,
                    amu: float = 10.0, corners: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x_new, v_new): the GITR-style step's field and push in one pass.
    E is interpolated trilinearly at ``x`` (N, 3) from ``e_grid`` (nx, ny,
    nz, 3) f32 with the grid's ``origin`` and cell ``spacing`` (3 values
    each); B is uniform (3 values); then the Boris push over ``dt``.
    Kernel R (``kernels/csrc/boris.cu``) on CUDA tensors, reading
    ``corners``, the grid's :func:`grid_corner_rows` (built here when None;
    a caller that steps many times builds it once);
    :func:`boris_push_grid_plain` on CPU tensors."""
    if not kernels.use_kernel("boris", x, v, e_grid):
        return boris_push_grid_plain(x, v, e_grid, origin, spacing, b, dt, charge, amu)
    n = x.shape[0]
    g = e_grid.shape
    if (x.dtype != torch.float32 or v.dtype != torch.float32 or x.shape != (n, 3)
            or v.shape != (n, 3) or e_grid.dtype != torch.float32 or e_grid.ndim != 4
            or g[3] != 3 or min(g[:3]) < 2):
        raise ValueError("boris_push_grid: (N, 3) f32 x and v and an (nx, ny, nz, 3) "
                         "f32 grid with every n >= 2 expected")
    n_cells = (g[0] - 1) * (g[1] - 1) * (g[2] - 1)
    if n >= 1 << 31 or n_cells * 32 >= 1 << 31:
        raise ValueError("boris_push_grid: the kernel takes fewer than 2^31 "
                         "particles and corner-table values")
    if corners is None:
        corners = grid_corner_rows(e_grid)
    kernels.use_kernel("boris", x, corners)
    if (corners.dtype != torch.float32 or corners.shape != (n_cells, 32)
            or corners.data_ptr() % 16):
        raise ValueError("boris_push_grid: corners must be the grid's "
                         "((nx-1)(ny-1)(nz-1), 32) f32 grid_corner_rows, 16-byte aligned")
    x_out, v_out = torch.empty_like(x), torch.empty_like(v)
    if n == 0:
        return x_out, v_out
    qp, two_qp = boris_factors(dt, charge, amu)
    o, h, bv = (_vec3(a) for a in (origin, spacing, b))
    params = (ctypes.c_float * 13)(*o, *h, *bv, qp, two_qp, float(np.float32(dt)),
                                   boris_coeff(bv, qp, two_qp))
    P = ctypes.c_void_p
    err = _build.lib().pp_boris_grid(
        P(x.data_ptr()), P(v.data_ptr()), P(corners.data_ptr()), g[0], g[1], g[2],
        params, P(x_out.data_ptr()), P(v_out.data_ptr()), n,
        P(kernels.stream_handle()))
    _build.check(err, "boris")
    kernels.LAUNCHES["boris"] += 1
    return x_out, v_out


# the f32 rounding of the specular update's 1e-30: torch, like JAX, clamps
# and compares an f32 tensor with a Python scalar in f32
GITR_TINY = float(np.float32(1e-30))


def gitr_update_plain(x, v, v_new, dest, hit, elem, num_hits, active, reflect: bool):
    """Plain version of kernel F: the GITR-style step's state update after
    the walk (``pumipic_tpu/models/gitr_like.py:119-141``), the norms'
    squares summed left to right and their sqrt correctly rounded."""
    lost = active & (elem < 0)
    if reflect:
        # specular wall: |v'| along the last leg, from the last hit point
        # to the mirrored destination
        leg = dest - hit
        leg_n = _norm(leg)
        v_spec = _norm(v_new) * leg / torch.clamp(leg_n, min=1e-30)
        bounced = active & (elem >= 0) & (num_hits > 0) & (leg_n[:, 0] > 1e-30)
        v_new = torch.where(bounced[:, None], v_spec, v_new)
    return (torch.where(lost[:, None], x, dest), torch.where(active[:, None], v_new, v),
            active & (elem >= 0), lost)


def _norm(a: torch.Tensor) -> torch.Tensor:
    """(N, 1) Euclidean norms of (N, 3) rows, the squares summed left to
    right, the sqrt correctly rounded (the same on the card and the CPU)."""
    return sqrt_rn(a[:, 0] * a[:, 0] + a[:, 1] * a[:, 1] + a[:, 2] * a[:, 2])[:, None]


def gitr_update(x: torch.Tensor, v: torch.Tensor, v_new: torch.Tensor,
                dest: torch.Tensor, hit: Optional[torch.Tensor], elem: torch.Tensor,
                num_hits: Optional[torch.Tensor], active: torch.Tensor, reflect: bool
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(x, v, active, lost) after the GITR-style step's walk: from the step's
    positions ``x``, velocities ``v`` and pushed velocities ``v_new`` ((N,
    3) f32 each), the walk's destinations ``dest``, last hit points ``hit``
    ((N, 3) f32; read with ``reflect`` only), new elements ``elem`` and hit
    counts ``num_hits`` ((N,) i32) and the step's ``active`` mask.  With
    ``reflect`` a particle that bounced (active, kept, hit the wall and
    moved past its last hit point) takes the specular velocity |v'|·(dest
    - hit)/|dest - hit|; a particle lost keeps its position, every other
    one moves to ``dest``; an active particle takes its new velocity.
    ``lost`` = active and removed.  Kernel F (``kernels/csrc/gitr.cu``) on
    CUDA tensors, :func:`gitr_update_plain` on CPU tensors."""
    tensors = [x, v, v_new, dest, elem, active] + ([hit, num_hits] if reflect else [])
    if not kernels.use_kernel("gitr_update", *tensors):
        return gitr_update_plain(x, v, v_new, dest, hit, elem, num_hits, active, reflect)
    n = x.shape[0]
    if (any(t.dtype != torch.float32 or t.shape != (n, 3)
            for t in (x, v, v_new, dest) + ((hit,) if reflect else ()))
            or elem.dtype != torch.int32 or elem.shape != (n,)
            or active.dtype != torch.bool or active.shape != (n,)
            or (reflect and (num_hits.dtype != torch.int32 or num_hits.shape != (n,)))):
        raise ValueError("gitr_update: (N, 3) f32 x, v, v_new, dest (and hit), (N,) i32 "
                         "elem (and num_hits) and an (N,) bool active expected")
    x_out, v_out = torch.empty_like(x), torch.empty_like(v)
    active_out = torch.empty_like(active)
    lost = torch.empty_like(active)
    if n == 0:
        return x_out, v_out, active_out, lost
    P = ctypes.c_void_p
    hit_p, nh_p = (P(hit.data_ptr()), P(num_hits.data_ptr())) if reflect else (P(0), P(0))
    err = _build.lib().pp_gitr_update(
        P(x.data_ptr()), P(v.data_ptr()), P(v_new.data_ptr()), P(dest.data_ptr()),
        hit_p, P(elem.data_ptr()), nh_p, P(active.data_ptr()), int(reflect),
        GITR_TINY, P(x_out.data_ptr()), P(v_out.data_ptr()), P(active_out.data_ptr()),
        P(lost.data_ptr()), n, P(kernels.stream_handle()))
    _build.check(err, "gitr_update")
    kernels.LAUNCHES["gitr_update"] += 1
    return x_out, v_out, active_out, lost
