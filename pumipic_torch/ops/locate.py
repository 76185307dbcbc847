"""Analytic point location: the flux-band cell id (kernel B), the
structured-annulus locate (kernel A) and the straight-line push with the
structured Kuhn-box locate (kernel K), each with its plain PyTorch version.

- :func:`band_cell_of` (kernel B, ``kernels/csrc/band.cu``) gives each point
  its :class:`~pumipic_torch.mesh.locator.BandGrid2D` cell; the search's
  peel then tests that cell's candidate rows (kernel L, "given cells").
- :func:`annulus_locate` (kernel A, ``kernels/csrc/annulus.cu``) gives each
  active point its containing triangle on a proven structured annulus,
  INVALID outside, and the rewritten active mask: the whole search of the
  annulus arm.
- :func:`kuhn_push_locate` (kernel K, ``kernels/csrc/kuhn.cu``) pushes each
  point along the straight line, wraps it into the box (periodic wall) and
  gives each active point its containing tet on a proven Kuhn box, INVALID
  outside: the whole push and search of pseudoPushAndSearch's Kuhn arm.

The plain versions follow the JAX package's f32 expression order term by
term (``BandGrid2D._band_continuous``/``cell_of``,
``AnnulusLocator2D.locate_parts``, ``straight_line_push``, the periodic
wrap and ``KuhnLocator3D.locate``), and the kernels follow the plain
versions, so a kernel equals its plain version bit for bit on the card.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from pumipic_torch import kernels
from pumipic_torch.kernels import _build
from pumipic_torch.mesh.locator import AnnulusLocator2D, BandGrid2D, KuhnLocator3D
from pumipic_torch.ops.push import push_and_wrap_plain

INVALID = -1
# kernel B keeps its accumulators in registers and its coefficients in its
# launch parameters: bounds on the band model
MAX_HARM, MAX_CHEB, MAX_RANK, MAX_INV_COEF = 24, 12, 8, 11
MAX_COEF = MAX_RANK * (2 * MAX_HARM + 1) + (MAX_CHEB + 1) * MAX_RANK + MAX_INV_COEF
# kernel A indexes its sector table by the f32 sector index kf
MAX_SECTORS = 1 << 24


# ---------------------------------------------------------------------------
# kernel B: flux-band cell id
# ---------------------------------------------------------------------------

def band_params(grid: BandGrid2D) -> np.ndarray:
    """Kernel B's launch parameters (``BandParams`` in ``band.cu``) as
    int32 words: the coefficients as f32 bits, padded to ``MAX_COEF``
    (coef_v's harmonic columns as (rank, J, (cos, sin)) pairs, which the
    kernel fetches two at a time, then its constant column, coef_u and
    inv_coef), then cx and cy (f32 bits), K, T, J, P, rank, the seed terms
    and the Newton steps.  Read from the device once per grid
    (:attr:`BandGrid2D.launch_params`)."""
    J = grid.n_harm
    cv, cu, ic = (c.detach().cpu().numpy().astype(np.float32)
                  for c in (grid.coef_v, grid.coef_u, grid.inv_coef))
    pairs = np.stack([cv[:, 1:1 + J], cv[:, 1 + J:]], axis=-1)
    coefs = np.concatenate([pairs.reshape(-1), cv[:, 0], cu.reshape(-1), ic.reshape(-1)])
    words = np.zeros(MAX_COEF + 9, np.int32)
    words[:coefs.size] = coefs.view(np.int32)
    words[MAX_COEF:MAX_COEF + 2] = np.array([grid.cx, grid.cy], np.float32).view(np.int32)
    words[MAX_COEF + 2:] = [grid.n_bands, grid.n_theta, grid.n_harm, grid.n_cheb,
                            grid.rank, grid.inv_coef.shape[0], grid.newton_iters]
    return words


def band_continuous_plain(grid: BandGrid2D, px: torch.Tensor,
                          py: torch.Tensor):
    """(b*, τ): the continuous band coordinate and the diamond angle
    τ ∈ [0, 4) of each point, in ``_band_continuous``'s f32 order."""
    x = px - grid.cx
    y = py - grid.cy
    r = torch.sqrt(x * x + y * y)
    J, P, rk = grid.n_harm, grid.n_cheb, grid.rank
    cv, cu, ic = grid.coef_v, grid.coef_u, grid.inv_coef
    inv_r = 1.0 / torch.clamp(r, min=1e-30)
    c1 = x * inv_r
    s1 = y * inv_r
    # rank-space projections t_k = Σ_j V[k, j]·h_j(θ), harmonics by recurrence
    t = [cv[k, 0].expand_as(r) for k in range(rk)]
    cj, sj = c1, s1
    for j in range(J):
        for k in range(rk):
            t[k] = t[k] + cv[k, 1 + j] * cj
            t[k] = t[k] + cv[k, 1 + J + j] * sj
        if j + 1 < J:
            cj, sj = cj * c1 - sj * s1, sj * c1 + cj * s1
    # per-point Chebyshev coefficients (Python's sum: a left fold from 0)
    q = [sum(cu[p, k] * t[k] for k in range(rk)) for p in range(P + 1)]

    def radius_and_slope(u):
        bk1 = bk2 = dk1 = dk2 = torch.zeros_like(u)
        for p in range(P, 0, -1):
            dk1, dk2 = 2.0 * bk1 + 2.0 * u * dk1 - dk2, dk1
            bk1, bk2 = q[p] + 2.0 * u * bk1 - bk2, bk1
        return q[0] + u * bk1 - bk2, bk1 + u * dk1 - dk2

    # Horner seed of the angular-mean inverse, then safeguarded Newton
    u = ic[-1].expand_as(r)
    for p in range(ic.shape[0] - 2, -1, -1):
        u = u * r + ic[p]
    u = torch.clamp(u, -1.05, 1.05)
    for _ in range(grid.newton_iters):
        val, dv = radius_and_slope(u)
        u = u - (val - r) / torch.clamp(dv, min=1e-6)
        u = torch.clamp(u, -1.05, 1.05)
    d = y / torch.clamp(x.abs() + y.abs(), min=1e-30)
    tau = torch.where(x >= 0, torch.where(y >= 0, d, 4.0 + d), 2.0 - d)
    return (u + 1.0) * (0.5 * grid.n_bands), tau


def band_cell_of_plain(grid: BandGrid2D, px: torch.Tensor,
                       py: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel B: (N,) i32 cell ids, band·T + θ-bin in f32
    arithmetic (exact while K·T < 2^24).  The final integer clamp only
    guards non-finite points."""
    K, T = grid.n_bands, grid.n_theta
    bstar, tau = band_continuous_plain(grid, px, py)
    bf = torch.clamp(torch.floor(bstar), 0.0, K - 1.0)
    tf = torch.clamp(torch.floor(tau * (T / 4.0)), 0.0, T - 1.0)
    return torch.clamp((bf * T + tf).to(torch.int32), 0, K * T - 1)


def band_cell_of(grid: BandGrid2D, px: torch.Tensor,
                 py: torch.Tensor) -> torch.Tensor:
    """Flux-band cell id of each point.  Kernel B on CUDA tensors,
    :func:`band_cell_of_plain` on CPU tensors."""
    coefs = (grid.coef_v, grid.coef_u, grid.inv_coef)
    if not kernels.use_kernel("band_cell", px, py, *coefs):
        return band_cell_of_plain(grid, px, py)
    n = px.shape[0]
    if px.dtype != torch.float32 or py.dtype != torch.float32 \
            or py.shape != (n,) or px.dim() != 1:
        raise ValueError("band_cell: f32 (N,) px and py expected")
    if grid.coef_v.shape != (grid.rank, 2 * grid.n_harm + 1) \
            or grid.coef_u.shape != (grid.n_cheb + 1, grid.rank):
        raise ValueError("band_cell: coefficient shapes do not match the grid")
    if (grid.n_harm > MAX_HARM or grid.n_cheb > MAX_CHEB
            or grid.rank > MAX_RANK or grid.inv_coef.shape[0] > MAX_INV_COEF):
        raise ValueError(
            f"band_cell: J={grid.n_harm}, P={grid.n_cheb}, rank={grid.rank}, "
            f"{grid.inv_coef.shape[0]} seed terms exceed the kernel's "
            f"{MAX_HARM}, {MAX_CHEB}, {MAX_RANK}, {MAX_INV_COEF}")
    if grid.n_bands * grid.n_theta >= 1 << 24:
        raise ValueError("band_cell: K*T must stay below 2^24")
    cells = torch.empty(n, dtype=torch.int32, device=px.device)
    if n == 0:
        return cells
    params = grid.launch_params
    P = ctypes.c_void_p
    err = _build.lib().pp_band_cell(
        P(px.data_ptr()), P(py.data_ptr()), n, params.ctypes.data_as(P),
        P(cells.data_ptr()), P(kernels.stream_handle()))
    _build.check(err, "band_cell")
    kernels.LAUNCHES["band_cell"] += 1
    return cells


# ---------------------------------------------------------------------------
# kernel A: structured-annulus locate + DPS rewrite
# ---------------------------------------------------------------------------

def annulus_locate_parts_plain(loc: AnnulusLocator2D, px: torch.Tensor,
                               py: torch.Tensor):
    """(elem, inside, rf, kf, trif) of every point, in ``locate_parts``'s f32
    order, with the per-mesh scalars of :meth:`AnnulusLocator2D.scalars`.
    Divisors are 0-d tensors on the points' device: torch's CUDA division
    by a Python scalar multiplies by its reciprocal, which rounds
    differently from the IEEE division kernel A does."""
    sc = loc.scalars()
    S, R = loc.n_sectors, loc.n_rings
    dth = sc["dth"]
    x = px - loc.cx
    y = py - loc.cy
    th = torch.atan2(y, x) - loc.theta0
    th = torch.where(th < 0, th + sc["two_pi"], th)
    th = torch.where(th < 0, th + sc["two_pi"], th)
    kf = torch.clamp(torch.floor(th / x.new_full((), dth)), 0.0, S - 1.0)
    # wedge-bisector projection: exact ring floor and chord-exact bounds
    phi = loc.theta0 + (kf + 0.5) * dth
    r_eff = (x * torch.cos(phi) + y * torch.sin(phi)) / x.new_full((), sc["m"])
    inside = (r_eff >= sc["lo"]) & (r_eff <= sc["hi"])
    rf = torch.clamp(torch.floor((r_eff - loc.r_in) / x.new_full((), loc.dr)),
                     0.0, R - 1.0)
    # the quad diagonal a -> d decides the triangle
    ra = loc.r_in + rf * loc.dr
    rd = ra + loc.dr
    tha = loc.theta0 + kf * dth
    thd = tha + dth
    ax = ra * torch.cos(tha)
    ay = ra * torch.sin(tha)
    ddx = rd * torch.cos(thd) - ax
    ddy = rd * torch.sin(thd) - ay
    cross = ddx * (y - ay) - ddy * (x - ax)
    trif = torch.where(cross >= 0, 0.0, 1.0)
    elem = (rf * S + kf) * 2.0 + trif
    elem = torch.where(inside, elem, float(INVALID)).to(torch.int32)
    if loc.perm is not None:
        elem = torch.where(elem >= 0, loc.perm[torch.clamp(elem, min=0).long()],
                           elem)
    return elem, inside, rf, kf, trif


def annulus_locate_plain(loc: AnnulusLocator2D, px, py, active):
    """Plain version of kernel A: (elem, active') with elem INVALID for
    inactive or outside points and active' = elem >= 0."""
    elem = annulus_locate_parts_plain(loc, px, py)[0]
    elem = torch.where(active, elem, INVALID)
    return elem, elem >= 0


def annulus_locate(loc: AnnulusLocator2D, px: torch.Tensor, py: torch.Tensor,
                   active: torch.Tensor):
    """Locate every active point on the annulus and rewrite the DPS state:
    returns (elem, active') as the JAX step's masking does
    (``where(active, locate, INVALID)``, then ``elem >= 0``).  Kernel A on
    CUDA tensors (reading the locator's :meth:`~AnnulusLocator2D.sector_table`
    and :meth:`~AnnulusLocator2D.scalars`, each computed once), and
    :func:`annulus_locate_plain` on CPU tensors."""
    tensors = [px, py, active] + ([] if loc.perm is None else [loc.perm])
    if not kernels.use_kernel("annulus_locate", *tensors):
        return annulus_locate_plain(loc, px, py, active)
    n = px.shape[0]
    if px.dtype != torch.float32 or py.dtype != torch.float32 \
            or active.dtype != torch.bool or px.dim() != 1 \
            or py.shape != (n,) or active.shape != (n,):
        raise ValueError("annulus_locate: f32 (N,) px, py and bool active "
                         "expected")
    if loc.perm is not None and (loc.perm.dtype != torch.int32 or
                                 loc.perm.shape != (2 * loc.n_rings * loc.n_sectors,)):
        raise ValueError("annulus_locate: perm must be (E,) i32")
    if not 1 <= loc.n_sectors < MAX_SECTORS:
        raise ValueError(f"annulus_locate: {loc.n_sectors} sectors; the sector "
                         f"index is exact in f32 below {MAX_SECTORS}")
    elem = torch.empty(n, dtype=torch.int32, device=px.device)
    act = torch.empty(n, dtype=torch.bool, device=px.device)
    if n == 0:
        return elem, act
    table = loc.sector_table(px.device)
    sc = loc.scalars()
    P = ctypes.c_void_p
    err = _build.lib().pp_annulus_locate(
        P(px.data_ptr()), P(py.data_ptr()), P(active.data_ptr()), n,
        loc.cx, loc.cy, loc.theta0, sc["two_pi"], sc["dth"], sc["m"],
        loc.r_in, loc.dr, sc["lo"], sc["hi"], loc.n_rings, loc.n_sectors,
        P(table.data_ptr()), P(None if loc.perm is None else loc.perm.data_ptr()),
        P(elem.data_ptr()), P(act.data_ptr()), P(kernels.stream_handle()))
    _build.check(err, "annulus_locate")
    kernels.LAUNCHES["annulus_locate"] += 1
    return elem, act


# ---------------------------------------------------------------------------
# kernel K: straight-line push + periodic wrap + Kuhn-box locate
# ---------------------------------------------------------------------------

def _f32(v) -> float:
    return float(np.float32(v))


def kuhn_locate_plain(loc: KuhnLocator3D, px, py, pz, eps: float = 1e-6):
    """(elem, inside) of every point in ``KuhnLocator3D.locate``'s f32
    order: INVALID outside the box (tolerance ``eps`` cells), the
    canonical id mapped through ``perm`` where given."""
    o, ih = loc.origin, loc.inv_h
    n = (loc.nx, loc.ny, loc.nz)
    r = [(p - o[j]) * ih[j] for j, p in enumerate((px, py, pz))]
    inside = torch.ones_like(px, dtype=torch.bool)
    for j in range(3):
        inside = inside & (r[j] >= _f32(-eps)) & (r[j] <= _f32(n[j] + eps))
    i = [torch.clamp(torch.floor(r[j]), 0.0, n[j] - 1.0) for j in range(3)]
    fx, fy, fz = (r[j] - i[j] for j in range(3))
    b1, b2, b3 = fx >= fy, fy >= fz, fx >= fz
    # path order (x,y,z) (x,z,y) (y,x,z) (y,z,x) (z,x,y) (z,y,x): the
    # descent ordering of (fx, fy, fz)
    idx = torch.where(b1, torch.where(b2, 0.0, torch.where(b3, 1.0, 4.0)),
                      torch.where(b2, torch.where(b3, 2.0, 3.0), 5.0))
    elem = ((i[0] * float(loc.ny) + i[1]) * float(loc.nz) + i[2]) * 6.0 + idx
    elem = torch.where(inside, elem, float(INVALID)).to(torch.int32)
    if loc.perm is not None:
        elem = torch.where(elem >= 0, loc.perm[torch.clamp(elem, min=0).long()], elem)
    return elem, inside


def kuhn_push_locate_plain(loc: KuhnLocator3D, x: torch.Tensor,
                           active: torch.Tensor, step=None, wrap=None):
    """Plain version of kernel K: (x', elem) with x' the pushed and wrapped
    (N, 3) positions of every slot and elem the located tet of the active
    ones (INVALID for inactive or outside points)."""
    xn = push_and_wrap_plain(x, step, wrap)
    elem, _ = kuhn_locate_plain(loc, xn[:, 0], xn[:, 1], xn[:, 2])
    return xn, torch.where(active, elem, INVALID)


def kuhn_push_locate(loc: KuhnLocator3D, x: torch.Tensor, active: torch.Tensor,
                     step=None, wrap=None):
    """Push every slot's (N, 3) f32 position by ``step`` (a (3,) f32
    displacement, or None for none), wrap it into the box with ``wrap`` =
    (lo, ext) (or None), and locate the active ones on the Kuhn box:
    returns (x', elem), the JAX step's ``straight_line_push``, wrap and
    ``where(active, kuhn.locate(x'), INVALID)``.  Kernel K on CUDA tensors,
    :func:`kuhn_push_locate_plain` on CPU tensors."""
    tensors = [x, active] + ([] if loc.perm is None else [loc.perm])
    if not kernels.use_kernel("kuhn_locate", *tensors):
        return kuhn_push_locate_plain(loc, x, active, step, wrap)
    n = x.shape[0]
    if x.dtype != torch.float32 or x.shape != (n, 3) or active.dtype != torch.bool \
            or active.shape != (n,):
        raise ValueError("kuhn_locate: (N, 3) f32 x and (N,) bool active expected")
    E = 6 * loc.nx * loc.ny * loc.nz
    if E >= 1 << 24:
        raise ValueError("kuhn_locate: ids are computed in f32, exact below 2^24")
    if loc.perm is not None and (loc.perm.dtype != torch.int32 or loc.perm.shape != (E,)):
        raise ValueError("kuhn_locate: perm must be (E,) i32")
    x_out = torch.empty_like(x)
    elem = torch.empty(n, dtype=torch.int32, device=x.device)
    if n == 0:
        return x_out, elem
    s = np.zeros(3, np.float32) if step is None else np.asarray(step, np.float32)
    lo, ext = (np.zeros(3, np.float32),) * 2 if wrap is None else (
        np.asarray(a, np.float32) for a in wrap)
    eps = 1e-6
    F = ctypes.c_float
    consts = [_f32(-eps), _f32(loc.nx + eps), _f32(loc.ny + eps), _f32(loc.nz + eps)]
    P = ctypes.c_void_p
    err = _build.lib().pp_kuhn_push_locate(
        P(x.data_ptr()), P(active.data_ptr()), n, int(step is not None),
        int(wrap is not None), (F * 9)(*s, *lo, *ext),
        (F * 6)(*loc.origin, *loc.inv_h), loc.nx, loc.ny, loc.nz, (F * 4)(*consts),
        P(None if loc.perm is None else loc.perm.data_ptr()),
        P(x_out.data_ptr()), P(elem.data_ptr()), P(kernels.stream_handle()))
    _build.check(err, "kuhn_locate")
    kernels.LAUNCHES["kuhn_locate"] += 1
    return x_out, elem
