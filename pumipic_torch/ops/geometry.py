"""Batched geometric helpers (port of ``pumipic_tpu.ops.geometry``).

Reference parity (``src/pumipic_adjacency.hpp``): ``barycentric_tri``
(:75-94), ``find_barycentric_tet`` (:97-133), ``ray_intersects_triangle``
Möller–Trumbore (``adjacency.tpp:152-178``), ``closest_point_on_triangle``
(:910-1009), plus ``all_positive``/``min_index`` from ``pumipic_utils.hpp``.

Every function is batched over a leading particle axis and repeats the JAX
package's f32 operations in its order (sums of three terms left to right),
so the two agree bit for bit where their inputs do.  ``w[k]`` is the weight
of local vertex ``k``; in 2D the side opposite vertex ``k`` is edge
``(k+1) % 3``, in 3D face ``i`` is opposite vertex ``i``.
"""
from __future__ import annotations

from typing import Tuple

import torch


def bcc_2d(inv_basis: torch.Tensor, v0: torch.Tensor,
           pts: torch.Tensor) -> torch.Tensor:
    """Barycentric vertex weights in triangles.

    inv_basis: (N, 2, 2) per-point element inverse bases; v0: (N, 2)
    element origin vertex; pts: (N, 2) query points.  Returns (N, 3)
    weights summing to 1; all >= 0 iff the point is inside.
    """
    d = pts - v0
    lam0 = inv_basis[:, 0, 0] * d[:, 0] + inv_basis[:, 0, 1] * d[:, 1]
    lam1 = inv_basis[:, 1, 0] * d[:, 0] + inv_basis[:, 1, 1] * d[:, 1]
    w0 = 1.0 - lam0 - lam1
    return torch.stack([w0, lam0, lam1], dim=-1)


def bcc_3d(inv_basis: torch.Tensor, v0: torch.Tensor,
           pts: torch.Tensor) -> torch.Tensor:
    """Barycentric vertex weights in tets: (N, 3, 3) inverse bases, (N, 3)
    origin vertices and points -> (N, 4)."""
    d = pts - v0
    lam = [inv_basis[:, i, 0] * d[:, 0] + inv_basis[:, i, 1] * d[:, 1]
           + inv_basis[:, i, 2] * d[:, 2] for i in range(3)]
    w0 = 1.0 - (lam[0] + lam[1] + lam[2])
    return torch.stack([w0] + lam, dim=-1)


def all_positive(bcc: torch.Tensor, tol: float = 0.0) -> torch.Tensor:
    """(N,) bool: point inside element (``pumipic_utils.hpp`` all_positive)."""
    return torch.all(bcc >= -tol, dim=-1)


def min_index(bcc: torch.Tensor) -> torch.Tensor:
    """(N,) i32 index of the smallest coordinate (the most violated side;
    the first on ties)."""
    return torch.argmin(bcc, dim=-1).to(torch.int32)


def exit_edge_2d(bcc: torch.Tensor) -> torch.Tensor:
    """Local edge to cross in a triangle: the edge opposite the argmin
    vertex."""
    return ((min_index(bcc) + 1) % 3).to(torch.int32)


def tri_area_2d(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Signed area of 2D triangles, (N, 2) corners -> (N,)."""
    ab = b - a
    ac = c - a
    return 0.5 * (ab[..., 0] * ac[..., 1] - ab[..., 1] * ac[..., 0])


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root (IEEE, as a kernel's sqrtf and
    XLA's): taken in f64 and rounded once.  torch's f32 sqrt differs
    between its CUDA and CPU builds in the last bit of ~0.7% of values, so
    a plain version that must equal a kernel, or the card the CPU, takes
    this one."""
    return torch.sqrt(x.double()).to(x.dtype)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise cross product in ``jnp.cross``'s operation order."""
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise dot product of (…, 3) rows, summed left to right."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def moller_trumbore(orig: torch.Tensor, direc: torch.Tensor, va: torch.Tensor,
                    vb: torch.Tensor, vc: torch.Tensor, tol: float = 1e-10
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched Möller–Trumbore ray/triangle intersection: (N, 3) ray origin
    and (unnormalised) direction, (N, 3) triangle corners.  Returns (hit
    (N,) bool, t (N,) ray parameter, inf where no hit); a hit needs
    0 <= u, v, u + v <= 1 and t >= 0 within ``tol``."""
    e1 = vb - va
    e2 = vc - va
    pvec = cross(direc, e2)
    det = _dot(e1, pvec)
    near_zero = det.abs() < tol
    inv_det = torch.where(near_zero, 0.0,
                          1.0 / torch.where(near_zero, torch.ones_like(det), det))
    tvec = orig - va
    u = _dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = _dot(direc, qvec) * inv_det
    t = _dot(e2, qvec) * inv_det
    hit = (~near_zero) & (u >= -tol) & (v >= -tol) & (u + v <= 1.0 + tol) & (t >= -tol)
    return hit, torch.where(hit, t, torch.inf)


def _safe(den: torch.Tensor) -> torch.Tensor:
    return torch.where(den == 0, torch.ones_like(den), den)


def closest_point_on_triangle(p: torch.Tensor, va: torch.Tensor, vb: torch.Tensor,
                              vc: torch.Tensor) -> torch.Tensor:
    """Batched closest point on the triangle (va, vb, vc) to p, (N, 3) ->
    (N, 3): the branch-free form of the region algorithm (Ericson RTCD
    §5.1.5), the interior projection overridden by the edge regions BC, AC,
    AB, then the vertex regions C, B, A (the last match wins)."""
    ab = vb - va
    ac = vc - va
    ap = p - va
    d1 = _dot(ab, ap)
    d2 = _dot(ac, ap)
    bp = p - vb
    d3 = _dot(ab, bp)
    d4 = _dot(ac, bp)
    cp = p - vc
    d5 = _dot(ab, cp)
    d6 = _dot(ac, cp)

    va_ = d3 * d6 - d5 * d4
    vb_ = d5 * d2 - d1 * d6
    vc_ = d1 * d4 - d3 * d2

    t_ab = torch.clamp(d1 / _safe(d1 - d3), 0.0, 1.0)

    denom = _safe(va_ + vb_ + vc_)
    v = vb_ / denom
    w = vc_ / denom
    res = va + v[..., None] * ab + w[..., None] * ac

    num_bc = d4 - d3
    den_bc = (d4 - d3) + (d5 - d6)
    t_bc = torch.clamp(num_bc / _safe(den_bc), 0.0, 1.0)
    on_bc = (va_ <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0)
    res = torch.where(on_bc[..., None], vb + t_bc[..., None] * (vc - vb), res)

    t_ac = torch.clamp(d2 / _safe(d2 - d6), 0.0, 1.0)
    on_ac = (vb_ <= 0) & (d2 >= 0) & (d6 <= 0)
    res = torch.where(on_ac[..., None], va + t_ac[..., None] * ac, res)

    on_ab = (vc_ <= 0) & (d1 >= 0) & (d3 <= 0)
    res = torch.where(on_ab[..., None], va + t_ab[..., None] * ab, res)

    res = torch.where(((d6 >= 0) & (d5 <= d6))[..., None], vc, res)
    res = torch.where(((d3 >= 0) & (d4 <= d3))[..., None], vb, res)
    res = torch.where(((d1 <= 0) & (d2 <= 0))[..., None], va, res)
    return res


def segment_edge_intersect_2d(p0: torch.Tensor, p1: torch.Tensor, a: torch.Tensor,
                              b: torch.Tensor, tol: float = 1e-12
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched 2D segment (p0 -> p1) against segment (a -> b): (hit (N,),
    t (N,)), t the parameter along p0 -> p1 (inf where no hit)."""
    r = p1 - p0
    s = b - a
    denom = r[..., 0] * s[..., 1] - r[..., 1] * s[..., 0]
    near0 = denom.abs() < tol
    inv = torch.where(near0, 0.0, 1.0 / torch.where(near0, torch.ones_like(denom), denom))
    qp = a - p0
    t = (qp[..., 0] * s[..., 1] - qp[..., 1] * s[..., 0]) * inv
    u = (qp[..., 0] * r[..., 1] - qp[..., 1] * r[..., 0]) * inv
    hit = (~near0) & (t >= -tol) & (t <= 1 + tol) & (u >= -tol) & (u <= 1 + tol)
    return hit, torch.where(hit, t, torch.inf)
