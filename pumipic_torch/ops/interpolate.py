"""Field interpolation (port of ``pumipic_tpu.ops.interpolate``).

Reference parity: ``src/pumipic_adjacency.hpp:772-799`` (``interpolateTetVtx``,
barycentric interpolation of a vertex field) and ``src/pumipic_utils.hpp:
186-457`` (the 2D/3D structured-grid interpolation ``interpolate2d*``,
``interpolate3d_field`` and ``interp2dVector`` of GITR-style inputs).  All
batched over particles, in the JAX package's f32 operation order.  The 3D
grid form is what the GITR-style app's step runs; kernel R
(:func:`pumipic_torch.ops.push.boris_push_grid`) fuses it with the Boris
push, and these plain functions are its reference.
"""
from __future__ import annotations

import torch


def interpolate_vtx_field(field: torch.Tensor, elem2verts: torch.Tensor,
                          elem: torch.Tensor, bcc: torch.Tensor) -> torch.Tensor:
    """Barycentric interpolation of a (V,) or (V, k) vertex field to the
    particles of elements ``elem`` (N,) with vertex weights ``bcc`` (N, nvpe);
    returns (N,) or (N, k), the weighted vertex values summed in vertex
    order."""
    verts = elem2verts[torch.clamp(elem, min=0).long()].long()    # (N, nvpe)
    vals = field[verts]                                          # (N, nvpe[, k])
    w = bcc if vals.ndim == 2 else bcc[..., None]
    out = w[:, 0] * vals[:, 0]
    for v in range(1, vals.shape[1]):
        out = out + w[:, v] * vals[:, v]
    return out


def _cell(rel: torch.Tensor, n: int):
    """(lower index (N,) long, fraction (N,)) of one axis: the index floored
    and clamped to [0, n - 2], the fraction clamped to [0, 1]."""
    i = torch.clamp(torch.floor(rel).to(torch.int32), 0, n - 2)
    return i.long(), torch.clamp(rel - i.to(rel.dtype), 0.0, 1.0)


def interpolate_2d_grid(grid: torch.Tensor, origin: torch.Tensor, dx: torch.Tensor,
                        pts: torch.Tensor) -> torch.Tensor:
    """Bilinear interpolation on a uniform (nx, ny[, k]) grid at (N, 2)
    points; ``origin`` and ``dx`` (2,) tensors (the division is IEEE, by a
    tensor).  Points outside clamp to the boundary cell."""
    rel = (pts - origin) / dx
    i, fx = _cell(rel[:, 0], grid.shape[0])
    j, fy = _cell(rel[:, 1], grid.shape[1])
    if grid.ndim == 3:
        fx, fy = fx[:, None], fy[:, None]
    return (grid[i, j] * (1 - fx) * (1 - fy) + grid[i + 1, j] * fx * (1 - fy)
            + grid[i, j + 1] * (1 - fx) * fy + grid[i + 1, j + 1] * fx * fy)


def interpolate_3d_grid(grid: torch.Tensor, origin: torch.Tensor, dx: torch.Tensor,
                        pts: torch.Tensor) -> torch.Tensor:
    """Trilinear interpolation on a uniform (nx, ny, nz[, k]) grid at (N, 3)
    points; ``origin`` and ``dx`` (3,) tensors.  The corner sum runs di,
    then dj, then dk, from 0.0, each weight a left-to-right product of the
    three axis factors."""
    rel = (pts - origin) / dx
    i, fi = _cell(rel[:, 0], grid.shape[0])
    j, fj = _cell(rel[:, 1], grid.shape[1])
    k, fk = _cell(rel[:, 2], grid.shape[2])
    if grid.ndim == 4:
        fi, fj, fk = fi[:, None], fj[:, None], fk[:, None]
    out = torch.zeros((), dtype=grid.dtype, device=grid.device)
    for di in (0, 1):
        for dj in (0, 1):
            for dk in (0, 1):
                w = ((fi if di else 1 - fi) * (fj if dj else 1 - fj)
                     * (fk if dk else 1 - fk))
                out = out + grid[i + di, j + dj, k + dk] * w
    return out


def interp_2d_vector(grid_rz: torch.Tensor, origin: torch.Tensor, dx: torch.Tensor,
                     pts: torch.Tensor, cylindrical: bool = True) -> torch.Tensor:
    """A vector field on an (r, z) grid (nr, nz, 3) evaluated at (N, 3)
    points, rotated from (r, θ, z) to cartesian components when
    ``cylindrical`` (``interp2dVector``)."""
    r = torch.sqrt(pts[:, 0] ** 2 + pts[:, 1] ** 2)
    rz = torch.stack([r, pts[:, 2]], dim=-1)
    v = interpolate_2d_grid(grid_rz, origin, dx, rz)
    if not cylindrical:
        return v
    theta = torch.atan2(pts[:, 1], pts[:, 0])
    ct, st = torch.cos(theta), torch.sin(theta)
    vx = v[:, 0] * ct - v[:, 1] * st
    vy = v[:, 0] * st + v[:, 1] * ct
    return torch.stack([vx, vy, v[:, 2]], dim=-1)
