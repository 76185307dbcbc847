"""Batched barycentric helpers (port of the parts of
``pumipic_tpu.ops.geometry`` that ``models/search2d.py`` needs).

Reference parity: ``src/pumipic_adjacency.hpp`` ``barycentric_tri``
(:75-94) and ``all_positive`` from ``pumipic_utils.hpp``.  ``w[k]`` is the
weight of local vertex ``k``.
"""
from __future__ import annotations

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


def all_positive(bcc: torch.Tensor, tol: float = 0.0) -> torch.Tensor:
    """(N,) bool: point inside element (``pumipic_utils.hpp`` all_positive)."""
    return torch.all(bcc >= -tol, dim=-1)
