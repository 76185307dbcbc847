"""Host-side (numpy) derivation of triangle-mesh adjacencies.

Given (coords, elem2verts) this derives elem→edge, edge→verts, edge→elems
(dual), exposed sides, vert→elems (CSR) and signed element areas, once on
the host; :mod:`pumipic_torch.mesh.core` freezes them into tensors.  The
results equal ``pumipic_tpu.mesh.adjacency.build_tri_adjacency``
element for element.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

# Edge i of a triangle connects local verts (i, (i+1)%3) and is opposite
# local vert (i+2)%3.
TRI_EDGE_VERTS = np.array([[0, 1], [1, 2], [2, 0]], dtype=np.int64)


def _unique_sides(side_verts: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Deduplicate per-element side vertex tuples.

    side_verts: (E*S, k) vertex ids of every element-side occurrence.
    Returns (unique_sides (Ns, k) keeping the first occurrence's orientation,
    inverse (E*S,) mapping occurrence -> unique side id).  Sides are
    numbered in order of first occurrence, as the JAX package's native
    hash dedup (``csrc/meshcore.cpp``, its default) numbers them.
    """
    key = np.sort(side_verts, axis=1)
    _, idx, inv = np.unique(key, axis=0, return_index=True, return_inverse=True)
    order = np.argsort(idx)               # sorted-unique ids by first occurrence
    rank = np.empty_like(order)
    rank[order] = np.arange(order.size)
    return side_verts[idx[order]], rank[inv.reshape(-1)]


def build_tri_adjacency(coords: np.ndarray, elem2verts: np.ndarray) -> Dict[str, np.ndarray]:
    """Adjacency bundle for a 2D triangle mesh.

    coords: (V, 2) float; elem2verts: (E, 3) int; clockwise triangles are
    flipped so every area is positive.
    """
    coords = np.asarray(coords, dtype=np.float64)
    ev = np.asarray(elem2verts, dtype=np.int64).copy()
    E = ev.shape[0]

    def cross2(u, v):  # z-component of 2D cross product (signed 2*area)
        return u[:, 0] * v[:, 1] - u[:, 1] * v[:, 0]

    p = coords[ev]  # (E, 3, 2)
    area2 = cross2(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
    flip = area2 < 0
    ev[flip] = ev[flip][:, [0, 2, 1]]
    p = coords[ev]
    area2 = cross2(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
    if np.any(area2 <= 0):
        raise ValueError("degenerate (zero-area) triangle in mesh")

    occ_flat = ev[:, TRI_EDGE_VERTS].reshape(-1, 2)  # (3E, 2)
    edge2verts, inv = _unique_sides(occ_flat)
    n_edges = edge2verts.shape[0]
    elem2edges = inv.reshape(E, 3)

    # dual: each edge borders 1 (boundary) or 2 elements
    edge2elems = np.full((n_edges, 2), -1, dtype=np.int64)
    occ_elem = np.repeat(np.arange(E, dtype=np.int64), 3)
    order = np.argsort(inv, kind="stable")
    sorted_inv = inv[order]
    sorted_elem = occ_elem[order]
    start = np.searchsorted(sorted_inv, np.arange(n_edges))
    end = np.searchsorted(sorted_inv, np.arange(n_edges), side="right")
    counts = end - start
    if np.any(counts > 2):
        raise ValueError("non-manifold edge (more than 2 adjacent triangles)")
    edge2elems[:, 0] = sorted_elem[start]
    has2 = counts == 2
    edge2elems[has2, 1] = sorted_elem[np.minimum(start + 1, len(sorted_elem) - 1)][has2]

    # vert -> elems CSR (elements in increasing id order per vertex)
    vert_ids = ev.reshape(-1)
    vorder = np.argsort(vert_ids, kind="stable")
    v2e_vals = occ_elem[vorder]
    V = coords.shape[0]
    v2e_offsets = np.zeros(V + 1, dtype=np.int64)
    np.add.at(v2e_offsets, vert_ids + 1, 1)
    v2e_offsets = np.cumsum(v2e_offsets)

    return {
        "coords": coords,
        "elem2verts": ev,
        "elem2edges": elem2edges,
        "edge2verts": edge2verts,
        "edge2elems": edge2elems,
        "side_is_exposed": counts == 1,
        "elem_area": area2 / 2.0,
        "vert2elem_offsets": v2e_offsets,
        "vert2elem_vals": v2e_vals,
    }
