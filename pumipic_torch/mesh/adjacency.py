"""Host-side (numpy) derivation of simplex-mesh adjacencies.

Given (coords, elem2verts) this derives, once on the host:

- triangle meshes: elem→edge, edge→verts, edge→elems (dual), exposed
  sides, vert→elems (CSR) and signed element areas;
- tet meshes: elem→face, face→verts, face→elems (dual), exposed sides,
  vert→elems (CSR) and element volumes.

:mod:`pumipic_torch.mesh.core` freezes them into tensors.  The results
equal ``pumipic_tpu.mesh.adjacency``'s ``build_tri_adjacency`` and
``build_tet_adjacency`` element for element.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

# Edge i of a triangle connects local verts (i, (i+1)%3) and is opposite
# local vert (i+2)%3.
TRI_EDGE_VERTS = np.array([[0, 1], [1, 2], [2, 0]], dtype=np.int64)

# The 4 faces of a tet: face i is opposite vertex i, its vertex triple
# oriented so the normal points outward for a positively oriented tet
# (det[v1-v0, v2-v0, v3-v0] > 0).
TET_FACE_VERTS = np.array(
    [[1, 2, 3], [0, 3, 2], [0, 1, 3], [0, 2, 1]], dtype=np.int64
)


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
    # dual: each edge borders 1 (boundary) or 2 elements
    edge2elems, counts = _dual(inv, E, 3, n_edges,
                               "edge (more than 2 adjacent triangles)")
    v2e_offsets, v2e_vals = _vert2elem(ev, coords.shape[0])
    return {
        "coords": coords,
        "elem2verts": ev,
        "elem2edges": inv.reshape(E, 3),
        "edge2verts": edge2verts,
        "edge2elems": edge2elems,
        "side_is_exposed": counts == 1,
        "elem_area": area2 / 2.0,
        "vert2elem_offsets": v2e_offsets,
        "vert2elem_vals": v2e_vals,
    }


def _dual(inv: np.ndarray, E: int, S: int, n_sides: int, what: str):
    """(side2elems (Ns, 2) with -1 on the boundary, counts (Ns,)): the
    elements of each side in element order."""
    side2elems = np.full((n_sides, 2), -1, dtype=np.int64)
    occ_elem = np.repeat(np.arange(E, dtype=np.int64), S)
    order = np.argsort(inv, kind="stable")
    sorted_inv = inv[order]
    sorted_elem = occ_elem[order]
    start = np.searchsorted(sorted_inv, np.arange(n_sides))
    end = np.searchsorted(sorted_inv, np.arange(n_sides), side="right")
    counts = end - start
    if np.any(counts > 2):
        raise ValueError(f"non-manifold {what}")
    side2elems[:, 0] = sorted_elem[start]
    has2 = counts == 2
    side2elems[has2, 1] = sorted_elem[np.minimum(start + 1, len(sorted_elem) - 1)][has2]
    return side2elems, counts


def _vert2elem(ev: np.ndarray, V: int):
    """vert -> elems CSR (offsets, vals), elements in increasing id order."""
    E, S = ev.shape
    vert_ids = ev.reshape(-1)
    vorder = np.argsort(vert_ids, kind="stable")
    vals = np.repeat(np.arange(E, dtype=np.int64), S)[vorder]
    offsets = np.zeros(V + 1, dtype=np.int64)
    np.add.at(offsets, vert_ids + 1, 1)
    return np.cumsum(offsets), vals


def build_tet_adjacency(coords: np.ndarray, elem2verts: np.ndarray) -> Dict[str, np.ndarray]:
    """Adjacency bundle for a 3D tetrahedral mesh.

    coords: (V, 3); elem2verts: (E, 4), reordered (verts 2 and 3 swapped)
    to positive volume.
    """
    coords = np.asarray(coords, dtype=np.float64)
    ev = np.asarray(elem2verts, dtype=np.int64).copy()
    E = ev.shape[0]

    def vol6_of(p):
        return np.einsum("ei,ei->e", p[:, 3] - p[:, 0],
                         np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]))

    flip = vol6_of(coords[ev]) < 0
    ev[flip] = ev[flip][:, [0, 1, 3, 2]]
    vol6 = vol6_of(coords[ev])
    if np.any(vol6 <= 0):
        raise ValueError("degenerate (zero-volume) tet in mesh")

    face2verts, inv = _unique_sides(ev[:, TET_FACE_VERTS].reshape(-1, 3))
    n_faces = face2verts.shape[0]
    face2elems, counts = _dual(inv, E, 4, n_faces,
                               "face (more than 2 adjacent tets)")
    v2e_offsets, v2e_vals = _vert2elem(ev, coords.shape[0])
    return {
        "coords": coords,
        "elem2verts": ev,
        "elem2faces": inv.reshape(E, 4),
        "face2verts": face2verts,
        "face2elems": face2elems,
        "side_is_exposed": counts == 1,
        "elem_volume": vol6 / 6.0,
        "vert2elem_offsets": v2e_offsets,
        "vert2elem_vals": v2e_vals,
    }
