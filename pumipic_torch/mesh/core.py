"""Simplex meshes frozen into tensors (port of ``pumipic_tpu.mesh.core``:
``Mesh2D`` triangles and ``Mesh3D`` tets).

Adjacencies are derived once on the host (:mod:`.adjacency`); the walk
reads one packed float32 row per step, ``walk_geom``.  Triangles, (E, 12):

    [a11 a12 c1, a21 a22 c2, xnbr0..2, xedge0..2]

the barycentric weights as affine forms l_k(x) = A_k·x + c_k, then the
neighbour and edge ids across the exit side of most-negative vertex k,
stored as f32 (exact below 2^24) and pre-permuted by (k+1)%3.  Tets, (E, 16):

    [A1 c1, A2 c2, A3 c3, nbr0..3]

with nbr k the neighbour across face k (opposite vertex k); ``walk_planes``
(E, 20) holds each face's outward unit plane [nx ny nz d] and the same
neighbours.  The tables are bit-equal to the JAX package's.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch

from pumipic_torch.mesh import adjacency as adj
from pumipic_torch.utils.device import resolve_device
from pumipic_torch.utils.types import LID_DTYPE, REAL_DTYPE

F32_EXACT_ID_LIMIT = 1 << 24


def check_f32_ids(n_elems: int, n_sides: int) -> None:
    """Element and side (edge or face) ids ride ``walk_geom`` as f32
    values: exact only below 2^24."""
    if n_elems >= F32_EXACT_ID_LIMIT or n_sides >= F32_EXACT_ID_LIMIT:
        raise ValueError("mesh too large for f32-packed walk ids (2^24)")


def walk_geom_table(coords: np.ndarray, ev: np.ndarray, elem2edges: np.ndarray,
                    edge2elems: np.ndarray):
    """(E, 12) f32 walk table plus the f64 (v0, inverse basis) it is
    rounded from."""
    E = ev.shape[0]
    p = coords[ev]                                               # (E, 3, 2) f64
    basis = np.stack([p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]], axis=-1)
    inv_basis = np.linalg.inv(basis)
    geom = np.zeros((E, 12), np.float32)
    c_aff = -np.einsum("eij,ej->ei", inv_basis, p[:, 0])         # (E, 2)
    geom[:, 0:2] = inv_basis[:, 0, :].astype(np.float32)
    geom[:, 2] = c_aff[:, 0].astype(np.float32)
    geom[:, 3:5] = inv_basis[:, 1, :].astype(np.float32)
    geom[:, 5] = c_aff[:, 1].astype(np.float32)
    e2e = edge2elems[elem2edges]                                 # (E, 3, 2)
    self_ids = np.arange(E)[:, None]
    nbrs = np.where(e2e[:, :, 0] == self_ids, e2e[:, :, 1], e2e[:, :, 0])
    perm = [1, 2, 0]        # exit side for most-negative vertex k: edge (k+1)%3
    geom[:, 6:9] = nbrs[:, perm].astype(np.float32)
    geom[:, 9:12] = elem2edges[:, perm].astype(np.float32)
    return geom, p[:, 0], inv_basis


class _MeshBase:
    """Accessors shared by :class:`Mesh2D` and :class:`Mesh3D`."""

    @property
    def device(self) -> torch.device:
        return self.walk_geom.device

    @property
    def elem_centroids(self) -> torch.Tensor:
        """(E, dim) f32 vertex means."""
        return self.coords[self.elem2verts.long()].mean(dim=1)

    def ask_elem_verts(self) -> torch.Tensor:
        return self.elem2verts

    def get_tag(self, dim: int, name: str) -> torch.Tensor:
        """The element tag ``name`` (``dim`` = the mesh's dimension) or the
        vertex tag (any other ``dim``)."""
        return self.elem_tags[name] if dim == self.dim else self.vert_tags[name]

    def set_tag(self, dim: int, name: str, arr: torch.Tensor):
        """A copy of the mesh with the element (``dim`` = the mesh's
        dimension) or vertex tag ``name`` set to ``arr``."""
        key = "elem_tags" if dim == self.dim else "vert_tags"
        return dataclasses.replace(self, **{key: {**getattr(self, key), name: arr}})

    def to(self, device):
        """The mesh with its tensors and tags on ``device``."""
        def move(v):
            if isinstance(v, torch.Tensor):
                return v.to(device)
            return {k: t.to(device) for k, t in v.items()}

        return dataclasses.replace(self, **{
            f.name: move(getattr(self, f.name)) for f in dataclasses.fields(self)
            if f.init and isinstance(getattr(self, f.name), (torch.Tensor, dict))})

    @classmethod
    def _freeze(cls, arrays: dict, ints, reals, device, **sizes):
        """Host arrays (the named fields) as tensors on ``device`` with the
        port's dtypes: i32 ids, f32 reals, bool ``side_is_exposed``."""
        device = resolve_device(device)
        t = {k: torch.as_tensor(np.asarray(arrays[k]).astype(np.int32),
                                device=device) for k in ints}
        t.update({k: torch.as_tensor(np.asarray(arrays[k]).astype(np.float32),
                                     device=device) for k in reals})
        t["side_is_exposed"] = torch.as_tensor(
            np.asarray(arrays["side_is_exposed"]).astype(bool), device=device)
        assert t["walk_geom"].dtype == REAL_DTYPE
        assert t["elem2verts"].dtype == LID_DTYPE
        return cls(**t, nelems=int(t["elem2verts"].shape[0]),
                   nverts=int(t["coords"].shape[0]), **{
                       k: int(t[v].shape[0]) for k, v in sizes.items()})


@dataclass(frozen=True)
class Mesh2D(_MeshBase):
    """Immutable 2D triangle mesh.  Edge ``i`` of a triangle connects local
    verts ``(i, (i+1)%3)``; triangles are CCW."""

    coords: torch.Tensor             # (V, 2) f32
    elem2verts: torch.Tensor         # (E, 3) i32
    elem2edges: torch.Tensor         # (E, 3) i32
    edge2verts: torch.Tensor         # (Ned, 2) i32
    edge2elems: torch.Tensor         # (Ned, 2) i32, -1 where boundary
    side_is_exposed: torch.Tensor    # (Ned,) bool
    elem_area: torch.Tensor          # (E,) f32
    elem_v0: torch.Tensor            # (E, 2) f32
    elem_inv_basis: torch.Tensor     # (E, 2, 2) f32
    vert2elem_offsets: torch.Tensor  # (V+1,) i32 CSR
    vert2elem_vals: torch.Tensor     # (sum deg,) i32
    class_id: torch.Tensor           # (E,) i32 geometric-model classification
    walk_geom: torch.Tensor          # (E, 12) f32
    nelems: int = 0
    nverts: int = 0
    nedges: int = 0
    elem_tags: Dict[str, torch.Tensor] = field(default_factory=dict)
    vert_tags: Dict[str, torch.Tensor] = field(default_factory=dict)
    # tables the kernels derive from the mesh, with the tensors they were
    # derived from (ops.search.reflect_tangents); a mesh from
    # dataclasses.replace starts without them
    _derived: dict = field(default_factory=dict, init=False, repr=False,
                           compare=False)

    dim = 2

    @staticmethod
    def from_arrays(coords: np.ndarray, elem2verts: np.ndarray,
                    class_id: Optional[np.ndarray] = None,
                    device=None) -> "Mesh2D":
        device = resolve_device(device)
        a = adj.build_tri_adjacency(coords, elem2verts)
        ev = a["elem2verts"]
        check_f32_ids(ev.shape[0], a["edge2verts"].shape[0])
        geom, v0, inv_basis = walk_geom_table(
            a["coords"], ev, a["elem2edges"], a["edge2elems"])
        if class_id is None:
            class_id = np.ones(ev.shape[0], dtype=np.int64)
        return Mesh2D.from_numpy(dict(
            coords=a["coords"], elem2verts=ev, elem2edges=a["elem2edges"],
            edge2verts=a["edge2verts"], edge2elems=a["edge2elems"],
            side_is_exposed=a["side_is_exposed"], elem_area=a["elem_area"],
            elem_v0=v0, elem_inv_basis=inv_basis,
            vert2elem_offsets=a["vert2elem_offsets"],
            vert2elem_vals=a["vert2elem_vals"], class_id=class_id,
            walk_geom=geom), device)

    @staticmethod
    def from_numpy(arrays: dict, device=None) -> "Mesh2D":
        """Freeze host arrays (the field names above) into tensors on
        ``device`` with the port's dtypes."""
        return Mesh2D._freeze(
            arrays, ("elem2verts", "elem2edges", "edge2verts", "edge2elems",
                     "vert2elem_offsets", "vert2elem_vals", "class_id"),
            ("coords", "elem_area", "elem_v0", "elem_inv_basis", "walk_geom"),
            device, nedges="edge2verts")


def tet_walk_tables(coords: np.ndarray, ev: np.ndarray, elem2faces: np.ndarray,
                    face2elems: np.ndarray):
    """(walk_geom (E, 16) f32, walk_planes (E, 20) f32, v0, inverse basis)
    of a tet mesh, as the JAX package's ``Mesh3D.from_arrays`` makes them."""
    E = ev.shape[0]
    p = coords[ev]                                               # (E, 4, 3) f64
    basis = np.stack([p[:, 1] - p[:, 0], p[:, 2] - p[:, 0], p[:, 3] - p[:, 0]],
                     axis=-1)
    inv_basis = np.linalg.inv(basis)
    geom = np.zeros((E, 16), np.float32)
    c_aff = -np.einsum("eij,ej->ei", inv_basis, p[:, 0])         # (E, 3)
    for k in range(3):
        geom[:, 4 * k:4 * k + 3] = inv_basis[:, k, :].astype(np.float32)
        geom[:, 4 * k + 3] = c_aff[:, k].astype(np.float32)
    f2e = face2elems[elem2faces]                                 # (E, 4, 2)
    self_ids = np.arange(E)[:, None]
    nbrs = np.where(f2e[:, :, 0] == self_ids, f2e[:, :, 1], f2e[:, :, 0])
    geom[:, 12:16] = nbrs.astype(np.float32)
    # outward unit face planes (face i opposite vertex i)
    planes = np.zeros((E, 20), np.float32)
    for i, fv in enumerate(adj.TET_FACE_VERTS):
        fa, fb, fc = p[:, fv[0]], p[:, fv[1]], p[:, fv[2]]
        nrm = np.cross(fb - fa, fc - fa)
        nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-300)
        planes[:, 4 * i:4 * i + 3] = nrm.astype(np.float32)
        planes[:, 4 * i + 3] = np.einsum("ei,ei->e", nrm, fa).astype(np.float32)
    planes[:, 16:20] = nbrs.astype(np.float32)
    return geom, planes, p[:, 0], inv_basis


@dataclass(frozen=True)
class Mesh3D(_MeshBase):
    """Immutable 3D tetrahedral mesh.  Face ``i`` is opposite local vertex
    ``i`` with outward orientation; tets are positively oriented."""

    coords: torch.Tensor             # (V, 3) f32
    elem2verts: torch.Tensor         # (E, 4) i32
    elem2faces: torch.Tensor         # (E, 4) i32
    face2verts: torch.Tensor         # (Nf, 3) i32
    face2elems: torch.Tensor         # (Nf, 2) i32, -1 where boundary
    side_is_exposed: torch.Tensor    # (Nf,) bool
    elem_volume: torch.Tensor        # (E,) f32
    elem_v0: torch.Tensor            # (E, 3) f32
    elem_inv_basis: torch.Tensor     # (E, 3, 3) f32
    vert2elem_offsets: torch.Tensor  # (V+1,) i32 CSR
    vert2elem_vals: torch.Tensor     # (sum deg,) i32
    class_id: torch.Tensor           # (E,) i32
    walk_geom: torch.Tensor          # (E, 16) f32
    walk_planes: torch.Tensor        # (E, 20) f32
    nelems: int = 0
    nverts: int = 0
    nfaces: int = 0
    elem_tags: Dict[str, torch.Tensor] = field(default_factory=dict)
    vert_tags: Dict[str, torch.Tensor] = field(default_factory=dict)
    # tables the kernels derive from the mesh, with the tensors they were
    # derived from (ops.search.reflect_normals); a mesh from
    # dataclasses.replace starts without them
    _derived: dict = field(default_factory=dict, init=False, repr=False,
                           compare=False)

    dim = 3

    @staticmethod
    def from_arrays(coords: np.ndarray, elem2verts: np.ndarray,
                    class_id: Optional[np.ndarray] = None,
                    device=None) -> "Mesh3D":
        device = resolve_device(device)
        a = adj.build_tet_adjacency(coords, elem2verts)
        ev = a["elem2verts"]
        check_f32_ids(ev.shape[0], a["face2verts"].shape[0])
        geom, planes, v0, inv_basis = tet_walk_tables(
            a["coords"], ev, a["elem2faces"], a["face2elems"])
        if class_id is None:
            class_id = np.ones(ev.shape[0], dtype=np.int64)
        return Mesh3D.from_numpy(dict(
            coords=a["coords"], elem2verts=ev, elem2faces=a["elem2faces"],
            face2verts=a["face2verts"], face2elems=a["face2elems"],
            side_is_exposed=a["side_is_exposed"], elem_volume=a["elem_volume"],
            elem_v0=v0, elem_inv_basis=inv_basis,
            vert2elem_offsets=a["vert2elem_offsets"],
            vert2elem_vals=a["vert2elem_vals"], class_id=class_id,
            walk_geom=geom, walk_planes=planes), device)

    @staticmethod
    def from_numpy(arrays: dict, device=None) -> "Mesh3D":
        """Freeze host arrays (the field names above) into tensors on
        ``device`` with the port's dtypes."""
        return Mesh3D._freeze(
            arrays, ("elem2verts", "elem2faces", "face2verts", "face2elems",
                     "vert2elem_offsets", "vert2elem_vals", "class_id"),
            ("coords", "elem_volume", "elem_v0", "elem_inv_basis", "walk_geom",
             "walk_planes"), device, nfaces="face2verts")
