"""Gmsh ASCII mesh reader (MSH 2.2 and 4.1), numpy only.

A copy of ``pumipic_tpu.mesh.gmsh`` so that the port reads meshes without
importing JAX; the parity tests hold the two readers equal.

The reference consumes Gmsh meshes through Omega_h (cube.msh, pisces/gitr.msh
in pumipic-data).  This reader covers the subset those files use: nodes +
2D triangle / 3D tetrahedral elements with physical/geometric tags, which
become ``class_id``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

TRI_TYPE = 2
TET_TYPE = 4


def read_msh(path: str, dim: Optional[int] = None
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Parse a .msh file (transparently gzip-decompressed for ``.gz`` paths);
    returns (coords, elem2verts, class_id).

    ``dim``: force 2 (triangles) or 3 (tets); default = highest present.
    """
    if str(path).endswith(".gz"):
        import gzip

        with gzip.open(path, "rt") as f:
            lines = f.read().splitlines()
    else:
        with open(path) as f:
            lines = f.read().splitlines()
    i = 0

    def seek(section):
        nonlocal i
        while i < len(lines) and lines[i].strip() != f"${section}":
            i += 1
        if i >= len(lines):
            return False
        i += 1
        return True

    version = 2.2
    j = 0
    while j < len(lines):
        if lines[j].strip() == "$MeshFormat":
            version = float(lines[j + 1].split()[0])
            break
        j += 1

    if version >= 4.1:
        return _read_msh4(lines, dim)
    if version >= 3.0:
        # MSH 4.0 and 3.x block layouts differ from both the 2.2 and 4.1
        # parsers (4.0 swaps the entity-header field order and inlines node
        # coordinates); routing them into the 4.1 parser produced
        # uninformative int() crashes or silently transposed blocks
        raise ValueError(
            f"unsupported MSH format version {version}: supported are "
            f"2.x and 4.1 (re-export with 'gmsh -format msh41' or msh2)")

    if not seek("Nodes"):
        raise ValueError("no $Nodes section")
    n_nodes = int(lines[i]); i += 1
    ids = np.zeros(n_nodes, np.int64)
    xyz = np.zeros((n_nodes, 3))
    for k in range(n_nodes):
        parts = lines[i + k].split()
        ids[k] = int(parts[0])
        xyz[k] = [float(x) for x in parts[1:4]]
    i += n_nodes
    id2idx = np.full(ids.max() + 1, -1, np.int64)
    id2idx[ids] = np.arange(n_nodes)

    if not seek("Elements"):
        raise ValueError("no $Elements section")
    n_elems = int(lines[i]); i += 1
    tris, tri_cls, tets, tet_cls = [], [], [], []
    for k in range(n_elems):
        parts = [int(x) for x in lines[i + k].split()]
        etype = parts[1]
        ntags = parts[2]
        tags = parts[3:3 + ntags]
        cls = tags[0] if tags else 1
        verts = parts[3 + ntags:]
        if etype == TRI_TYPE:
            tris.append(verts)
            tri_cls.append(cls)
        elif etype == TET_TYPE:
            tets.append(verts)
            tet_cls.append(cls)

    return _assemble(xyz, id2idx, tris, tri_cls, tets, tet_cls, dim)


def _read_msh4(lines, dim):
    i = 0

    def seek(section):
        nonlocal i
        while i < len(lines) and lines[i].strip() != f"${section}":
            i += 1
        if i >= len(lines):
            return False
        i += 1
        return True

    if not seek("Nodes"):
        raise ValueError("no $Nodes section")
    nb, n_nodes, _minid, maxid = (int(x) for x in lines[i].split()); i += 1
    id2idx = np.full(maxid + 1, -1, np.int64)
    xyz = np.zeros((n_nodes, 3))
    cursor = 0
    for _ in range(nb):
        _dim, _tag, _param, n_in_block = (int(x) for x in lines[i].split())
        i += 1
        node_ids = [int(lines[i + k]) for k in range(n_in_block)]
        i += n_in_block
        for k in range(n_in_block):
            xyz[cursor + k] = [float(x) for x in lines[i + k].split()[:3]]
            id2idx[node_ids[k]] = cursor + k
        cursor += n_in_block
        i += n_in_block

    if not seek("Elements"):
        raise ValueError("no $Elements section")
    nb, n_elems, _minid, _maxid = (int(x) for x in lines[i].split()); i += 1
    tris, tri_cls, tets, tet_cls = [], [], [], []
    for _ in range(nb):
        _edim, etag, etype, n_in_block = (int(x) for x in lines[i].split())
        i += 1
        for k in range(n_in_block):
            parts = [int(x) for x in lines[i + k].split()]
            verts = parts[1:]
            if etype == TRI_TYPE:
                tris.append(verts)
                tri_cls.append(etag)
            elif etype == TET_TYPE:
                tets.append(verts)
                tet_cls.append(etag)
        i += n_in_block

    return _assemble(xyz, id2idx, tris, tri_cls, tets, tet_cls, dim)


def _lookup_nodes(id2idx, conn):
    """Element node ids -> vertex indices, validating every id (a node id
    absent from $Nodes maps to -1, which numpy fancy indexing would
    silently wrap to the LAST vertex — a geometrically corrupt but
    structurally plausible mesh; round-5 review)."""
    conn = np.asarray(conn, np.int64)
    if conn.min() < 0 or conn.max() >= len(id2idx):
        raise ValueError(
            f"element references node id {conn.min() if conn.min() < 0 else conn.max()} "
            f"outside the $Nodes id range")
    ev = id2idx[conn]
    if (ev < 0).any():
        bad = conn[ev < 0]
        raise ValueError(
            f"element references node id(s) not listed in $Nodes "
            f"(e.g. {bad.flat[0]}) — truncated or corrupt file")
    return ev


def _assemble(xyz, id2idx, tris, tri_cls, tets, tet_cls, dim):
    use_tets = (dim == 3) or (dim is None and len(tets) > 0)
    if use_tets:
        if not tets:
            raise ValueError("no tetrahedra in mesh")
        ev = _lookup_nodes(id2idx, tets)
        return xyz, ev, np.asarray(tet_cls, np.int64)
    if not tris:
        raise ValueError("no triangles in mesh")
    ev = _lookup_nodes(id2idx, tris)
    return xyz[:, :2], ev, np.asarray(tri_cls, np.int64)


def write_msh2(path: str, coords: np.ndarray, elem2verts: np.ndarray,
               class_id: Optional[np.ndarray] = None) -> None:
    """Write MSH 2.2 ASCII (gzip-compressed for ``.gz`` paths; round-trip
    tests and interop)."""
    V = coords.shape[0]
    E, k = elem2verts.shape
    etype = TRI_TYPE if k == 3 else TET_TYPE
    if class_id is None:
        class_id = np.ones(E, np.int64)
    if str(path).endswith(".gz"):
        import gzip

        # the fastest level: the 1M-element mesh's 62 MB of text in
        # seconds, where level 9 (gzip.open's default) takes ~half a minute
        opener = lambda: gzip.open(path, "wt", compresslevel=1)  # noqa: E731
    else:
        opener = lambda: open(path, "w")  # noqa: E731
    with opener() as f:
        f.write("$MeshFormat\n2.2 0 8\n$EndMeshFormat\n$Nodes\n")
        f.write(f"{V}\n")
        for v in range(V):
            x = coords[v]
            z = x[2] if len(x) > 2 else 0.0
            f.write(f"{v + 1} {x[0]:.17g} {x[1]:.17g} {z:.17g}\n")
        f.write("$EndNodes\n$Elements\n")
        f.write(f"{E}\n")
        for e in range(E):
            verts = " ".join(str(v + 1) for v in elem2verts[e])
            f.write(f"{e + 1} {etype} 2 {class_id[e]} {class_id[e]} {verts}\n")
        f.write("$EndElements\n")
