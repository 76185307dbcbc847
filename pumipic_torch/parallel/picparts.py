"""PICparts: replication-based mesh distribution, built on the host (port
of ``pumipic_tpu.parallel.picparts``).

Every rank owns a *core* of mesh elements plus BFS-buffered copies of
neighbouring cores; the *safe zone* around the core lets particles move
without a transfer; a lower-dimension entity is owned by the least owner
of its adjacent elements; each picpart is a renumbered mesh with global-id
maps (``src/pumipic_part_construct.cpp``, ``pumipic_input.hpp``).

The build is numpy, deterministic, and the same on every rank:
:func:`build_picparts` returns a :class:`PicParts` holding the JAX
package's stacked (R, ...) tables bit for bit (padded with -1 where a rank
has fewer entities) and each rank's host mesh arrays;
:meth:`PicParts.local_view` puts one rank's picpart (its unpadded mesh and
its rows of the tables) on a device.  The exchange tables per entity
dimension (``Mesh::setupComm``, src/pumipic_comm.cpp:12-184):

- ``*_send_ids[r, s, k]``: rank r's local ids of its copies owned by s
  (the fan-in route), -1 padded;
- ``*_recv_ids[r, s, k]``: the matching local ids on the owner r of the
  copies rank s holds.

Buffer policies (``Input::FULL/BFS/MINIMUM/NONE``): FULL replicates the
whole mesh; BFS grows ``buffer_layers`` rings over the bridge entities and
marks elements within ``safe_layers`` of the core safe; MINIMUM is one
layer and no safe ring; NONE buffers nothing.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from itertools import combinations
from typing import Dict, List, Optional

import numpy as np
import torch

from pumipic_torch import native
from pumipic_torch.mesh import adjacency as adj
from pumipic_torch.mesh.core import (
    Mesh2D,
    Mesh3D,
    check_f32_ids,
    tet_walk_tables,
    walk_geom_table,
)
from pumipic_torch.utils.device import resolve_device


class BufferMethod(Enum):
    FULL = "full"
    BFS = "bfs"
    MINIMUM = "minimum"
    NONE = "none"


@dataclass(frozen=True)
class PicPartsInput:
    """``pumipic::Input`` analog.  ``bridge_dim``: the entity dimension the
    BFS layers grow over (0 vertices, 1 edges, 2 faces in 3D)."""

    buffer_method: BufferMethod = BufferMethod.BFS
    buffer_layers: int = 3
    safe_layers: int = 1
    bridge_dim: int = 0


# the stacked (R, ...) int32 tables, as the JAX package's PicParts leaves
TABLES = ("elem_owner", "elem_gid", "elem_gid_sorted", "elem_gid_perm",
          "vert_owner", "vert_gid", "vert_send_ids", "vert_recv_ids",
          "elem_send_ids", "elem_recv_ids", "side_gid", "side_owner",
          "side_send_ids", "side_recv_ids")
TABLES_3D = ("edge2verts", "edge_gid", "edge_owner", "edge_send_ids",
             "edge_recv_ids")


@dataclass(frozen=True)
class LocalPicPart:
    """One rank's picpart on a device: its unpadded mesh and the rank's
    rows of the tables (ids i32, ``elem_safe`` bool)."""

    mesh: object
    rank: int
    num_ranks: int
    tables: Dict[str, torch.Tensor]

    def __getattr__(self, name):
        try:
            return self.__dict__["tables"][name]
        except KeyError:
            raise AttributeError(name) from None

    def comm_ids(self, dim: int):
        """(send_ids, recv_ids), each (R, K), for entity dimension ``dim``
        (feed them to :func:`pumipic_torch.parallel.reduce.reduce_comm_array`)."""
        return tuple(self.tables[f"{_prefix(dim, self.mesh.dim)}_{k}_ids"]
                     for k in ("send", "recv"))

    def comm_array_size(self, dim: int) -> int:
        return int(self.tables[f"{_prefix(dim, self.mesh.dim)}_gid"].shape[0])


def _prefix(dim: int, mdim: int) -> str:
    if dim == 0:
        return "vert"
    if dim == mdim:
        return "elem"
    if dim == mdim - 1:
        return "side"
    if dim == 1 and mdim == 3:
        return "edge"
    raise ValueError(f"dim {dim} invalid for a {mdim}D mesh")


@dataclass(frozen=True)
class PicParts:
    """Host picparts: the JAX package's stacked tables (numpy, (R, ...)),
    ``elem_safe`` (R, E) bool, and each rank's mesh arrays
    (``mesh_arrays[r]``, the fields of ``Mesh2D``/``Mesh3D``)."""

    num_ranks: int
    dim: int
    tables: Dict[str, np.ndarray]
    elem_safe: np.ndarray
    mesh_arrays: List[dict] = field(repr=False)
    nelems: int = 0                  # padded (largest) element count
    nverts: int = 0
    num_core_elems: int = 0

    def __getattr__(self, name):
        try:
            return self.__dict__["tables"][name]
        except KeyError:
            raise AttributeError(name) from None

    def local_nelems(self, r: int) -> int:
        return int((self.tables["elem_gid"][r] >= 0).sum())

    def local_nverts(self, r: int) -> int:
        return int((self.tables["vert_gid"][r] >= 0).sum())

    def local_mesh(self, r: int, device=None):
        cls = Mesh2D if self.dim == 2 else Mesh3D
        return cls.from_numpy(self.mesh_arrays[r], resolve_device(device))

    def local_view(self, r: int, device=None) -> LocalPicPart:
        """Rank ``r``'s picpart on ``device`` (default: the CUDA card)."""
        device = resolve_device(device)
        E, V = self.local_nelems(r), self.local_nverts(r)
        n_of = {"elem": E, "vert": V}
        out = {}
        for name, t in self.tables.items():
            row = t[r]
            if name.endswith(("_send_ids", "_recv_ids")):
                pass
            elif name.startswith(("elem", "vert")):
                row = row[:n_of[name[:4]]]
            else:                    # sides and 3D edges: drop padding
                row = row[:int((t[r].reshape(len(t[r]), -1)[:, 0] >= 0).sum())]
            out[name] = torch.as_tensor(np.ascontiguousarray(row),
                                        dtype=torch.int32, device=device)
        out["elem_safe"] = torch.as_tensor(self.elem_safe[r][:E], device=device)
        return LocalPicPart(self.local_mesh(r, device), r, self.num_ranks, out)


# ---------------------------------------------------------------------------
# partitioners and partition files
# ---------------------------------------------------------------------------

def partition_rcb(coords: np.ndarray, elem2verts: np.ndarray, num_ranks: int
                  ) -> np.ndarray:
    """Recursive coordinate bisection over element centroids."""
    cent = coords[elem2verts].mean(axis=1)
    E = cent.shape[0]
    owners = np.zeros(E, np.int64)

    def split(idx, ranks0, ranks1):
        n = ranks1 - ranks0
        if n == 1 or idx.size == 0:
            owners[idx] = ranks0
            return
        spread = cent[idx].max(0) - cent[idx].min(0)
        axis = int(np.argmax(spread))
        order = np.argsort(cent[idx, axis], kind="stable")
        n_left = (n // 2) * idx.size // n
        split(idx[order[:n_left]], ranks0, ranks0 + n // 2)
        split(idx[order[n_left:]], ranks0 + n // 2, ranks1)

    split(np.arange(E), 0, num_ranks)
    return owners


def partition_from_classification(class_id: np.ndarray,
                                  class_to_rank: Dict[int, int]) -> np.ndarray:
    """CLASSIFICATION partition: each element by its model region."""
    return np.asarray([class_to_rank[int(c)] for c in class_id], np.int64)


def write_ptn(path: str, owners: np.ndarray) -> None:
    """A .ptn partition file: one owner rank per element per line."""
    np.savetxt(path, np.asarray(owners, np.int64), fmt="%d")


def read_ptn(path: str) -> np.ndarray:
    return np.loadtxt(path, dtype=np.int64).reshape(-1)


def write_cpn(path: str, class_to_rank: Dict[int, int]) -> None:
    """A .cpn classification-partition file: the count, then
    '<class> <rank>' lines."""
    with open(path, "w") as f:
        f.write(f"{len(class_to_rank)}\n")
        for c, r in sorted(class_to_rank.items()):
            f.write(f"{c} {r}\n")


def read_cpn(path: str) -> Dict[int, int]:
    with open(path) as f:
        n = int(f.readline())
        out = {}
        for _ in range(n):
            c, r = f.readline().split()
            out[int(c)] = int(r)
    return out


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------

def _bridge_keys(elem2verts: np.ndarray, nverts: int, bridge_dim: int):
    """(E, K) bridge-entity ids per element and the key count: vertex ids
    (0), or globally deduplicated sorted vertex tuples (1 edges, 2 faces)."""
    if bridge_dim == 0:
        return np.asarray(elem2verts, np.int64), nverts
    k = elem2verts.shape[1]
    if not 0 < bridge_dim < k - 1:
        raise ValueError(f"bridge_dim {bridge_dim} invalid for {k - 1}D simplices")
    tuples = [np.sort(elem2verts[:, c], axis=1)
              for c in combinations(range(k), bridge_dim + 1)]
    uniq, inv = np.unique(np.concatenate(tuples), axis=0, return_inverse=True)
    keys = inv.reshape(len(tuples), elem2verts.shape[0]).T.copy()
    return np.asarray(keys, np.int64), uniq.shape[0]


def _encode_rows(rows: np.ndarray, base: int) -> np.ndarray:
    """Injective int64 key of (n, t) sorted vertex tuples."""
    key = rows[:, 0].astype(np.int64)
    for j in range(1, rows.shape[1]):
        key = key * base + rows[:, j]
    return key


def _global_subentities(elem2verts, owners, V_g: int, t: int):
    """Global dim-(t-1) entities as sorted unique keys, owned by the least
    adjacent element owner."""
    parts = [np.sort(elem2verts[:, c], axis=1)
             for c in combinations(range(elem2verts.shape[1]), t)]
    keys = _encode_rows(np.concatenate(parts), V_g)
    uniq_keys, inv = np.unique(keys, return_inverse=True)
    own = np.full(len(uniq_keys), np.iinfo(np.int64).max)
    np.minimum.at(own, inv.reshape(-1), np.tile(owners, len(parts)))
    return uniq_keys, own


def _lookup_gids(local_verts, vgids, uniq_keys, V_g: int) -> np.ndarray:
    keys = _encode_rows(np.sort(vgids[local_verts], axis=1), V_g)
    pos = np.searchsorted(uniq_keys, keys)
    assert (uniq_keys[pos] == keys).all(), "local entity missing globally"
    return pos


def mesh_arrays(dim: int, coords: np.ndarray, elem2verts: np.ndarray,
                class_id: np.ndarray) -> dict:
    """The host arrays ``Mesh2D``/``Mesh3D.from_arrays`` would freeze."""
    if dim == 2:
        a = adj.build_tri_adjacency(coords, elem2verts)
        ev = a["elem2verts"]
        check_f32_ids(ev.shape[0], a["edge2verts"].shape[0])
        geom, v0, inv_basis = walk_geom_table(a["coords"], ev, a["elem2edges"],
                                              a["edge2elems"])
        return dict(coords=a["coords"], elem2verts=ev, elem2edges=a["elem2edges"],
                    edge2verts=a["edge2verts"], edge2elems=a["edge2elems"],
                    side_is_exposed=a["side_is_exposed"], elem_area=a["elem_area"],
                    elem_v0=v0, elem_inv_basis=inv_basis,
                    vert2elem_offsets=a["vert2elem_offsets"],
                    vert2elem_vals=a["vert2elem_vals"], class_id=class_id,
                    walk_geom=geom)
    a = adj.build_tet_adjacency(coords, elem2verts)
    ev = a["elem2verts"]
    check_f32_ids(ev.shape[0], a["face2verts"].shape[0])
    geom, planes, v0, inv_basis = tet_walk_tables(a["coords"], ev, a["elem2faces"],
                                                  a["face2elems"])
    return dict(coords=a["coords"], elem2verts=ev, elem2faces=a["elem2faces"],
                face2verts=a["face2verts"], face2elems=a["face2elems"],
                side_is_exposed=a["side_is_exposed"], elem_volume=a["elem_volume"],
                elem_v0=v0, elem_inv_basis=inv_basis,
                vert2elem_offsets=a["vert2elem_offsets"],
                vert2elem_vals=a["vert2elem_vals"], class_id=class_id,
                walk_geom=geom, walk_planes=planes)


def _pad_stack(arrs, n: int, fill) -> np.ndarray:
    return np.stack([np.concatenate(
        [a, np.full((n - len(a),) + a.shape[1:], fill, a.dtype)]) for a in arrs])


def _exchange_tables(ent_gid: np.ndarray, ent_owner: np.ndarray,
                     n_global: int, R: int):
    """Bucket the copies held off their owner into (R, R, K) send/recv id
    lists, K the largest pair's count (at least 1)."""
    quads = native.exchange_lists(ent_gid, ent_owner, n_global)
    pair_key = quads[:, 0] * R + quads[:, 1]
    order = np.argsort(pair_key, kind="stable")
    quads, pair_key = quads[order], pair_key[order]
    counts = np.bincount(pair_key, minlength=R * R)
    K = max(int(counts.max()), 1)
    starts = np.concatenate([[0], np.cumsum(counts)])
    slot = np.arange(len(quads)) - starts[pair_key]
    send = np.full((R, R, K), -1, np.int64)
    recv = np.full((R, R, K), -1, np.int64)
    send[quads[:, 0], quads[:, 1], slot] = quads[:, 2]
    recv[quads[:, 1], quads[:, 0], slot] = quads[:, 3]
    return send, recv


def build_picparts(coords: np.ndarray, elem2verts: np.ndarray,
                   owners: np.ndarray, num_ranks: int,
                   inp: PicPartsInput = PicPartsInput(),
                   class_id: Optional[np.ndarray] = None,
                   dim: Optional[int] = None) -> PicParts:
    """Picparts of a whole mesh under an element ownership (the
    reference's ``Mesh::Mesh(Input&)``, part_construct.cpp:43-274).
    ``dim`` is the mesh's dimension (from ``elem2verts`` by default)."""
    owners = np.asarray(owners, np.int64)
    elem2verts = np.asarray(elem2verts, np.int64)
    E_g, V_g = elem2verts.shape[0], coords.shape[0]
    dim = elem2verts.shape[1] - 1 if dim is None else dim
    R = num_ranks
    if class_id is None:
        class_id = np.ones(E_g, np.int64)

    vert_owner_g = np.full(V_g, np.iinfo(np.int64).max)
    for k in range(elem2verts.shape[1]):
        np.minimum.at(vert_owner_g, elem2verts[:, k], owners)

    bridge_keys, n_keys = _bridge_keys(elem2verts, V_g, inp.bridge_dim)
    local_elems, local_safe = [], []
    for r in range(R):
        core = owners == r
        if inp.buffer_method == BufferMethod.FULL:
            sel = np.ones(E_g, bool)
            safe = np.ones(E_g, bool)
        elif inp.buffer_method == BufferMethod.NONE:
            sel, safe = core, core.copy()
        else:
            layers = (1 if inp.buffer_method == BufferMethod.MINIMUM
                      else inp.buffer_layers)
            d = native.bfs_layers(bridge_keys, n_keys, core, layers)
            sel = d <= layers
            safe_layers = (0 if inp.buffer_method == BufferMethod.MINIMUM
                           else min(inp.safe_layers, layers - 1))
            safe = d <= safe_layers
        gids = np.nonzero(sel)[0]
        local_elems.append(gids)
        local_safe.append(safe[gids])

    arrays, vgids_l = [], []
    for r in range(R):
        gids = local_elems[r]
        ev_g = elem2verts[gids]
        vgids = np.unique(ev_g.reshape(-1))
        g2l = np.full(V_g, -1, np.int64)
        g2l[vgids] = np.arange(len(vgids))
        arrays.append(mesh_arrays(dim, coords[vgids], g2l[ev_g], class_id[gids]))
        vgids_l.append(vgids)

    E_max = max(len(g) for g in local_elems)
    V_max = max(len(v) for v in vgids_l)
    t = {}
    t["elem_owner"] = _pad_stack([owners[g] for g in local_elems], E_max, -1)
    elem_safe = _pad_stack([s.astype(np.int64) for s in local_safe], E_max, 0).astype(bool)
    t["elem_gid"] = _pad_stack(local_elems, E_max, -1)
    t["vert_owner"] = _pad_stack([vert_owner_g[v] for v in vgids_l], V_max, -1)
    t["vert_gid"] = _pad_stack(vgids_l, V_max, -1)

    BIG = np.iinfo(np.int64).max // 2
    eg_for_sort = np.where(t["elem_gid"] >= 0, t["elem_gid"], BIG)
    perm = np.argsort(eg_for_sort, axis=1, kind="stable")
    t["elem_gid_sorted"] = np.minimum(np.take_along_axis(eg_for_sort, perm, axis=1),
                                      np.iinfo(np.int32).max - 1)
    t["elem_gid_perm"] = perm

    t["vert_send_ids"], t["vert_recv_ids"] = _exchange_tables(
        t["vert_gid"], t["vert_owner"], V_g, R)
    t["elem_send_ids"], t["elem_recv_ids"] = _exchange_tables(
        t["elem_gid"], t["elem_owner"], E_g, R)

    side_field = "edge2verts" if dim == 2 else "face2verts"
    uniq_side, side_own_g = _global_subentities(elem2verts, owners, V_g, dim)
    sg_l = [_lookup_gids(np.asarray(a[side_field]), vgids_l[r], uniq_side, V_g)
            for r, a in enumerate(arrays)]
    Ns_max = max(len(g) for g in sg_l)
    t["side_gid"] = _pad_stack(sg_l, Ns_max, -1)
    t["side_owner"] = _pad_stack([side_own_g[g] for g in sg_l], Ns_max, -1)
    t["side_send_ids"], t["side_recv_ids"] = _exchange_tables(
        t["side_gid"], t["side_owner"], len(uniq_side), R)

    if dim == 3:
        uniq_edge, edge_own_g = _global_subentities(elem2verts, owners, V_g, 2)
        e2v_l, eg3_l = [], []
        for r, a in enumerate(arrays):
            lev = np.asarray(a["elem2verts"])
            pairs = np.concatenate([np.sort(lev[:, c], axis=1)
                                    for c in combinations(range(4), 2)])
            _, first = np.unique(_encode_rows(pairs, len(vgids_l[r])),
                                 return_index=True)
            loc_edges = pairs[np.sort(first)]
            e2v_l.append(loc_edges.astype(np.int64))
            eg3_l.append(_lookup_gids(loc_edges, vgids_l[r], uniq_edge, V_g))
        Ne3 = max(len(g) for g in eg3_l)
        t["edge2verts"] = _pad_stack(e2v_l, Ne3, -1)
        t["edge_gid"] = _pad_stack(eg3_l, Ne3, -1)
        t["edge_owner"] = _pad_stack([edge_own_g[g] for g in eg3_l], Ne3, -1)
        t["edge_send_ids"], t["edge_recv_ids"] = _exchange_tables(
            t["edge_gid"], t["edge_owner"], len(uniq_edge), R)

    tables = {k: np.ascontiguousarray(v.astype(np.int32)) for k, v in t.items()}
    return PicParts(num_ranks=R, dim=dim, tables=tables, elem_safe=elem_safe,
                    mesh_arrays=arrays, nelems=E_max, nverts=V_max,
                    num_core_elems=int(max((owners == r).sum() for r in range(R))))
