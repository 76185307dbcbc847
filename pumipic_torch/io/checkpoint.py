"""Checkpoint / resume of picparts and particle state (port of
``pumipic_tpu.io.checkpoint``).

Reference parity: ``pumipic::write/read`` (``src/pumipic_file.cpp:46-207``)
persists picparts; particle state is not checkpointed by the reference
(apps own it), the JAX package checkpoints it too.  The files are the JAX
package's format, one compressed ``.npz`` per artifact: the state arrays
as ``f.<name>`` and a JSON sidecar ``__meta__`` (format version, step,
field names) as uint8, so that a file written by either package is read by
the other.  A particle structure adds its layout and padding settings as
the ``__layout__`` entry and is rebuilt in that layout on read.  Picparts
go to ``<prefix>_<R>.ppm.npz`` (the reference's ``.ppm`` name) as the JAX
package stacks them: its (R, ...) tables as ``pp.<name>``, every rank's
mesh padded to the largest as ``mesh.<field>`` (padded walk rows inert, as
its ``_pad_stack_meshes`` pads them) and the sizes in ``__meta__``.
"""
from __future__ import annotations

import json
from typing import Dict, List, Tuple

import numpy as np
import torch

FORMAT_VERSION = 1


def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _json_bytes(obj) -> np.ndarray:
    return np.frombuffer(json.dumps(obj).encode(), dtype=np.uint8)


# ---------------------------------------------------------------------------
# picparts
# ---------------------------------------------------------------------------

# each mesh field's row count ("elem", "vert", "side", "v2e" or "offsets")
# and pad value, as the JAX package's _pad_stack_meshes pads them
_MESH_PAD = {
    "coords": ("vert", 0), "elem2verts": ("elem", 0), "side_is_exposed": ("side", True),
    "elem_v0": ("elem", 0), "elem_inv_basis": ("elem", 0),
    "vert2elem_offsets": ("offsets", None), "vert2elem_vals": ("v2e", 0),
    "class_id": ("elem", -1), "walk_geom": ("elem", None),
    "elem2edges": ("elem", 0), "edge2verts": ("side", 0), "edge2elems": ("side", -1),
    "elem_area": ("elem", 0), "elem2faces": ("elem", 0), "face2verts": ("side", 0),
    "face2elems": ("side", -1), "elem_volume": ("elem", 0), "walk_planes": ("elem", None),
}
# inert padded walk rows: never "inside", every neighbour -1
_WALK_PAD = {("walk_geom", 2): [0, 0, -1, 0, 0, -1] + [-1] * 6,
             ("walk_geom", 3): [0, 0, 0, -1] * 3 + [-1] * 4,
             ("walk_planes", 3): [1, 0, 0, -1e30, -1, 0, 0, -1e30,
                                  0, 0, 0, -1e30, 0, 0, 0, -1e30] + [-1] * 4}


def _rank_sizes(tables: Dict[str, np.ndarray], r: int, offsets=None) -> Dict[str, int]:
    n = {k: int((tables[f"{k}_gid"][r] >= 0).sum()) for k in ("elem", "vert", "side")}
    n["offsets"] = n["vert"] + 1
    if offsets is not None:
        n["v2e"] = int(offsets[r][n["vert"]])
    return n


def write_picparts(prefix: str, pp) -> str:
    """Persist a :class:`~pumipic_torch.parallel.picparts.PicParts` to
    ``<prefix>_<R>.ppm.npz`` in the JAX package's layout (it reads the file
    with its ``read_picparts``); returns the path."""
    from pumipic_torch.mesh.core import Mesh2D, Mesh3D

    R = pp.num_ranks
    path = f"{prefix}_{R}.ppm.npz"
    cls = Mesh2D if pp.dim == 2 else Mesh3D
    meshes = [cls.from_numpy(a, "cpu") for a in pp.mesh_arrays]
    arrays = {f"pp.{k}": v for k, v in pp.tables.items()}
    arrays["pp.elem_safe"] = np.asarray(pp.elem_safe, bool)
    E = max(int(m.nelems) for m in meshes)
    V = max(int(m.nverts) for m in meshes)
    S = max(int(m.nedges if pp.dim == 2 else m.nfaces) for m in meshes)
    rows = {"elem": E, "vert": V, "side": S, "offsets": V + 1,
            "v2e": max(int(m.vert2elem_vals.shape[0]) for m in meshes)}
    for name, (kind, fill) in _MESH_PAD.items():
        if not hasattr(meshes[0], name):
            continue
        stack = []
        for m in meshes:
            a = getattr(m, name).numpy()
            if fill is None and kind == "offsets":
                pad = np.full((rows[kind] - a.shape[0],), a[-1], a.dtype)
            elif fill is None:
                row = np.asarray(_WALK_PAD[name, pp.dim], a.dtype)
                pad = np.broadcast_to(row, (rows[kind] - a.shape[0], row.shape[0]))
            else:
                pad = np.full((rows[kind] - a.shape[0],) + a.shape[1:], fill, a.dtype)
            stack.append(np.concatenate([a, pad]))
        arrays[f"mesh.{name}"] = np.stack(stack)
    meta = {"version": FORMAT_VERSION, "num_ranks": R, "num_core_elems": pp.num_core_elems,
            "dim": pp.dim, "nelems": E, "nverts": V, "nsides": S}
    arrays["__meta__"] = _json_bytes(meta)
    np.savez_compressed(path, **arrays)
    return path


def read_picparts(path: str):
    """The :class:`~pumipic_torch.parallel.picparts.PicParts` of a file
    ``write_picparts`` (of either package) wrote: its tables, ``elem_safe``
    and each rank's mesh arrays, the padding cut off."""
    from pumipic_torch.parallel.picparts import PicParts

    data = np.load(path)
    meta = json.loads(bytes(data["__meta__"]).decode())
    if meta["version"] > FORMAT_VERSION:
        raise ValueError(f"checkpoint version {meta['version']} newer than "
                         f"supported {FORMAT_VERSION}")
    tables = {k[3:]: np.ascontiguousarray(data[k], np.int32) for k in data.files
              if k.startswith("pp.") and k != "pp.elem_safe"}
    mesh = {k[5:]: data[k] for k in data.files if k.startswith("mesh.")}
    R = meta["num_ranks"]
    mesh_arrays: List[dict] = []
    for r in range(R):
        n = _rank_sizes(tables, r, mesh["vert2elem_offsets"])
        mesh_arrays.append({name: np.ascontiguousarray(a[r][:n[_MESH_PAD[name][0]]])
                            for name, a in mesh.items()})
    return PicParts(num_ranks=R, dim=meta["dim"], tables=tables,
                    elem_safe=np.asarray(data["pp.elem_safe"], bool),
                    mesh_arrays=mesh_arrays, nelems=meta["nelems"], nverts=meta["nverts"],
                    num_core_elems=meta["num_core_elems"])


# ---------------------------------------------------------------------------
# particle state
# ---------------------------------------------------------------------------

def write_particles(path: str, state: Dict[str, object], step: int = 0) -> str:
    """Persist a flat particle-state dict (tensors or arrays; a particle
    structure's ``copy_to_host()``) to ``path`` (``.npz`` appended where
    missing); returns the path written."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    meta = {"version": FORMAT_VERSION, "step": step, "fields": sorted(state.keys())}
    arrays = {f"f.{k}": _host(v) for k, v in state.items()}
    arrays["__meta__"] = _json_bytes(meta)
    np.savez_compressed(path, **arrays)
    return path


def read_particles(path: str) -> Tuple[Dict[str, np.ndarray], int]:
    """(state as host arrays, step) of a file :func:`write_particles` (of
    either package) wrote."""
    data = np.load(path)
    meta = json.loads(bytes(data["__meta__"]).decode())
    if meta["version"] > FORMAT_VERSION:
        raise ValueError(f"checkpoint version {meta['version']} newer than "
                         f"supported {FORMAT_VERSION}")
    state = {k[2:]: data[k] for k in data.files if k.startswith("f.")}
    return state, meta["step"]


def write_particle_structure(path: str, ps, step: int = 0) -> str:
    """Checkpoint a :class:`~pumipic_torch.particles.ParticleStructure`:
    its slots (fields, ``elem``, ``active``) and its layout, rebuilt on
    read."""
    host = ps.copy_to_host()
    host["__layout__"] = _json_bytes({
        "layout": ps.layout, "num_elems": ps.num_elems,
        "capacity": ps.capacity, "soa_width": ps.soa_width,
        "chunk_size": ps.chunk_size, "sigma": min(ps.sigma, 2**30),
        "extra_padding": ps.scs_extra_padding,
        "pad_strategy": ps.scs_pad_strategy,
        "cabm_extra_padding": ps.cabm_extra_padding,
        "name": ps.name,
    })
    return write_particles(path, host, step)


def read_particle_structure(path: str, device=None):
    """(structure, step) of a file :func:`write_particle_structure` (of
    either package) wrote: the active slots' particles placed into a new
    structure of the stored layout, capacity and padding settings on
    ``device``."""
    from pumipic_torch.particles.structure import CSR, DPS, CabM, SCSInput, SellCSigma

    state, step = read_particles(path)
    cfg = json.loads(bytes(state.pop("__layout__")).decode())
    active = state.pop("active")
    elem = np.where(active, state.pop("elem"), -1)
    fields = {k: torch.from_numpy(np.array(v)) for k, v in state.items()}
    common = dict(fields=fields, capacity=cfg["capacity"], name=cfg["name"],
                  device=device)
    if cfg["layout"] == "scs":
        ps = SellCSigma(
            cfg["num_elems"], elem,
            scs_input=SCSInput(
                chunk_size=cfg["chunk_size"], sigma=cfg["sigma"],
                extra_padding=cfg.get("extra_padding", 0.0),
                pad_strategy=cfg.get("pad_strategy", "proportionally")),
            **common)
    elif cfg["layout"] == "cabm":
        ps = CabM(cfg["num_elems"], elem, soa_width=cfg["soa_width"],
                  extra_padding=cfg.get("cabm_extra_padding", 0.0), **common)
    else:
        builder = {"csr": CSR, "dps": DPS}[cfg["layout"]]
        ps = builder(cfg["num_elems"], elem, **common)
    return ps, step
