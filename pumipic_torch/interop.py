"""Carry the JAX reference's setup across: numpy arrays in, the port's
objects out (and, for particle structures, back).

The parity tests build the reference's mesh, locator (cartesian grid, band
grid or annulus locator), gyro maps, band starts and particle state,
convert them with ``np.asarray``, and hand them to :func:`from_reference`,
so that both packages step from identical inputs; for tet meshes,
:func:`mesh3d_from_numpy`, :func:`locator3d_from_numpy` and
:func:`kuhn_from_numpy` do the same, and :func:`gitr_from_numpy` builds the
port's GITR-style app from the reference's mesh, E grid, state and
``wall_hits``.  This module takes numpy only and imports no JAX.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from pumipic_torch.mesh.core import Mesh2D, Mesh3D
from pumipic_torch.mesh.locator import (
    AnnulusLocator2D,
    BandGrid2D,
    KuhnLocator3D,
    LocatorGrid2D,
    LocatorGrid3D,
)
from pumipic_torch.models.gitr_like import GitrConfig, GitrLike
from pumipic_torch.models.pseudo_xgcm import DPModel, XGCmConfig
from pumipic_torch.ops.push import BandRotation
from pumipic_torch.particles.structure import ParticleStructure
from pumipic_torch.ops.scatter import GyroMap
from pumipic_torch.utils.device import resolve_device

# fields of the reference's Mesh2D / locators that are carried across
MESH_FIELDS = ("coords", "elem2verts", "elem2edges", "edge2verts",
               "edge2elems", "side_is_exposed", "elem_area", "elem_v0",
               "elem_inv_basis", "vert2elem_offsets", "vert2elem_vals",
               "class_id", "walk_geom")
LOCATOR_FIELDS = ("origin", "inv_h", "nx", "ny", "cell_elem", "cell_rows")
MESH3D_FIELDS = ("coords", "elem2verts", "elem2faces", "face2verts",
                 "face2elems", "side_is_exposed", "elem_volume", "elem_v0",
                 "elem_inv_basis", "vert2elem_offsets", "vert2elem_vals",
                 "class_id", "walk_geom", "walk_planes")
LOCATOR3D_FIELDS = ("origin", "inv_h", "nx", "ny", "nz", "cell_elem", "cell_rows")
KUHN_FIELDS = ("origin", "inv_h", "nx", "ny", "nz", "perm")
BAND_FIELDS = ("cx", "cy", "coef_u", "coef_v", "inv_coef", "cell_rows",
               "cell_elem", "n_bands", "n_theta", "n_harm", "n_cheb", "rank",
               "newton_iters")
ANNULUS_FIELDS = ("cx", "cy", "r_in", "dr", "n_rings", "n_sectors",
                  "ring_class", "theta0", "perm")
STATE_FIELDS = ("x0", "x1", "cphi", "sphi", "b", "elem", "active", "rg")
GITR_STATE_FIELDS = ("x", "v", "elem", "active")
# members of a ParticleStructure: arrays (None where the layout has none)
# and static values; "fields" maps each member field to its array
STRUCTURE_ARRAYS = ("elem", "active", "num_ptcls", "elem_offsets",
                    "row_to_elem", "elem_to_row", "overflowed", "seg_cap")
STRUCTURE_STATIC = ("num_elems", "capacity", "layout", "soa_width",
                    "chunk_size", "sigma", "scs_extra_padding",
                    "scs_pad_strategy", "cabm_extra_padding", "name")
_STRUCTURE_DTYPES = {"active": bool, "overflowed": bool}


def _f32(v) -> float:
    return float(np.float32(np.asarray(v)))


def locator_from_numpy(arrays: Dict[str, np.ndarray], device=None
                       ) -> LocatorGrid2D:
    device = resolve_device(device)
    origin = np.asarray(arrays["origin"], np.float32)
    inv_h = np.asarray(arrays["inv_h"], np.float32)
    rows = arrays.get("cell_rows")
    return LocatorGrid2D(
        origin=(float(origin[0]), float(origin[1])),
        inv_h=(float(inv_h[0]), float(inv_h[1])),
        cell_elem=torch.as_tensor(
            np.asarray(arrays["cell_elem"]).astype(np.int32), device=device),
        nx=int(arrays["nx"]), ny=int(arrays["ny"]),
        cell_rows=None if rows is None else torch.as_tensor(
            np.array(rows, np.float32), device=device))


def mesh3d_from_numpy(arrays: Dict[str, np.ndarray], device=None) -> Mesh3D:
    """The reference's ``Mesh3D`` (fields of :data:`MESH3D_FIELDS`)."""
    return Mesh3D.from_numpy({k: arrays[k] for k in MESH3D_FIELDS}, device)


def _f32_triple(v) -> Tuple[float, float, float]:
    a = np.asarray(v, np.float32)
    return (float(a[0]), float(a[1]), float(a[2]))


def locator3d_from_numpy(arrays: Dict[str, np.ndarray], device=None
                         ) -> LocatorGrid3D:
    """The reference's ``LocatorGrid3D`` (fields of
    :data:`LOCATOR3D_FIELDS`; its default 26-column ``cell_rows``)."""
    device = resolve_device(device)
    rows = arrays.get("cell_rows")
    return LocatorGrid3D(
        origin=_f32_triple(arrays["origin"]), inv_h=_f32_triple(arrays["inv_h"]),
        cell_elem=torch.as_tensor(
            np.asarray(arrays["cell_elem"]).astype(np.int32), device=device),
        nx=int(arrays["nx"]), ny=int(arrays["ny"]), nz=int(arrays["nz"]),
        cell_rows=None if rows is None else torch.as_tensor(
            np.array(rows, np.float32), device=device))


def kuhn_from_numpy(arrays: Dict[str, np.ndarray], device=None) -> KuhnLocator3D:
    """The reference's ``KuhnLocator3D`` (fields of :data:`KUHN_FIELDS`;
    ``perm`` None for the generator's order)."""
    device = resolve_device(device)
    perm = arrays.get("perm")
    return KuhnLocator3D(
        origin=_f32_triple(arrays["origin"]), inv_h=_f32_triple(arrays["inv_h"]),
        nx=int(arrays["nx"]), ny=int(arrays["ny"]), nz=int(arrays["nz"]),
        perm=None if perm is None else torch.as_tensor(
            np.asarray(perm).astype(np.int32), device=device))


def band_grid_from_numpy(arrays: Dict[str, np.ndarray], device=None
                         ) -> BandGrid2D:
    """The reference's ``BandGrid2D`` (fields of :data:`BAND_FIELDS`)."""
    device = resolve_device(device)
    def f32(k):
        return torch.as_tensor(np.array(arrays[k], np.float32), device=device)

    return BandGrid2D(
        cx=_f32(arrays["cx"]), cy=_f32(arrays["cy"]),
        coef_u=f32("coef_u"), coef_v=f32("coef_v"), inv_coef=f32("inv_coef"),
        cell_rows=f32("cell_rows"),
        cell_elem=torch.as_tensor(
            np.asarray(arrays["cell_elem"]).astype(np.int32), device=device),
        **{k: int(arrays[k]) for k in ("n_bands", "n_theta", "n_harm",
                                       "n_cheb", "rank", "newton_iters")})


def annulus_from_numpy(arrays: Dict[str, np.ndarray], device=None
                       ) -> AnnulusLocator2D:
    """The reference's ``AnnulusLocator2D`` (fields of
    :data:`ANNULUS_FIELDS`; ``perm`` None for the generator's order)."""
    device = resolve_device(device)
    perm = arrays.get("perm")
    return AnnulusLocator2D(
        cx=_f32(arrays["cx"]), cy=_f32(arrays["cy"]),
        r_in=_f32(arrays["r_in"]), dr=_f32(arrays["dr"]),
        n_rings=int(arrays["n_rings"]), n_sectors=int(arrays["n_sectors"]),
        ring_class=bool(arrays["ring_class"]), theta0=_f32(arrays["theta0"]),
        perm=None if perm is None else torch.as_tensor(
            np.asarray(perm).astype(np.int32), device=device))


def state_from_numpy(arrays: Dict[str, np.ndarray], device=None
                     ) -> Dict[str, torch.Tensor]:
    device = resolve_device(device)
    out = {}
    for k in STATE_FIELDS:
        if k not in arrays:
            continue                      # rg: only with a per-particle radius
        a = np.asarray(arrays[k])
        dt = {"elem": np.int32, "active": bool}.get(k, np.float32)
        out[k] = torch.as_tensor(a.astype(dt), device=device)
    return out


def from_reference(mesh: Dict[str, np.ndarray],
                   locator: Optional[Dict[str, np.ndarray]],
                   gyro_fwd: np.ndarray, gyro_bwd: Optional[np.ndarray],
                   band_starts: Tuple[int, ...],
                   state: Dict[str, np.ndarray],
                   cfg: XGCmConfig, device=None,
                   band_grid: Optional[Dict[str, np.ndarray]] = None,
                   annulus: Optional[Dict[str, np.ndarray]] = None,
                   ) -> Tuple[DPModel, Dict[str, torch.Tensor]]:
    """The port's (model, state) for the reference's setup.  ``gyro_bwd``
    None (or the same array as ``gyro_fwd``) shares one map for both
    directions, as the reference does when its projections coincide.  The
    search's accelerator is the cartesian ``locator``, the flux-band
    ``band_grid`` or the ``annulus`` locator, whichever is given (at most
    one)."""
    if sum(x is not None for x in (locator, band_grid, annulus)) > 1:
        raise ValueError("give at most one of locator, band_grid, annulus")
    device = resolve_device(device)
    m = Mesh2D.from_numpy({k: mesh[k] for k in MESH_FIELDS}, device)
    R, P = cfg.gyro.num_rings, cfg.gyro.points_per_ring
    fwd = GyroMap.from_flat(np.asarray(gyro_fwd), m.nverts, R, P, device)
    bwd = fwd if gyro_bwd is None or gyro_bwd is gyro_fwd else \
        GyroMap.from_flat(np.asarray(gyro_bwd), m.nverts, R, P, device)
    if band_grid is not None:
        grid = band_grid_from_numpy(band_grid, device)
    elif locator is not None:
        grid = locator_from_numpy(locator, device)
    else:
        grid = None
    analytic = None if annulus is None else annulus_from_numpy(annulus, device)
    rot = BandRotation.build(tuple(int(s) for s in band_starts),
                             cfg.deg_per_push, device)
    return (DPModel(m, grid, rot, fwd, bwd, analytic),
            state_from_numpy(state, device))


def structure_from_numpy(members: Dict[str, object], device=None
                         ) -> ParticleStructure:
    """The port's ``ParticleStructure`` from a structure's members: the
    :data:`STRUCTURE_ARRAYS` as arrays (or None), the
    :data:`STRUCTURE_STATIC` values, and ``fields`` ({name: array}, dtypes
    kept).  Integer members become int32, the mask and flag bool."""
    device = resolve_device(device)

    def arr(k):
        v = members[k]
        if v is None:
            return None
        a = np.asarray(v).astype(_STRUCTURE_DTYPES.get(k, np.int32))
        return torch.as_tensor(a, device=device)

    fields = {k: torch.as_tensor(np.array(v), device=device)
              for k, v in members["fields"].items()}
    return ParticleStructure(
        fields=fields, **{k: arr(k) for k in STRUCTURE_ARRAYS},
        **{k: members[k] for k in STRUCTURE_STATIC})


def structure_to_numpy(ps: ParticleStructure) -> Dict[str, object]:
    """The members of ``ps`` in :func:`structure_from_numpy`'s format, as
    numpy arrays."""
    out = {k: (None if getattr(ps, k) is None else getattr(ps, k).cpu().numpy())
           for k in STRUCTURE_ARRAYS}
    out.update({k: getattr(ps, k) for k in STRUCTURE_STATIC})
    out["fields"] = {k: v.cpu().numpy() for k, v in ps.fields.items()}
    return out


def gitr_state_from_numpy(arrays: Dict[str, np.ndarray], device=None
                          ) -> Dict[str, torch.Tensor]:
    """The GITR-style app's state (fields of :data:`GITR_STATE_FIELDS`): f32
    ``x`` and ``v``, i32 ``elem``, bool ``active``."""
    device = resolve_device(device)
    dt = {"x": np.float32, "v": np.float32, "elem": np.int32, "active": bool}
    return {k: torch.as_tensor(np.asarray(arrays[k]).astype(dt[k]), device=device)
            for k in GITR_STATE_FIELDS}


def gitr_from_numpy(mesh: Dict[str, np.ndarray], cfg: GitrConfig, e_grid, e_origin,
                    e_spacing, state: Dict[str, np.ndarray], wall_hits,
                    device=None) -> GitrLike:
    """The port's ``GitrLike`` for the reference's: its mesh (fields of
    :data:`MESH3D_FIELDS`), E grid with origin and cell spacing, state and
    ``wall_hits``, all as numpy arrays."""
    device = resolve_device(device)
    app = GitrLike(mesh3d_from_numpy(mesh, device), cfg, e_grid=np.asarray(e_grid),
                   e_origin=np.asarray(e_origin), e_spacing=np.asarray(e_spacing),
                   device=device)
    app.state = gitr_state_from_numpy(state, device)
    app.wall_hits = torch.as_tensor(np.asarray(wall_hits, np.float32), device=device)
    return app
